"""The CTC phoneme probe: CLI, features and labels, model, train loop and test pass.

Port of ``experiments/experiment_asr_ctc.py``: its flags with the JAX names and defaults (so the
run specs of ``experiments/phoneme.txt`` parse), its feature transform by ``--data_type``
(``spectrogram``: the log-mel spectrogram at ``--hop_length``, ``(T, n_mels)``; ``waveform``:
``StackTensor(hop_length)``, ``(T, hop)``; else a representation array the caller hands over,
``(T, D)``), its text transform (``clean_timit``, the ``h#`` marks removed, then integers of the
TIMIT phone set or alphabet, blank at 0), its padding (features to a multiple of 64 frames,
labels to a multiple of 16, rows to a multiple of ``--accum_steps``), its train loop (the epoch
learning rate, the clips, ``--accum_steps`` microbatches weighted by their label counts, the step's
loss, WER and CER read ``--metric_fetch_lag`` steps late) and its test pass (the forward without
dropout, the greedy decode, WER and CER of a source). Dataset loading and checkpoints come later: the
caller hands over waveforms (or representations) and transcripts. ``--scan_unroll`` only schedules
XLA and is accepted and ignored. Entry points run on the card unless given ``device="cpu"``.

    args = build_args(argv)
    token_map = build_token_map(args)
    examples = [encode_example(waveform, transcript, args, token_map) for waveform, transcript in data]
    model = build_model(args, input_size=examples[0][0].shape[-1], token_map=token_map)
    state = train(model, args, [[examples[i] for i in batch] for batch in batches], Tracker())
    result = evaluate(model, args, [test_examples], Tracker(), source="test")  # wer, cer, loss, hyps, refs
"""

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blvm_tpu_torch.data.batchers import DynamicTensorBatcher, TextBatcher
from blvm_tpu_torch.data.buckets import BucketSpec
from blvm_tpu_torch.data.text_cleaners import clean_timit
from blvm_tpu_torch.data.token_map import TokenMap
from blvm_tpu_torch.data.tokenizers import char_tokenizer, word_tokenizer
from blvm_tpu_torch.data.tokens import TIMIT_ALPHABET, TIMIT_PHONESET
from blvm_tpu_torch.data.transforms import (Compose, EncodeInteger, LogMelSpectrogram, StackTensor, TextCleaner,
                                            Transform)
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common
from blvm_tpu_torch.experiments.common import STEP_SPAN, DeferredMetrics, resolve_device, str2bool, upload
from blvm_tpu_torch.models.lstm_asr import SimpleLSTMASR
from blvm_tpu_torch.training.eval_step import make_eval_step
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step

FEATURE_BUCKET, LABEL_BUCKET = BucketSpec(mode="multiple", multiple=64), BucketSpec(mode="multiple", multiple=16)

Example = Tuple[np.ndarray, List[int]]  # (features (T, D) float32, label indices)


class TransposeTD(Transform):
    """(D, T) -> (T, D) feature layout for the LSTM."""

    def forward(self, x):
        return np.ascontiguousarray(np.asarray(x).T)


def build_parser() -> argparse.ArgumentParser:
    # the probe's defaults (experiment_asr_ctc.py:56-74): --batch_len in seconds, the epoch MultiStepLR, the clips
    parser = common.build_parser(__doc__.split("\n")[0], batch_len=120)
    parser.set_defaults(epochs=40, lr_scheduler="MultiStepLR",
                        lr_scheduler_kwargs=dict(milestones=[100, 200, 300], gamma=0.5), max_grad_norm=3000.0,
                        max_grad_value=1000.0)
    setup_group = parser.add_argument_group("probe setup")
    setup_group.add_argument("--dataset", default="timit", type=str)
    setup_group.add_argument("--num_workers", default=4, type=int)
    setup_group.add_argument("--save_checkpoints", default=False, type=str2bool)
    setup_group.add_argument("--num_seeds", default=1, type=int)
    model_group = parser.add_argument_group("model")
    model_group.add_argument("--train_source", default=None, type=str)
    model_group.add_argument("--data_type", default="spectrogram", type=str)
    model_group.add_argument("--text_type", default="phon", choices=["word", "char", "phon"])
    model_group.add_argument("--sample_rate", default=16000, type=int)
    model_group.add_argument("--n_fft", default=512, type=int)
    model_group.add_argument("--win_length", default=128, type=int)
    model_group.add_argument("--hop_length", default=64, type=int)
    model_group.add_argument("--n_mels", default=80, type=int)
    model_group.add_argument("--hidden_size", default=128, type=int)
    model_group.add_argument("--scan_unroll", default=1, type=int, help="accepted; only schedules XLA")
    model_group.add_argument("--num_layers", default=1, type=int)
    model_group.add_argument("--bidirectional", default=False, type=str2bool)
    model_group.add_argument("--sum_directions", default=False, type=str2bool)
    model_group.add_argument("--dropout_prob", default=0.30, type=float)
    model_group.add_argument("--temporal_dropout", default=True, type=str2bool)
    model_group.add_argument("--num_batches_per_epoch", default=1000, type=int)
    model_group.add_argument("--extra_test_sources", default=[], type=str, nargs="*")
    return parser


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    args = common.parse_args(build_parser(), argv)
    if args.num_seeds > 1:
        raise NotImplementedError("--num_seeds > 1 (replicas in one program) is not ported yet: ROADMAP.md Queue 1 "
                                  "item 7 (parallelism)")
    if args.save_checkpoints:
        raise NotImplementedError("--save_checkpoints is not ported yet: ROADMAP.md Queue 1 item 4 (checkpoints)")
    return args


def build_token_map(args: argparse.Namespace) -> TokenMap:
    """The TIMIT phone set under ``--text_type phon``, else the TIMIT alphabet; blank at 0."""
    alphabet = TIMIT_PHONESET if args.text_type == "phon" else TIMIT_ALPHABET
    return TokenMap(tokens=list(alphabet), add_blank=True)


def build_transforms(args: argparse.Namespace, token_map: TokenMap) -> Tuple[Optional[Transform], Transform]:
    """``(feature transform, text transform)`` as ``experiment_asr_ctc.py:build_modalities`` builds them;
    the feature transform is None for a representation array, which is already ``(T, D)``."""
    tokenizer = char_tokenizer if args.text_type == "char" else word_tokenizer
    text = Compose(TextCleaner(clean_timit, lambda s: s.replace("h#", "").strip()),
                   EncodeInteger(token_map=token_map, tokenizer=tokenizer))
    if args.data_type == "spectrogram":
        features = Compose(LogMelSpectrogram(sample_rate=args.sample_rate, n_fft=args.n_fft, win_length=args.win_length,
                                             hop_length=args.hop_length, n_mels=args.n_mels, normalize_frq_bins=True),
                           TransposeTD())
    elif args.data_type == "waveform":
        features = StackTensor(args.hop_length)  # (T', hop) already time-major
    else:
        features = None  # dumped representations (e.g. "wavenet-z0-n1.npy") are already (T, D)
    return features, text


def encode_example(data: np.ndarray, transcript: str, args: argparse.Namespace, token_map: TokenMap,
                   transforms=None) -> Example:
    """One example as the probe's loaders give it: the features of ``data`` (a waveform in [-1, 1], or a
    ``(T, D)`` representation under an ``.npy`` ``--data_type``) as float32 ``(T, D)``, and the label
    indices of ``transcript`` (TIMIT's ``.PHN``/``.TXT`` text). ``transforms`` from :func:`build_transforms`
    saves rebuilding them."""
    features, text = transforms or build_transforms(args, token_map)
    x = np.asarray(data, np.float32) if features is None else features(np.asarray(data, np.float32))
    return np.asarray(x, np.float32), text(transcript)


def make_batch(examples: Sequence[Example], args: argparse.Namespace) -> Dict[str, np.ndarray]:
    """Pad a batch as the JAX driver's batchers and ``make_batch`` do: features to a multiple of 64 frames,
    labels to a multiple of 16, and the rows, with zero-length rows, to a multiple of ``--accum_steps``.
    Returns numpy ``x (B, T, D)`` float32, ``x_sl``, ``y (B, N)`` and ``y_sl`` (int64)."""
    x, x_sl = DynamicTensorBatcher(axis=0, bucket=FEATURE_BUCKET)([f for f, _ in examples])
    y, y_sl = TextBatcher(bucket=LABEL_BUCKET)([labels for _, labels in examples])
    rows = (-len(examples)) % max(1, int(args.accum_steps or 1))
    pad = lambda a: np.concatenate([a, np.zeros((rows,) + a.shape[1:], a.dtype)]) if rows else a  # noqa: E731
    return dict(x=pad(np.asarray(x, np.float32)), x_sl=pad(x_sl), y=pad(y), y_sl=pad(y_sl))


def build_model(args: argparse.Namespace, input_size: int, token_map: Optional[TokenMap] = None,
                device=None) -> SimpleLSTMASR:
    """The SimpleLSTMASR the JAX driver builds from the same flags over ``input_size`` features, on
    ``device`` (default: the card; raises where there is none)."""
    device = resolve_device(device)
    return SimpleLSTMASR.from_token_map(
        token_map or build_token_map(args),
        input_size=input_size,
        hidden_size=args.hidden_size,
        num_layers=args.num_layers,
        bidirectional=args.bidirectional,
        sum_directions=args.sum_directions,
        temporal_dropout=args.temporal_dropout,
        dropout_prob=args.dropout_prob,
        unroll=args.scan_unroll,
        device=device,
    )


def upload_batch(batch: Dict[str, np.ndarray], device: torch.device) -> Tuple[dict, tuple]:
    """``(batch on device, pinned buffers)``: the four arrays uploaded without a wait
    (:func:`common.upload`), and the host's label counts beside them (``y_sl_host``), from which
    accumulation takes its weights."""
    on_device, buffers = {}, []
    for key in ("x", "x_sl", "y", "y_sl"):
        on_device[key], buf = upload(batch[key], device)
        buffers.append(buf)
    on_device["y_sl_host"] = torch.from_numpy(batch["y_sl"])
    return on_device, tuple(buffers)


def loss_fn(model, generator, batch, scalars):
    """The probe's loss function: one forward on the batch, dropout drawn from ``generator`` in
    training: ``(loss, (mets, outputs))``."""
    loss, mets, outputs = model(batch["x"], batch["x_sl"], batch["y"], batch["y_sl"], generator=generator)
    return loss, (mets, outputs)


def train(model: SimpleLSTMASR, args: argparse.Namespace, batches_per_epoch: Sequence[Sequence[Example]],
          tracker: Tracker, device=None) -> TrainState:
    """The training loop: ``--epochs`` passes over ``batches_per_epoch`` (each a list of
    :func:`encode_example` examples), one train step a batch, each step's loss, WER and CER merged into
    ``tracker`` under the ``train`` source.

    The learning rate is set once an epoch (the torch-named schedulers are epoch-denominated), the
    value and norm clips and Adam follow the flags, and ``--accum_steps`` microbatches are weighted by
    their label counts, taken from the host's copy (the loss is the total nats over the total labels).
    Each batch goes up from pinned memory without a wait; the step's metrics reach the tracker
    ``--metric_fetch_lag`` steps late (:class:`common.DeferredMetrics`, flushed at the end of every
    epoch); each step is a :data:`common.STEP_SPAN` profiler span. Runs on ``device`` (default: the
    card), where the model must already lie. Returns the final :class:`TrainState`."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, training was asked on {device}")
    tx, epoch_lr = common.build_tx_and_lr(args)
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=device).manual_seed(args.seed))
    accum = int(args.accum_steps or 1)
    train_step = make_train_step(loss_fn, accum=accum,
                                 loss_weight=(lambda mb, mets: mb["y_sl_host"].sum()) if accum > 1 else None)
    deferred = DeferredMetrics(lambda m: tracker.update(model.build_metrics(m)[0], source="train"),
                               args.metric_fetch_lag)
    model.train()
    for epoch in range(1, args.epochs + 1):
        if epoch_lr is not None:
            state.optimizer.learning_rate = epoch_lr.lr_at_epoch(epoch)
        for examples in batches_per_epoch:
            with torch.profiler.record_function(STEP_SPAN):
                batch, buffers = upload_batch(make_batch(examples, args), device)
                state, mets = train_step(state, batch, {})
                deferred.push(mets, keep=buffers)
        deferred.flush()
    return state


def evaluate(model: SimpleLSTMASR, args: argparse.Namespace, batches: Sequence[Sequence[Example]], tracker: Tracker,
             source: str = "test", generator: Optional[torch.Generator] = None) -> dict:
    """The test pass of one source: each batch (a list of :func:`encode_example` examples) one forward
    without dropout, its metrics read ``--metric_fetch_lag`` batches late, the greedy decode and WER and
    CER on the host. Returns the source's values (``loss``, ``wer``, ``cer``) with ``hyps`` and ``refs``,
    the decoded and the reference texts of every utterance with labels, in batch order."""
    model.eval()
    eval_step = make_eval_step(loss_fn)
    device = next(model.parameters()).device
    texts = dict(hyps=[], refs=[])

    def consume(mets):
        metrics, hyps, refs = model.build_metrics(mets)
        tracker.update(metrics, source=source)
        texts["hyps"] += hyps
        texts["refs"] += refs

    deferred = DeferredMetrics(consume, args.metric_fetch_lag)
    for examples in batches:
        with torch.profiler.record_function(STEP_SPAN):
            batch, buffers = upload_batch(make_batch(examples, args), device)
            mets, _ = eval_step(model, generator, batch, {})
            deferred.push(mets, keep=buffers)
    deferred.flush()
    return dict(tracker.values[source], **texts)
