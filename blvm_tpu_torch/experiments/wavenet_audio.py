"""WaveNet on audio: CLI, model construction and the rf-chunked test pass.

Port of ``experiments/experiment_wavenet_audio.py`` (``build_args`` and the
model construction) and of ``experiments/common.py:make_rf_chunked_eval``. This
slice is the evaluation half: it scores mu-law-encoded waveforms in
receptive-field-overlapping chunks and reports loss, log-likelihood and
bits/frame per source. Training and dataset loading come later.

The model-group flags keep the JAX driver's names and defaults, so the run
specs of ``experiments/benchmarks.txt`` parse; flags this port does not use yet
(``--dataset``, ``--epochs``, ...) are ignored with a warning.

    args = build_args(argv)
    model = build_model(args, device="cuda")
    values = evaluate(model, args, [make_batch(waveforms, args)], Tracker())
"""

import argparse
import time
import warnings
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blvm_tpu_torch.data.transforms import MuLawEncode
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.models.wavenet import WaveNet
from blvm_tpu_torch.training.eval_step import make_eval_step


def str2bool(arg) -> bool:
    if isinstance(arg, bool):
        return arg
    if arg.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if arg.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Could not parse argument {arg} of type {type(arg)} as bool.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    setup_group = parser.add_argument_group("setup")
    setup_group.add_argument("--seed", type=int, default=int(time.time_ns() % (2**31)))
    setup_group.add_argument("--bf16", type=str2bool, default=False, help="bfloat16 residual stack (likelihoods stay f32)")
    model_group = parser.add_argument_group("model")
    model_group.add_argument("--n_layers", default=10, type=int, help="layers per stack")
    model_group.add_argument("--n_stacks", default=4, type=int)
    model_group.add_argument("--res_channels", default=64, type=int)
    model_group.add_argument("--kernel_size", default=2, type=int)
    model_group.add_argument("--base_dilation", default=2, type=int)
    model_group.add_argument("--input_coding", default="mu_law", type=str, choices=["mu_law", "linear"])
    model_group.add_argument("--input_embedding_dim", default=1, type=int)
    model_group.add_argument("--num_bits", default=16, type=int)
    model_group.add_argument("--num_mix", default=10, type=int)
    model_group.add_argument("--likelihood", default="DMoL", type=str)
    model_group.add_argument("--random_segment_size", default=None, type=int)
    model_group.add_argument("--n_stack_frames", default=1, type=int)
    model_group.add_argument("--split_eval", default=False, type=str2bool)
    model_group.add_argument("--generate_every", default=25, type=int)
    return parser


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        warnings.warn(f"ignoring flags blvm_tpu_torch does not use yet: {unknown}", stacklevel=2)
    return args


def build_model(args: argparse.Namespace, device=None) -> WaveNet:
    """The WaveNet the JAX driver builds from the same flags."""
    return WaveNet(
        likelihood=args.likelihood,
        embedding_dim=None if args.input_embedding_dim == 1 else args.input_embedding_dim,
        num_bins=2**args.num_bits,
        num_mix=args.num_mix,
        n_layers=args.n_layers,
        n_stacks=args.n_stacks,
        res_channels=args.res_channels,
        kernel_size=args.kernel_size,
        base_dilation=args.base_dilation,
        n_stack_frames=args.n_stack_frames,
        bf16=args.bf16,
        device=device,
    )


def make_batch(waveforms: List[np.ndarray], args: argparse.Namespace) -> Tuple[np.ndarray, np.ndarray]:
    """Encode waveforms in [-1, 1] as the driver's eval pipeline does (mu-law with
    ``--num_bits`` under ``--input_coding mu_law``) and right-pad them into one
    ``(x (B, T) float32, x_sl (B,) int32)`` batch."""
    encode = MuLawEncode(bits=args.num_bits) if args.input_coding == "mu_law" else None
    x_sl = np.asarray([len(w) for w in waveforms], np.int32)
    x = np.zeros((len(waveforms), int(x_sl.max())), np.float32)
    for i, w in enumerate(waveforms):
        x[i, : len(w)] = encode(w) if encode is not None else w
    return x, x_sl


def loss_fn(model, generator, batch, scalars):
    """The driver's loss function: one forward, ``(loss, (mets, outputs))``."""
    loss, mets, outputs = model(batch["x"], batch["x_sl"], generator=generator, **batch.get("kwargs", {}))
    return loss, (mets, outputs)


def _to_host(mets: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in mets.items()}


def make_rf_chunked_eval(model: WaveNet, args: argparse.Namespace):
    """Chunked evaluation with receptive-field-overlapping chunks: the first chunk
    is rf-padded, later chunks carry their overlap as context; no carried state.
    Returns ``state_carry_eval(eval_step, model, generator, x, x_sl, scalars,
    tracker, source)``, which updates ``tracker`` once per chunk and returns the
    last chunk's outputs."""

    def state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker, source):
        chunks, lens = model.split_sequence(x, x_sl, length=args.random_segment_size or 16000)
        device = next(model.parameters()).device
        out = None
        for i, (xs, sl) in enumerate(zip(chunks, lens)):
            batch = dict(
                x=torch.from_numpy(np.ascontiguousarray(xs)).to(device),
                x_sl=torch.from_numpy(np.asarray(sl, np.int32)).to(device),
                kwargs=dict(pad_receptive_field=(i == 0)),
            )
            mets, out = eval_step(model, generator, batch, scalars)
            tracker.update(model.build_metrics(_to_host(mets)), source=source)
        return out

    return state_carry_eval


def evaluate(
    model: WaveNet,
    args: argparse.Namespace,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    tracker: Tracker,
    source: str = "test",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """The test pass: score every ``(x, x_sl)`` batch (already encoded, as
    :func:`make_batch` returns) and return the source's summary (loss, ll, bpd).

    With ``--split_eval`` each batch is scored in rf-overlapping chunks of
    ``--random_segment_size`` samples (16000 by default), else in one forward.
    """
    model.eval()
    eval_step = make_eval_step(loss_fn)
    chunked = make_rf_chunked_eval(model, args) if args.split_eval else None
    device = next(model.parameters()).device
    for x, x_sl in batches:
        if chunked is not None:
            chunked(eval_step, model, generator, x, x_sl, {}, tracker, source)
        else:
            batch = dict(x=torch.from_numpy(x).to(device), x_sl=torch.from_numpy(x_sl).to(device))
            mets, _ = eval_step(model, generator, batch, {})
            tracker.update(model.build_metrics(_to_host(mets)), source=source)
    return tracker.values[source]
