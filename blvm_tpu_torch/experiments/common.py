"""What the audio drivers share (port of the family-independent parts of ``experiments/common.py``).

The setup, training and optimizer flags with the JAX drivers' names, the batch
encoding (mu-law, right-padding), ``build_tx_and_lr``, the training loop
(:func:`train`: random segments, mu-law, the family's annealers stepped once a step
(:func:`make_scalar_schedules`), the train step, the step's metrics under the ``train``
source), the test pass (:func:`evaluate`, whole or in a family's chunks)
and the wav-writing half of the generation hook. Each family's driver
(``wavenet_audio.py``, ``lstm_audio.py``, ``vrnn_audio.py``) adds its model flags, its model and its
chunked test pass. Dataset loading from TIMIT files and checkpoints come later:
the caller hands over the waveforms. Entry points run on the card unless given
``device="cpu"``.
"""

import argparse
import json
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from blvm_tpu_torch.data.transforms import MuLawDecode, MuLawEncode, RandomSegment
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.training.eval_step import make_eval_step
from blvm_tpu_torch.training.optim import EpochSchedule, get_lr_schedule, get_optimizer
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step
from blvm_tpu_torch.utils.audio import save_wav


# the torch.profiler span around each step of the driver's loops (the batch's upload, the step, its metrics queued)
STEP_SPAN = "driver.step"


def str2bool(arg) -> bool:
    if isinstance(arg, bool):
        return arg
    if arg.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if arg.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Could not parse argument {arg} of type {type(arg)} as bool.")


def float_or_str(arg: Union[float, str]) -> Union[float, str]:
    try:
        return float(arg)
    except ValueError:
        return arg


def build_parser(description: str, batch_len: float) -> argparse.ArgumentParser:
    """The setup, training and optimizer groups (``blvm_tpu/utils/argparsers.py:87-113``)
    with a driver's ``--batch_len`` default; the driver adds its ``model`` group."""
    parser = argparse.ArgumentParser(description=description)
    setup_group = parser.add_argument_group("setup")
    setup_group.add_argument("--seed", type=int, default=int(time.time_ns() % (2**31)))
    setup_group.add_argument("--bf16", type=str2bool, default=False, help="bfloat16 compute (likelihoods stay f32)")
    train_group = parser.add_argument_group("training")
    train_group.add_argument("--epochs", type=int, default=1000)
    train_group.add_argument("--batch_size", type=int, default=0, help="batch size in number of examples")
    train_group.add_argument("--batch_len", type=float_or_str, default=batch_len, help="batch size in total timesteps")
    train_group.add_argument("--lr", type=float, default=3e-4)
    train_group.add_argument("--accum_steps", type=int, default=1, help="gradient-accumulation microbatches per step")
    train_group.add_argument("--accum_unroll", type=str2bool, default=False, help="accepted; only schedules XLA")
    train_group.add_argument("--metric_fetch_lag", type=int, default=8,
                             help="read a step's metrics to the host this many steps late (0: every step)")
    optim_group = parser.add_argument_group("optimizer")
    optim_group.add_argument("--optimizer", type=str, default="Adam")
    optim_group.add_argument("--optimizer_kwargs", type=json.loads, default=dict())
    optim_group.add_argument("--max_grad_norm", type=float, default=float("inf"))
    optim_group.add_argument("--max_grad_value", type=float, default=float("inf"))
    optim_group.add_argument("--lr_scheduler", type=str, default="ExponentialLR")
    optim_group.add_argument("--lr_scheduler_kwargs", type=json.loads, default=dict(gamma=1))
    return parser


def parse_args(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse ``argv``; flags the port does not use yet (``--dataset``, ``--test_every``, ...)
    are ignored with a warning, so the run specs of ``experiments/benchmarks.txt`` parse."""
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        warnings.warn(f"ignoring flags blvm_tpu_torch does not use yet: {unknown}", stacklevel=3)
    return args


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when none is given; raises when asked for CUDA
    where there is none (the port runs on the CPU only when asked)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: blvm_tpu_torch runs on the card unless given device='cpu'")
    return device


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


def build_tx_and_lr(args: argparse.Namespace):
    """``(tx, epoch_lr)`` from the optimizer and scheduler flags
    (``experiments/common.py:build_tx_and_lr``). Torch-named schedulers are
    epoch-denominated (:class:`EpochSchedule`); the loop sets the optimizer's
    learning rate at the start of each epoch. ``tx`` waits for the parameters."""
    lr = get_lr_schedule(args.lr_scheduler, args.lr, **args.lr_scheduler_kwargs) if args.lr_scheduler else args.lr
    epoch_lr = lr if isinstance(lr, EpochSchedule) else None
    tx = get_optimizer(
        args.optimizer,
        epoch_lr.init_value if epoch_lr is not None else lr,
        clip_grad_norm=None if args.max_grad_norm == float("inf") else args.max_grad_norm,
        clip_grad_value=None if args.max_grad_value == float("inf") else args.max_grad_value,
        skip_nonfinite_updates=getattr(args, "skip_nonfinite_updates", False),
        **args.optimizer_kwargs,
    )
    return tx, epoch_lr


def make_train_batch(examples: Sequence[Tuple[int, np.ndarray]], args: argparse.Namespace, epoch: int,
                     crop: Optional[RandomSegment]) -> Tuple[np.ndarray, np.ndarray]:
    """The training pipeline of one batch: the ``crop`` of each ``(example_id,
    waveform)`` (a pure function of seed, epoch and example id; none without
    ``--random_segment_size``), then mu-law encoding and right-padding (:func:`make_batch`)."""
    waveforms = [crop(np.asarray(w), ctx=dict(example_id=i, epoch=epoch)) if crop else np.asarray(w) for i, w in examples]
    return make_batch(waveforms, args)


def make_scalar_schedules(annealers: Dict[str, object]) -> Callable[[], Dict[str, torch.Tensor]]:
    """``step_schedules()`` steps every annealer once and returns ``{name: value}``
    (``experiments/common.py:make_scalar_schedules``): each value a float32 host scalar,
    as JAX hands the jitted step ``np.float32`` values, so the forward computes with it in
    float32 and a 0 is a value, not the absent default."""

    def step_schedules():
        return {name: torch.tensor(a.step(), dtype=torch.float32) for name, a in annealers.items()}

    return step_schedules


class DeferredMetrics:
    """Step metrics read to the host ``lag`` steps late (port of ``experiments/common.py:275-300``), so the host
    queues the next steps' work while the card still runs a step, where a read a step would wait for the card
    every step. ``push(mets, keep)`` starts the step's copies to page-locked host memory behind its work, without a
    wait, and queues them with what must outlive the step (its pinned upload buffers); once more than ``lag`` are
    queued, the oldest is handed to ``consume`` as numpy, waiting only if its copies have not run yet (a read on the
    stream would wait for every step queued since). ``flush()`` hands over the rest; the drivers flush before anyone
    reads the tracker, so its values are those of ``lag`` 0 (the merges run in the same order)."""

    def __init__(self, consume: Callable[[dict], None], lag: int):
        self.consume, self.lag = consume, max(0, int(lag))
        self._pending: List[Tuple[dict, Optional[torch.cuda.Event], tuple]] = []

    def push(self, mets: dict, keep: tuple = ()) -> None:
        host, ready = _copy_to_host(mets)
        self._pending.append((host, ready, keep))
        while len(self._pending) > self.lag:
            self._consume_oldest()

    def flush(self) -> None:
        while self._pending:
            self._consume_oldest()

    def _consume_oldest(self) -> None:
        host, ready, _ = self._pending.pop(0)
        if ready is not None and not ready.query():
            ready.synchronize()
        self.consume({k: v.numpy() for k, v in host.items()})


def _copy_to_host(mets: dict) -> Tuple[dict, Optional[torch.cuda.Event]]:
    """``(host tensors, the event after their copies)``: each card tensor copied into page-locked memory with
    ``non_blocking=True`` on its stream; without one, the tensors themselves and no event."""
    mets = {k: v.detach() for k, v in mets.items()}
    cards = [v for v in mets.values() if v.is_cuda]
    if not cards:
        return mets, None
    host = {}
    for k, v in mets.items():
        if v.is_cuda:
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        else:
            host[k] = v
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(cards[0].device))
    return host, ready


def upload(array: np.ndarray, device: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(tensor on device, pinned host buffer)``: to the card from page-locked memory with
    ``non_blocking=True``, so the host does not wait for the copy; the buffer must live until the
    copy has run (:class:`DeferredMetrics` keeps it with the step's metrics). On the CPU the
    array's own tensor and no buffer."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host, None
    pinned = host.pin_memory()
    return pinned.to(device, non_blocking=True), pinned


def train(
    model: torch.nn.Module,
    args: argparse.Namespace,
    batches_per_epoch: Sequence[Sequence[Tuple[int, np.ndarray]]],
    tracker: Tracker,
    device=None,
    annealers: Optional[Dict[str, object]] = None,
) -> TrainState:
    """The training loop: ``--epochs`` passes over ``batches_per_epoch`` (each batch
    a list of ``(example_id, waveform in [-1, 1])``), one train step a batch, the
    step's metrics merged into ``tracker`` under the ``train`` source.

    ``annealers`` (the VRNN's and the SRNN's beta and free nats, :func:`make_scalar_schedules`) are
    stepped once before each train step and their values handed to the forward as keyword
    arguments (:func:`loss_fn`); without any the forward sees none, as WaveNet's and
    LSTMAudio's do. Runs on ``device`` (default: the card; raises where there is none),
    where the model must already lie. Each batch goes up from pinned memory without a wait, and
    the step's metrics reach the tracker ``--metric_fetch_lag`` steps late (:class:`DeferredMetrics`,
    flushed at the end of every epoch), so the loop waits on the card only there; each step is a
    :data:`STEP_SPAN` profiler span. Returns the final :class:`TrainState`.
    """
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, training was asked on {device}")
    tx, epoch_lr = build_tx_and_lr(args)
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=device).manual_seed(args.seed))
    accum = int(args.accum_steps or 1)
    # frames-weighted microbatches, as the JAX driver weights them, from the lengths the host holds (a read
    # of the card's x_sl would stall the host once a microbatch); LSTMAudio's loss is not batch-decomposable
    # under accumulation (blvm_tpu/parallel/train_step.py:99-103), kept as JAX has it
    train_step = make_train_step(
        loss_fn,
        accum=accum,
        loss_weight=(lambda mb, mets: mb["x_sl_host"].sum()) if accum > 1 else None,
        accum_unroll=args.accum_unroll,
    )
    crop = RandomSegment(args.random_segment_size, seed=args.seed) if args.random_segment_size else None
    schedules = make_scalar_schedules(annealers or {})
    deferred = DeferredMetrics(lambda m: tracker.update(model.build_metrics(m), source="train"),
                               args.metric_fetch_lag)
    model.train()
    for epoch in range(1, args.epochs + 1):
        if epoch_lr is not None:
            state.optimizer.learning_rate = epoch_lr.lr_at_epoch(epoch)
        for examples in batches_per_epoch:
            with torch.profiler.record_function(STEP_SPAN):
                x, x_sl = make_train_batch(examples, args, epoch, crop)
                (x_dev, x_buf), (sl_dev, sl_buf) = upload(x, device), upload(x_sl, device)
                batch = dict(x=x_dev, x_sl=sl_dev, x_sl_host=torch.from_numpy(x_sl))
                state, mets = train_step(state, batch, schedules())
                deferred.push(mets, keep=(x_buf, sl_buf))
        deferred.flush()
    return state


def loss_fn(model, generator, batch, scalars):
    """The drivers' loss function: one forward, given ``batch["kwargs"]`` and the step's
    ``scalars`` (the annealers' values, e.g. the VRNN's ``beta`` and ``free_nats``) as
    keyword arguments: ``(loss, (mets, outputs))``."""
    loss, mets, outputs = model(batch["x"], batch["x_sl"], generator=generator, **batch.get("kwargs", {}), **scalars)
    return loss, (mets, outputs)


def to_host(mets: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in mets.items()}


def evaluate(
    model: torch.nn.Module,
    args: argparse.Namespace,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    tracker: Tracker,
    source: str = "test",
    generator: Optional[torch.Generator] = None,
    chunked: Optional[Callable] = None,
    forward_kwargs: Optional[dict] = None,
) -> dict:
    """The test pass: score every ``(x, x_sl)`` batch (already encoded, as
    :func:`make_batch` returns) and return the source's summary (loss, ll, bpd).

    ``chunked``, a family's ``state_carry_eval(eval_step, model, generator, x, x_sl,
    scalars, tracker, source)``, scores each batch in its chunks; without it each
    batch is one forward, given ``forward_kwargs`` besides ``x`` and ``x_sl``, uploaded
    from pinned memory, its metrics read ``--metric_fetch_lag`` batches late
    (:class:`DeferredMetrics`, flushed before the summary is read).
    """
    model.eval()
    eval_step = make_eval_step(loss_fn)
    device = next(model.parameters()).device
    deferred = DeferredMetrics(lambda m: tracker.update(model.build_metrics(m), source=source),
                               args.metric_fetch_lag)
    for x, x_sl in batches:
        if chunked is not None:
            chunked(eval_step, model, generator, x, x_sl, {}, tracker, source)
        else:
            with torch.profiler.record_function(STEP_SPAN):
                (x_dev, x_buf), (sl_dev, sl_buf) = upload(x, device), upload(x_sl, device)
                batch = dict(x=x_dev, x_sl=sl_dev, kwargs=dict(forward_kwargs or {}))
                mets, _ = eval_step(model, generator, batch, {})
                deferred.push(mets, keep=(x_buf, sl_buf))
    deferred.flush()
    return tracker.values[source]


def make_generation_hook(model: torch.nn.Module, args: argparse.Namespace,
                         generate: Callable[[torch.Generator], torch.Tensor]):
    """The drivers' generation hook (``experiments/common.py:make_generation_hook``):
    ``hook(epoch, run_dir, generator=None)`` does nothing unless ``--generate_every``
    is positive and divides ``epoch``; then ``generate(generator)`` gives ``(2, frames)``
    samples where the model lies (the card unless it lies on the CPU), which are
    decoded under ``--input_coding mu_law`` and written to
    ``run_dir/audio/epoch{epoch:04d}_generated_{i}.wav``. ``generator`` defaults to one
    seeded with the epoch, as JAX keys it (``PRNGKey(epoch)``). Returns the paths written."""
    decode = MuLawDecode(bits=args.num_bits) if args.input_coding == "mu_law" else None

    def hook(epoch: int, run_dir, generator: Optional[torch.Generator] = None) -> List[Path]:
        if args.generate_every <= 0 or epoch % args.generate_every != 0:
            return []
        device = resolve_device(next(model.parameters()).device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(epoch)
        samples = generate(generator).cpu().numpy()
        if decode is not None:
            samples = decode(samples)
        audio_dir = Path(run_dir) / "audio"
        audio_dir.mkdir(parents=True, exist_ok=True)
        paths = [audio_dir / f"epoch{epoch:04d}_generated_{i}.wav" for i in range(samples.shape[0])]
        for path, wav in zip(paths, samples):
            save_wav(path, wav)
        return paths

    return hook
