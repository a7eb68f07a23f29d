"""LSTMAudio on audio: CLI, model construction, the state-carry test pass and generation.

Port of ``experiments/experiment_lstm_audio.py``: its flags (so the LSTM run
specs of ``experiments/benchmarks.txt`` parse), its model, its chunked test pass
with the LSTM state carried from chunk to chunk (``:69-89``) and its generation
hook. Training, batch encoding and the whole-batch test pass are the shared
:mod:`blvm_tpu_torch.experiments.common`. ``--scan_unroll`` only schedules XLA
and is accepted and ignored. Models build on the card unless a device is given.

    args = build_args(argv)
    model = build_model(args)
    state = common.train(model, args, [[(example_id, waveform), ...], ...], Tracker())
    values = evaluate(model, args, [common.make_batch(waveforms, args)], Tracker())
    make_generation_hook(model, args)(epoch, run_dir)
"""

import argparse
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common
from blvm_tpu_torch.experiments.common import resolve_device, str2bool, to_host
from blvm_tpu_torch.models.lstm import LSTMAudio
from blvm_tpu_torch.ops.sequence import split_sequence


def build_parser() -> argparse.ArgumentParser:
    # the LSTM driver's defaults (experiment_lstm_audio.py:17-26)
    parser = common.build_parser(__doc__.split("\n")[0], batch_len=16000 * 64)
    model_group = parser.add_argument_group("model")
    model_group.add_argument("--stack_size", default=64, type=int, help="waveform frames per input vector")
    model_group.add_argument("--hidden_size", default=256, type=int)
    model_group.add_argument("--num_layers", default=1, type=int)
    model_group.add_argument("--dropout", default=0, type=float)
    model_group.add_argument("--scan_unroll", default=1, type=int, help="accepted; only schedules XLA")
    model_group.add_argument("--input_coding", default="mu_law", type=str, choices=["mu_law", "linear"])
    model_group.add_argument("--num_bits", default=16, type=int)
    model_group.add_argument("--num_mix", default=10, type=int)
    model_group.add_argument("--likelihood", default="DMoL", type=str)
    model_group.add_argument("--random_segment_size", default=None, type=int)
    model_group.add_argument("--split_eval", default=False, type=str2bool)
    model_group.add_argument("--generate_every", default=25, type=int)
    model_group.add_argument("--generate_frames", default=16000, type=int,
                             help="waveform frames per generated eval clip (0 disables)")
    return parser


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return common.parse_args(build_parser(), argv)


def build_model(args: argparse.Namespace, device=None) -> LSTMAudio:
    """The LSTMAudio the JAX driver builds from the same flags, on ``device``
    (default: the card; raises where there is none)."""
    if args.likelihood != "DMoL":
        raise NotImplementedError("Only DMoL likelihood is supported")
    device = resolve_device(device)
    return LSTMAudio(
        stack_size=args.stack_size,
        hidden_size=args.hidden_size,
        num_layers=args.num_layers,
        dropout=args.dropout,
        num_mix=args.num_mix,
        num_bins=2**args.num_bits,
        bf16=args.bf16,
        unroll=args.scan_unroll,
        device=device,
    )


def make_state_carry_eval(model: LSTMAudio, args: argparse.Namespace):
    """The chunked test pass with carried state (``experiment_lstm_audio.py:69-89``):
    chunks of ``--random_segment_size`` samples (``16 * stack_size`` by default) with
    no overlap, the LSTM state ``s_n`` of each chunk the next one's ``s_0``, from zeros.
    Returns ``state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker,
    source)``, which updates ``tracker`` once per chunk and returns the last chunk's outputs."""

    def state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker, source):
        length = args.random_segment_size or 16 * args.stack_size
        chunks, lens = split_sequence(x, x_sl, length=length, overlap=0)
        device = next(model.parameters()).device
        s_0 = (torch.zeros((args.num_layers, x.shape[0], args.hidden_size), device=device),) * 2
        out = None
        for xs, sl in zip(chunks, lens):
            batch = dict(
                x=torch.from_numpy(np.ascontiguousarray(xs)).to(device),
                x_sl=torch.from_numpy(np.asarray(sl, np.int32)).to(device),
                kwargs=dict(s_0=s_0),
            )
            mets, out = eval_step(model, generator, batch, scalars)
            s_0 = out.s_n
            tracker.update(model.build_metrics(to_host(mets)), source=source)
        return out

    return state_carry_eval


def evaluate(
    model: LSTMAudio,
    args: argparse.Namespace,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    tracker: Tracker,
    source: str = "test",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """The test pass (:func:`common.evaluate`): with ``--split_eval`` each batch is
    scored in chunks with the LSTM state carried (:func:`make_state_carry_eval`),
    else in one forward."""
    chunked = make_state_carry_eval(model, args) if args.split_eval else None
    return common.evaluate(model, args, batches, tracker, source, generator, chunked=chunked)


def make_generation_hook(model: LSTMAudio, args: argparse.Namespace):
    """The driver's generation hook: every ``--generate_every`` epochs, 2 sequences of
    ``--generate_frames // stack_size`` stacks (:func:`common.make_generation_hook`);
    ``--generate_frames 0`` disables it, as the JAX driver builds no hook then."""
    max_timesteps = args.generate_frames // args.stack_size

    def generate(generator):
        (x, _), _ = model.generate(n_samples=2, max_timesteps=max_timesteps, generator=generator)
        return x

    if args.generate_frames <= 0:
        return lambda epoch, run_dir, generator=None: []
    return common.make_generation_hook(model, args, generate)
