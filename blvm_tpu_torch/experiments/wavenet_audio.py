"""WaveNet on audio: CLI, model construction, the training loop, the rf-chunked test pass and generation.

Port of ``experiments/experiment_wavenet_audio.py`` (``build_args``, the
model construction and its ``post_eval_hook``, which generates audio) and of
``make_rf_chunked_eval`` of ``experiments/common.py`` (the test pass in
receptive-field-overlapping chunks). What every family's driver shares (the
training loop, the optimizer flags, batch encoding, the test pass, writing the
generated wav files) is :mod:`blvm_tpu_torch.experiments.common`, re-exported
here under the names this module always had.

The model, training and optimizer flags keep the JAX driver's names and
defaults, so the run specs of ``experiments/benchmarks.txt`` parse; flags this
port does not use yet (``--dataset``, ``--test_every``, ...) are ignored with a
warning. ``--generate_every`` drives :func:`make_generation_hook`: every that
many epochs it writes two generated 16000-frame wav files. Models build on the
card unless a device is given.

    args = build_args(argv)
    model = build_model(args)
    state = train(model, args, [[(example_id, waveform), ...], ...], Tracker())
    values = evaluate(model, args, [make_batch(waveforms, args)], Tracker())
    make_generation_hook(model, args)(epoch, run_dir)
"""

import argparse
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common
from blvm_tpu_torch.experiments.common import (  # noqa: F401  (the driver's entry points)
    build_tx_and_lr, loss_fn, make_batch, make_train_batch, resolve_device, str2bool, to_host, train,
)
from blvm_tpu_torch.models.wavenet import WaveNet


def build_parser() -> argparse.ArgumentParser:
    # the WaveNet driver's defaults (experiment_wavenet_audio.py:15-22)
    parser = common.build_parser(__doc__.split("\n")[0], batch_len=16000 * 16)
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
    return common.parse_args(build_parser(), argv)


def build_model(args: argparse.Namespace, device=None) -> WaveNet:
    """The WaveNet the JAX driver builds from the same flags, on ``device``
    (default: the card; raises where there is none)."""
    device = resolve_device(device)
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
            tracker.update(model.build_metrics(to_host(mets)), source=source)
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
    """The test pass (:func:`common.evaluate`): with ``--split_eval`` each batch is
    scored in rf-overlapping chunks of ``--random_segment_size`` samples (16000 by
    default), else in one forward."""
    chunked = make_rf_chunked_eval(model, args) if args.split_eval else None
    return common.evaluate(model, args, batches, tracker, source, generator, chunked=chunked)


def make_generation_hook(model: WaveNet, args: argparse.Namespace):
    """The driver's generation hook (``experiments/experiment_wavenet_audio.py:74-90``):
    every ``--generate_every`` epochs, 2 x 16000 frames (:func:`common.make_generation_hook`)."""
    return common.make_generation_hook(model, args, lambda generator: model.generate(2, 16000, generator=generator))
