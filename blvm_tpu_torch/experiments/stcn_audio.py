"""STCN on audio: CLI, model construction, annealers, training, the rf-chunked test pass and generation.

Port of ``experiments/experiment_stcn_audio.py``: its model flags (so the STCN run specs of
``experiments/benchmarks.txt`` parse), its model, its beta and free-nats annealers (``:69-77``),
the training loop with them (:func:`train`: random segments, ``--accum_steps`` frames-weighted
microbatches, the clips, Adam), its chunked test pass (``make_rf_chunked_eval``: chunks
overlapping by the receptive field, the first rf-padded, ``beta`` and ``free_nats`` threaded into
the forward, as ``experiments/common.py:1003-1037`` does) and its generation hook (2 x
``--generate_frames``). The test pass uses the scalars the JAX runner gives every evaluation,
``beta = 1`` and ``free_nats = 0`` (the true ELBO). The tensor, pipeline and sequence parallel
flags and the eval loader's geometry are not ported. Models build on the card unless a device is
given; there a forward runs K1 30 times (20 of them skip-free), K2 and K3 once each, its backward
K1-bwd 30 times and K2-bwd once, and a fast generation K1 30 times (the primes) and K12 once a frame.

    args = build_args(argv)
    model = build_model(args)
    state = train(model, args, batches_per_epoch, Tracker())
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
from blvm_tpu_torch.models.stcn import STCN
from blvm_tpu_torch.training.annealers import CosineAnnealer
from blvm_tpu_torch.training.train_state import TrainState

# the scalars of every evaluation (blvm_tpu experiments/common.py:768-771)
EVAL_SCALARS = dict(beta=1.0, free_nats=0.0)


def build_parser() -> argparse.ArgumentParser:
    # the STCN driver's defaults (experiment_stcn_audio.py:14-49); --batch_len is raw samples there
    parser = common.build_parser(__doc__.split("\n")[0], batch_len=16000 * 16)
    model_group = parser.add_argument_group("model")
    model_group.add_argument("--hidden_size", default=256, type=int, help="res_channels of the conv stacks")
    model_group.add_argument("--latent_size", default=[256, 128, 64, 32, 16], type=int, nargs="+")
    model_group.add_argument("--num_layers", default=5, type=int, help="WaveNet blocks per stack")
    model_group.add_argument("--num_stacks", default=None, type=int, help="WaveNet stacks (defaults to number of latents)")
    model_group.add_argument("--kernel_size", default=2, type=int)
    model_group.add_argument("--base_dilation", default=2, type=int)
    model_group.add_argument("--num_stack_frames", default=1, type=int)
    model_group.add_argument("--precision_posterior", default=True, type=str2bool)
    model_group.add_argument("--dense", default=True, type=str2bool)
    model_group.add_argument("--top_down", default=True, type=str2bool)
    model_group.add_argument("--input_coding", default="mu_law", type=str, choices=["mu_law", "linear"])
    model_group.add_argument("--num_bits", default=16, type=int)
    model_group.add_argument("--likelihood", default="DMoL", type=str)
    model_group.add_argument("--random_segment_size", default=None, type=int)
    model_group.add_argument("--beta_anneal_steps", default=50000, type=int)
    model_group.add_argument("--beta_start_value", default=0, type=float)
    model_group.add_argument("--free_nats_steps", default=0, type=int)
    model_group.add_argument("--free_nats_start_value", default=0.0625, type=float)
    model_group.add_argument("--split_eval", default=False, type=str2bool)
    model_group.add_argument("--generate_every", default=25, type=int,
                             help="log 2 ancestrally generated clips every N eval epochs (0 disables)")
    model_group.add_argument("--generate_frames", default=16000, type=int)
    return parser


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return common.parse_args(build_parser(), argv)


def build_model(args: argparse.Namespace, device=None) -> STCN:
    """The STCN the JAX driver builds from the same flags (``experiment_stcn_audio.py:53-67``), on
    ``device`` (default: the card; raises where there is none). GMM and Gaussian likelihoods raise
    ``NotImplementedError``."""
    device = resolve_device(device)
    return STCN(
        likelihood=args.likelihood,
        n_layers=args.num_layers,
        n_stacks=args.num_stacks,
        latent_size=tuple(args.latent_size),
        res_channels=args.hidden_size,
        kernel_size=args.kernel_size,
        base_dilation=args.base_dilation,
        n_stack_frames=args.num_stack_frames,
        precision_posterior=args.precision_posterior,
        dense=args.dense,
        top_down=args.top_down,
        bf16=args.bf16,
        device=device,
    )


def build_annealers(args: argparse.Namespace) -> dict:
    """The beta and free-nats schedules of ``experiment_stcn_audio.py:69-77``."""
    return dict(
        beta=CosineAnnealer(anneal_steps=args.beta_anneal_steps, start_value=args.beta_start_value, end_value=1.0),
        free_nats=CosineAnnealer(anneal_steps=args.free_nats_steps // 2, constant_steps=args.free_nats_steps // 2,
                                 start_value=args.free_nats_start_value, end_value=0.0),
    )


def train(model: STCN, args: argparse.Namespace, batches_per_epoch: Sequence[Sequence[Tuple[int, np.ndarray]]],
          tracker: Tracker, device=None) -> TrainState:
    """The driver's training loop (:func:`common.train`) with :func:`build_annealers`: beta and free
    nats stepped once a train step and handed to the forward, their values logged under the
    ``train`` source (``STCN.build_metrics``); ``--accum_steps`` microbatches weighted by their
    frames. Runs on the card unless given ``device="cpu"``. Returns the final :class:`TrainState`."""
    return common.train(model, args, batches_per_epoch, tracker, device=device, annealers=build_annealers(args))


def make_rf_chunked_eval(model: STCN, args: argparse.Namespace):
    """The chunked test pass (``experiments/common.py:1003-1037`` with ``scalar_names=("beta",
    "free_nats")``): chunks of ``STCN.split_sequence`` at ``--random_segment_size`` samples (16000
    without it) overlapping by the receptive field, the first rf-padded, no carried state; each
    forward is given ``beta`` and ``free_nats`` from the step's scalars (1 and 0 when absent).
    Returns ``state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker, source)``,
    which updates ``tracker`` once per chunk and returns the last chunk's outputs."""

    def state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker, source):
        chunks, lens = model.split_sequence(x, x_sl, length=args.random_segment_size or 16000)
        device = next(model.parameters()).device
        values = {name: scalars.get(name, default) for name, default in EVAL_SCALARS.items()}
        out = None
        for i, (xs, sl) in enumerate(zip(chunks, lens)):
            batch = dict(
                x=torch.from_numpy(np.ascontiguousarray(xs)).to(device),
                x_sl=torch.from_numpy(np.asarray(sl, np.int32)).to(device),
                kwargs=dict(pad_receptive_field=(i == 0), **values),
            )
            mets, out = eval_step(model, generator, batch, {})
            tracker.update(model.build_metrics(to_host(mets)), source=source)
        return out

    return state_carry_eval


def evaluate(
    model: STCN,
    args: argparse.Namespace,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    tracker: Tracker,
    source: str = "test",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """The test pass (:func:`common.evaluate`): with ``--split_eval`` each batch is scored in
    rf-overlapping chunks (:func:`make_rf_chunked_eval`), else in one forward; the summary holds
    the loss, the ELBO and reconstruction in nats and bits per x, the KL in nats and bits per z,
    each level's KL, beta and free_nats."""
    chunked = make_rf_chunked_eval(model, args) if args.split_eval else None
    return common.evaluate(model, args, batches, tracker, source, generator, chunked=chunked,
                           forward_kwargs=EVAL_SCALARS)


def make_generation_hook(model: STCN, args: argparse.Namespace):
    """The driver's generation hook (``experiment_stcn_audio.py:88``): every ``--generate_every``
    epochs, 2 sequences of ``--generate_frames`` frames (:func:`common.make_generation_hook`);
    ``--generate_frames 0`` disables it."""

    def generate(generator):
        (x, _), _ = model.generate(n_samples=2, max_timesteps=args.generate_frames, generator=generator)
        return x

    if args.generate_frames <= 0:
        return lambda epoch, run_dir, generator=None: []
    return common.make_generation_hook(model, args, generate)
