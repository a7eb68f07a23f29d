"""The Clockwork-VAE on audio: CLI, model construction, annealers, the training loop, the test pass (whole and
state-carry) and generation.

Port of ``experiments/experiment_clockwork_audio.py``: its flags (so the CW-VAE run specs of
``experiments/benchmarks.txt`` parse), its model (``:54-77``, raising where the JAX package raises: strides that the
coder's blocks cannot factor), its beta and free-nats annealers (``:79-87``), its training loop with them
(``:89-99``), its chunked test pass with every
level's ``(z, h)`` carried from chunk to chunk and same padding on the last chunk only (``:101-135``), and its
generation hook, 128000 frames at the DMoL mode (``:137-143``). The test pass uses the scalars the JAX runner
gives every evaluation, ``beta = 1`` and ``free_nats = 0``. The batch encoding and the whole-batch test pass are
the shared :mod:`blvm_tpu_torch.experiments.common`. ``--scan_unroll`` only schedules XLA and is accepted and
ignored; ``--length_sampler`` is accepted for the dataset loader that is not ported yet. Models build on the card
unless a device is given; there a forward runs K10 once a level, K11 once a coder block (six a level at the run
specs' three blocks), K2 and K3 once each, and a train step's backward K10-bwd once a level, K11-bwd once a coder
block and K2-bwd once.

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
from blvm_tpu_torch.models.clockwork_vae.clockwork_vae import CWVAEAudio
from blvm_tpu_torch.training.annealers import CosineAnnealer
from blvm_tpu_torch.training.train_state import TrainState

# the scalars of every evaluation (blvm_tpu experiments/common.py:768-771)
EVAL_SCALARS = dict(beta=1.0, free_nats=0.0)


def build_parser() -> argparse.ArgumentParser:
    # the CW-VAE driver's defaults (experiment_clockwork_audio.py:14-51)
    parser = common.build_parser(__doc__.split("\n")[0], batch_len=16000 * 16)
    parser.add_argument("--length_sampler", default=False, type=str2bool,
                        help="accepted; the length sampler comes with the dataset loader")
    model_group = parser.add_argument_group("model")
    model_group.add_argument("--hidden_size", default=[96], type=int, nargs="+")
    model_group.add_argument("--latent_size", default=[96], type=int, nargs="+")
    model_group.add_argument("--global_size", default=0, type=int)
    model_group.add_argument("--strides", default=[64, 16, 16], type=int, nargs="+")
    model_group.add_argument("--num_level_layers", default=3, type=int)
    model_group.add_argument("--stride_per_layer", default=4, type=int)
    model_group.add_argument("--residual_posterior", default=False, type=str2bool)
    model_group.add_argument("--precision_posterior", default=False, type=str2bool)
    model_group.add_argument("--with_resets", default=False, type=str2bool)
    model_group.add_argument("--scan_unroll", default=1, type=int, help="accepted; only schedules XLA")
    model_group.add_argument("--input_coding", default="mu_law", type=str, choices=["mu_law", "linear"])
    model_group.add_argument("--num_bits", default=16, type=int)
    model_group.add_argument("--likelihood", default="DMoL", type=str)
    model_group.add_argument("--num_mix", default=10, type=int)
    model_group.add_argument("--random_segment_size", default=None, type=int)
    model_group.add_argument("--beta_anneal_steps", default=50000, type=int)
    model_group.add_argument("--beta_start_value", default=0, type=float)
    model_group.add_argument("--free_nats_steps", default=0, type=int)
    model_group.add_argument("--free_nats_start_value", default=2.0, type=float)
    model_group.add_argument("--split_eval", default=False, type=str2bool)
    model_group.add_argument("--generate_every", default=25, type=int)
    model_group.add_argument("--generate_frames", default=128000, type=int,
                             help="waveform frames a generated clip (0 disables)")
    return parser


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return common.parse_args(build_parser(), argv)


def build_model(args: argparse.Namespace, device=None) -> CWVAEAudio:
    """The CWVAEAudio the JAX driver builds from the same flags, on ``device`` (default: the card; raises where there
    is none). A single ``--hidden_size`` or ``--latent_size`` serves every level. Strides the coder cannot factor
    raise as in JAX (``ValueError``, or ``AssertionError`` for too few blocks); GMM and Gaussian likelihoods and
    ``--bf16`` raise ``NotImplementedError``."""
    device = resolve_device(device)
    n_levels = len(args.strides)

    def expand(values):
        values = list(values)
        return tuple(values * n_levels) if len(values) == 1 else tuple(values)

    return CWVAEAudio(
        z_size=expand(args.latent_size),
        h_size=expand(args.hidden_size),
        g_size=args.global_size,
        strides=tuple(args.strides),
        residual_posterior=args.residual_posterior,
        precision_posterior=args.precision_posterior,
        with_resets=args.with_resets,
        num_level_layers=args.num_level_layers,
        stride_per_layer=args.stride_per_layer,
        likelihood=args.likelihood,
        num_mix=args.num_mix,
        num_bins=2**args.num_bits,
        bf16=args.bf16,
        unroll=args.scan_unroll,
        device=device,
    )


def build_annealers(args: argparse.Namespace) -> dict:
    """The beta and free-nats schedules of ``experiment_clockwork_audio.py:79-87``."""
    return dict(
        beta=CosineAnnealer(anneal_steps=args.beta_anneal_steps, start_value=args.beta_start_value, end_value=1.0),
        free_nats=CosineAnnealer(anneal_steps=args.free_nats_steps // 2, constant_steps=args.free_nats_steps // 2,
                                 start_value=args.free_nats_start_value, end_value=0.0),
    )


def train(model: CWVAEAudio, args: argparse.Namespace, batches_per_epoch: Sequence[Sequence[Tuple[int, np.ndarray]]],
          tracker: Tracker, device=None) -> TrainState:
    """The driver's training loop (:func:`common.train`) with :func:`build_annealers`: beta and free nats stepped
    once a train step and handed to the forward, their values logged under the ``train`` source
    (``CWVAEAudio.build_metrics``). The train loss's ``pad_strideable=True`` (``experiment_clockwork_audio.py:89-99``)
    is ``CWVAEAudio.forward``'s default, as it is the flax model's. Runs on the card unless given ``device="cpu"``.
    Returns the final :class:`TrainState`."""
    return common.train(model, args, batches_per_epoch, tracker, device=device, annealers=build_annealers(args))


def make_state_carry_eval(model: CWVAEAudio, args: argparse.Namespace):
    """The chunked test pass with carried state (``experiment_clockwork_audio.py:123-135``): chunks of
    ``CWVAEAudio.split_sequence`` at ``--random_segment_size`` or 4 x the overall stride samples, made wholly
    strideable and overlapping by ``rf - stride``; every chunk without same padding but the last, each level's ``(z,
    h)`` carried from the previous chunk's ``state_n`` (zeros first). Returns ``state_carry_eval(eval_step, model,
    generator, x, x_sl, scalars, tracker, source)``, which updates ``tracker`` once a chunk and returns the last
    chunk's outputs."""

    def state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker, source):
        chunks, lens = model.split_sequence(x, x_sl, length=args.random_segment_size or 4 * model.overall_stride)
        device = next(model.parameters()).device
        values = {name: scalars.get(name, default) for name, default in EVAL_SCALARS.items()}
        state0, out = None, None
        for i, (xs, sl) in enumerate(zip(chunks, lens)):
            batch = dict(
                x=torch.from_numpy(np.ascontiguousarray(xs)).to(device),
                x_sl=torch.from_numpy(np.asarray(sl, np.int32)).to(device),
                kwargs=dict(state0=state0, pad_strideable=False, pad_same=i == len(chunks) - 1, **values),
            )
            mets, out = eval_step(model, generator, batch, {})
            state0 = out.state_n
            tracker.update(model.build_metrics(to_host(mets)), source=source)
        return out

    return state_carry_eval


def evaluate(
    model: CWVAEAudio,
    args: argparse.Namespace,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    tracker: Tracker,
    source: str = "test",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """The test pass (:func:`common.evaluate`): with ``--split_eval`` each batch is scored in chunks with every
    level's state carried (:func:`make_state_carry_eval`), else in one forward with same padding (the JAX loss
    function's ``pad_strideable=True``); the summary holds the loss, the ELBO and reconstruction in nats and
    bits/frame, its EMA, the KL in nats and bits per step, each level's KL, beta and free_nats."""
    chunked = make_state_carry_eval(model, args) if args.split_eval else None
    return common.evaluate(model, args, batches, tracker, source, generator, chunked=chunked,
                           forward_kwargs=dict(pad_strideable=True, **EVAL_SCALARS))


def make_generation_hook(model: CWVAEAudio, args: argparse.Namespace):
    """The driver's generation hook: every ``--generate_every`` epochs, 2 sequences of ``--generate_frames``
    frames at the DMoL mode (``use_mode_observations=True``, ``experiment_clockwork_audio.py:141-143``), the
    latents sampled (:func:`common.make_generation_hook`); ``--generate_frames 0`` disables it."""

    def generate(generator):
        (x, _), _ = model.generate(n_samples=2, max_timesteps=args.generate_frames, use_mode_observations=True,
                                   generator=generator)
        return x.reshape(x.shape[0], -1)

    if args.generate_frames <= 0:
        return lambda epoch, run_dir, generator=None: []
    return common.make_generation_hook(model, args, generate)
