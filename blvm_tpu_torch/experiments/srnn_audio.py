"""SRNN on audio: CLI, model construction, annealers, the state-carry test pass and generation.

Port of ``experiments/experiment_srnn_audio.py``: its flags (so the SRNN run specs of
``experiments/benchmarks.txt`` parse), its model, its beta and free-nats annealers
(``:71-79``) and its training loop with them (``:80-90``), its chunked test pass with ``d_n`` and ``z_n`` carried from chunk to chunk
and ``a`` starting from zeros in every chunk (``:92-116``), and its generation hook
(``:118-122``). The test pass uses the scalars the JAX runner gives every evaluation,
``beta = 1`` and ``free_nats = 0`` (the true ELBO). The batch encoding and the whole-batch
test pass are the shared :mod:`blvm_tpu_torch.experiments.common`. ``--scan_unroll`` only
schedules XLA and is accepted and ignored. Models build on the card unless a device is
given; there a forward runs K7 twice (the d and a GRUs), K9 once, K2 and K3 once each, and a
train step's backward K7-bwd twice, K9-bwd and K2-bwd once each.

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
from blvm_tpu_torch.models.srnn import SRNNAudio
from blvm_tpu_torch.training.annealers import CosineAnnealer
from blvm_tpu_torch.training.train_state import TrainState

# the scalars of every evaluation (blvm_tpu experiments/common.py:768-771)
EVAL_SCALARS = dict(beta=1.0, free_nats=0.0)


def build_parser() -> argparse.ArgumentParser:
    # the SRNN driver's defaults (experiment_srnn_audio.py:17-52)
    parser = common.build_parser(__doc__.split("\n")[0], batch_len=16000 * 16)
    parser.set_defaults(max_grad_norm=3000.0, max_grad_value=1000.0)
    model_group = parser.add_argument_group("model")
    model_group.add_argument("--stack_frames", default=200, type=int)
    model_group.add_argument("--hidden_size", default=512, type=int)
    model_group.add_argument("--latent_size", default=256, type=int)
    model_group.add_argument("--residual_posterior", default=True, type=str2bool)
    model_group.add_argument("--smoothing", default=True, type=str2bool)
    model_group.add_argument("--dropout", default=0.0, type=float)
    model_group.add_argument("--scan_unroll", default=1, type=int, help="accepted; only schedules XLA")
    model_group.add_argument("--input_coding", default="linear", type=str, choices=["mu_law", "linear"])
    model_group.add_argument("--num_bits", default=8, type=int)
    model_group.add_argument("--random_segment_size", default=None, type=int)
    model_group.add_argument("--likelihood", default="GMM", type=str)
    model_group.add_argument("--num_mix", default=10, type=int)
    model_group.add_argument("--beta_anneal_steps", default=50000, type=int)
    model_group.add_argument("--beta_start_value", default=0, type=float)
    model_group.add_argument("--free_nats_steps", default=0, type=int)
    model_group.add_argument("--free_nats_start_value", default=0.0625, type=float)
    model_group.add_argument("--split_eval", default=False, type=str2bool)
    model_group.add_argument("--skip_nonfinite_updates", default=True, type=str2bool)
    model_group.add_argument("--generate_every", default=25, type=int)
    model_group.add_argument("--generate_frames", default=128000, type=int,
                             help="waveform frames per generated eval clip (0 disables)")
    return parser


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return common.parse_args(build_parser(), argv)


def build_model(args: argparse.Namespace, device=None) -> SRNNAudio:
    """The SRNNAudio the JAX driver builds from the same flags, on ``device`` (default: the
    card; raises where there is none). GMM and Gaussian likelihoods raise ``NotImplementedError``."""
    device = resolve_device(device)
    return SRNNAudio(
        likelihood=args.likelihood,
        input_size=args.stack_frames,
        hidden_size=args.hidden_size,
        latent_size=args.latent_size,
        dropout=args.dropout,
        residual_posterior=args.residual_posterior,
        smoothing=args.smoothing,
        num_mix=args.num_mix,
        num_bins=2**args.num_bits,
        unroll=args.scan_unroll,
        device=device,
    )


def build_annealers(args: argparse.Namespace) -> dict:
    """The beta and free-nats schedules of ``experiment_srnn_audio.py:71-79``."""
    return dict(
        beta=CosineAnnealer(anneal_steps=args.beta_anneal_steps, start_value=args.beta_start_value, end_value=1.0),
        free_nats=CosineAnnealer(anneal_steps=args.free_nats_steps // 2, constant_steps=args.free_nats_steps // 2,
                                 start_value=args.free_nats_start_value, end_value=0.0),
    )


def train(model: SRNNAudio, args: argparse.Namespace, batches_per_epoch: Sequence[Sequence[Tuple[int, np.ndarray]]],
          tracker: Tracker, device=None) -> TrainState:
    """The driver's training loop (:func:`common.train`) with :func:`build_annealers`: beta
    and free nats stepped once a train step and handed to the forward, their values logged
    under the ``train`` source (``SRNNAudio.build_metrics``). Returns the final
    :class:`TrainState`."""
    return common.train(model, args, batches_per_epoch, tracker, device=device, annealers=build_annealers(args))


def make_state_carry_eval(model: SRNNAudio, args: argparse.Namespace):
    """The chunked test pass with carried state (``experiment_srnn_audio.py:92-116``): chunks of
    ``SRNNAudio.split_sequence`` at ``--random_segment_size`` or ``16 * stack_frames`` samples
    with no overlap; each chunk's ``d_n`` and ``z_n`` are the next one's ``d_0`` and ``z_0``
    (from zeros), while ``a`` starts from zeros in every chunk, as the JAX driver passes only
    ``d0, z0``. Returns ``state_carry_eval(eval_step, model, generator, x, x_sl, scalars,
    tracker, source)``, which updates ``tracker`` once per chunk and returns the last chunk's
    outputs."""

    def state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker, source):
        chunks, lens = model.split_sequence(x, x_sl, length=args.random_segment_size or 16 * args.stack_frames)
        device = next(model.parameters()).device
        d0 = torch.zeros((x.shape[0], 2 * args.hidden_size), device=device)
        z0 = torch.zeros((x.shape[0], args.latent_size), device=device)
        out = None
        for xs, sl in zip(chunks, lens):
            batch = dict(
                x=torch.from_numpy(np.ascontiguousarray(xs)).to(device),
                x_sl=torch.from_numpy(np.asarray(sl, np.int32)).to(device),
                kwargs=dict(d_0=d0, z_0=z0, **EVAL_SCALARS),
            )
            mets, out = eval_step(model, generator, batch, scalars)
            d0, z0 = out.d_n, out.z_n
            tracker.update(model.build_metrics(to_host(mets)), source=source)
        return out

    return state_carry_eval


def evaluate(
    model: SRNNAudio,
    args: argparse.Namespace,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    tracker: Tracker,
    source: str = "test",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """The test pass (:func:`common.evaluate`): with ``--split_eval`` each batch is scored in
    chunks with ``d`` and ``z`` carried (:func:`make_state_carry_eval`), else in one forward;
    the summary holds loss, elbo, rec, kl, kl (bpt), bpd, beta and free_nats."""
    chunked = make_state_carry_eval(model, args) if args.split_eval else None
    return common.evaluate(model, args, batches, tracker, source, generator, chunked=chunked,
                           forward_kwargs=EVAL_SCALARS)


def make_generation_hook(model: SRNNAudio, args: argparse.Namespace):
    """The driver's generation hook: every ``--generate_every`` epochs, 2 sequences of
    ``--generate_frames // stack_frames`` stacks (:func:`common.make_generation_hook`);
    ``--generate_frames 0`` disables it."""
    max_timesteps = args.generate_frames // args.stack_frames

    def generate(generator):
        (x, _), _ = model.generate(n_samples=2, max_timesteps=max_timesteps, generator=generator)
        return x.reshape(x.shape[0], -1)

    if args.generate_frames <= 0:
        return lambda epoch, run_dir, generator=None: []
    return common.make_generation_hook(model, args, generate)
