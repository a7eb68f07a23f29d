"""VRNN on audio: CLI, model construction, annealers, training, the state-carry test pass and generation.

Port of ``experiments/experiment_vrnn_audio.py``: its flags (so the VRNN run specs
of ``experiments/benchmarks.txt`` parse), its model, its training loop with the beta
and free-nats annealers stepped once a train step (``:90-109``), its chunked test pass
with the GRU state carried from chunk to chunk (``:116-137``) and its generation hook.
The test pass uses the scalars the JAX runner gives every evaluation, ``beta = 1`` and
``free_nats = 0`` (the true ELBO). The batch encoding, the train step and the
whole-batch test pass are the shared :mod:`blvm_tpu_torch.experiments.common`.
``--scan_unroll`` only schedules XLA and ``--dropout`` is parsed but unused, as in the
JAX driver. Models build on the card unless a device is given; on the card a train
step runs K8 in save mode forward and K8-bwd backward.

    args = build_args(argv)
    model = build_model(args)
    state = train(model, args, batches_per_epoch, tracker)
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
from blvm_tpu_torch.models.vrnn import VRNNAudio
from blvm_tpu_torch.ops.padding import get_modulo_length
from blvm_tpu_torch.ops.sequence import split_sequence
from blvm_tpu_torch.training.annealers import CosineAnnealer
from blvm_tpu_torch.training.train_state import TrainState

# the scalars of every evaluation (blvm_tpu experiments/common.py:768-771)
EVAL_SCALARS = dict(beta=1.0, free_nats=0.0)


def build_parser() -> argparse.ArgumentParser:
    # the VRNN driver's defaults (experiment_vrnn_audio.py:17-53)
    parser = common.build_parser(__doc__.split("\n")[0], batch_len=16000 * 16)
    parser.set_defaults(max_grad_norm=3000.0, max_grad_value=1000.0)
    model_group = parser.add_argument_group("model")
    model_group.add_argument("--stack_frames", default=200, type=int)
    model_group.add_argument("--hidden_size", default=512, type=int)
    model_group.add_argument("--latent_size", default=256, type=int)
    model_group.add_argument("--r_dim", default=None, type=int, help="GRU state size (default 2*hidden_size)")
    model_group.add_argument("--residual_posterior", default=True, type=str2bool)
    model_group.add_argument("--condition_h_on_x", default=True, type=str2bool)
    model_group.add_argument("--condition_x_on_h", default=True, type=str2bool)
    model_group.add_argument("--dropout", default=0.0, type=float, help="parsed; the model has no dropout")
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
    model_group.add_argument("--generate_every", default=25, type=int)
    model_group.add_argument("--generate_frames", default=128000, type=int,
                             help="waveform frames per generated eval clip (0 disables)")
    return parser


def build_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return common.parse_args(build_parser(), argv)


def build_model(args: argparse.Namespace, device=None) -> VRNNAudio:
    """The VRNNAudio the JAX driver builds from the same flags, on ``device`` (default:
    the card; raises where there is none). GMM and Gaussian likelihoods raise
    ``NotImplementedError``."""
    device = resolve_device(device)
    return VRNNAudio(
        likelihood=args.likelihood,
        input_size=args.stack_frames,
        hidden_size=args.hidden_size,
        latent_size=args.latent_size,
        r_dim=args.r_dim,
        residual_posterior=args.residual_posterior,
        condition_h_on_x=args.condition_h_on_x,
        condition_x_on_h=args.condition_x_on_h,
        num_mix=args.num_mix,
        num_bins=2**args.num_bits,
        unroll=args.scan_unroll,
        device=device,
    )


def build_annealers(args: argparse.Namespace) -> dict:
    """The beta and free-nats schedules of ``experiment_vrnn_audio.py:90-98``."""
    return dict(
        beta=CosineAnnealer(anneal_steps=args.beta_anneal_steps, start_value=args.beta_start_value, end_value=1.0),
        free_nats=CosineAnnealer(anneal_steps=args.free_nats_steps // 2, constant_steps=args.free_nats_steps // 2,
                                 start_value=args.free_nats_start_value, end_value=0.0),
    )


def train(model: VRNNAudio, args: argparse.Namespace, batches_per_epoch: Sequence[Sequence[Tuple[int, np.ndarray]]],
          tracker: Tracker, device=None) -> TrainState:
    """The driver's training loop (:func:`common.train`) with :func:`build_annealers`: beta
    and free nats stepped once a train step and handed to the forward, their values logged
    under the ``train`` source (``VRNNAudio.build_metrics``). Returns the final
    :class:`TrainState`."""
    return common.train(model, args, batches_per_epoch, tracker, device=device, annealers=build_annealers(args))


def make_state_carry_eval(model: VRNNAudio, args: argparse.Namespace):
    """The chunked test pass with carried state (``experiment_vrnn_audio.py:116-137``):
    chunks of ``get_modulo_length(--random_segment_size or 16 * stack_frames, stack_frames)``
    samples with no overlap, each chunk's ``h_n`` the next one's ``h0``, from zeros of width
    ``r_dim``. Returns ``state_carry_eval(eval_step, model, generator, x, x_sl, scalars,
    tracker, source)``, which updates ``tracker`` once per chunk and returns the last chunk's
    outputs."""

    def state_carry_eval(eval_step, model, generator, x, x_sl, scalars, tracker, source):
        length = get_modulo_length(args.random_segment_size or 16 * args.stack_frames, args.stack_frames)
        chunks, lens = split_sequence(x, x_sl, length=length, overlap=0)
        device = next(model.parameters()).device
        h0 = torch.zeros((x.shape[0], args.r_dim or 2 * args.hidden_size), device=device)
        out = None
        for xs, sl in zip(chunks, lens):
            batch = dict(
                x=torch.from_numpy(np.ascontiguousarray(xs)).to(device),
                x_sl=torch.from_numpy(np.asarray(sl, np.int32)).to(device),
                kwargs=dict(h0=h0, **EVAL_SCALARS),
            )
            mets, out = eval_step(model, generator, batch, scalars)
            h0 = out.h_n
            tracker.update(model.build_metrics(to_host(mets)), source=source)
        return out

    return state_carry_eval


def evaluate(
    model: VRNNAudio,
    args: argparse.Namespace,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    tracker: Tracker,
    source: str = "test",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """The test pass (:func:`common.evaluate`): with ``--split_eval`` each batch is scored in
    chunks with the GRU state carried (:func:`make_state_carry_eval`), else in one forward;
    the summary holds loss, elbo, rec, kl, kl (bpt), bpd, beta and free_nats."""
    chunked = make_state_carry_eval(model, args) if args.split_eval else None
    return common.evaluate(model, args, batches, tracker, source, generator, chunked=chunked,
                           forward_kwargs=EVAL_SCALARS)


def make_generation_hook(model: VRNNAudio, args: argparse.Namespace):
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
