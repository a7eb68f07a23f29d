"""STCN, the stochastic temporal convolutional network (port of ``blvm_tpu/models/stcn/stcn.py``).

Same structure as the JAX model: a dilated WaveNet ``ResidualStack`` whose every n-th skip
(blocks 4, 9, 14, 19 and 24 at five latent levels of five blocks) feeds one latent level; the
prior reads the skips one frame back (``d[:, :-1]``), the posterior the unshifted ones
(``d[:, 1:]``); top-down (analytic KL) or bottom-up (MC KL) inference with the optional
precision-weighted posterior; dense (all z) or bottom-only decoding through a dilation-1
``ResidualStack`` left-padded by its receptive field less one; the skip sum in f32 scaled by
``1/sqrt(n_stacks)``, ``relu(Dense)`` to the likelihood's 30 features and the DMoL head.
The encoder's other 20 blocks run without their skip (``skip_mask``; K1's skip-free mode on
the card). Parameters keep the flax names (``res_stack/Conv1dResidualGLU_3/rs_kernel``,
``prior_4/MLP_1/Dense_2/bias``, ``out_upsample/Dense_0/kernel``), so JAX trees load through
:mod:`blvm_tpu_torch.weights`.

The latent noise is drawn by :func:`gaussian_noise` from the caller's ``torch.Generator``
unless given (``eps``). ``generate`` is ancestral sampling: with ``kernel_size == 2`` and one
frame a step the fast path (circular buffers in both stacks, primed by one windowed forward of
each; on the card its frame loop is K12, :class:`~blvm_tpu_torch.ops.generation.STCNDecoder`),
else the windowed path (the oracle: both stacks over their receptive fields every step, K1 and
K3 a step on the card). Only the DMoL likelihood is ported (GMM and Gaussian raise).
"""

import math
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blvm_tpu_torch.evaluation.metrics import (
    BitsPerDimMetric,
    KLMetric,
    LatestMeanMetric,
    LLMetric,
    LossMetric,
    drop_padded_rows,
)
from blvm_tpu_torch.models.base import BaseModel
from blvm_tpu_torch.models.wavenet.modules import CausalConv1d, ResidualStack
from blvm_tpu_torch.modules.common import MLP, Dense, leaky_relu
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense, sd_beta
from blvm_tpu_torch.ops.generation import STCNDecoder
from blvm_tpu_torch.ops.likelihoods import at_least_f32, softplus_beta
from blvm_tpu_torch.ops.padding import get_modulo_length
from blvm_tpu_torch.ops.sequence import sequence_mask, split_sequence, stack_tensor
from blvm_tpu_torch.ops.variational import (
    FrameKeys,
    discount_free_nats,
    gaussian_noise,
    kl_divergence_gaussian,
    kl_divergence_gaussian_mc,
    precision_weighted_gaussian,
)

LIKELIHOOD_FEATURES = 30  # the DMoL head's 10 mixtures x (logit, loc, log-scale)


class DiagonalGaussianDenseSTCN(nn.Module):
    """Two 3-layer LeakyReLU MLPs, ``MLP_0`` for the mean and ``MLP_1`` for the raw scale,
    ``sd = softplus_beta(raw, log 2 / (init_sd_mean - epsilon)) + epsilon`` (``stcn.py:50-72``).
    ``dtype`` is the MLPs' compute dtype; ``mu`` and ``sd`` come out at least f32."""

    def __init__(self, in_features: int, out_channels: int, hidden_channels: int, init_sd_mean: float = 1.0,
                 epsilon: float = 1e-3, dtype=None, device=None):
        super().__init__()
        self.init_sd_mean, self.epsilon = init_sd_mean, epsilon
        sizes = [hidden_channels, hidden_channels, out_channels]
        self.MLP_0 = MLP(in_features, sizes, activation=leaky_relu, activate_final=False, dtype=dtype, device=device)
        self.MLP_1 = MLP(in_features, sizes, activation=leaky_relu, activate_final=False, dtype=dtype, device=device)

    @property
    def beta(self) -> float:
        return sd_beta(self.init_sd_mean, self.epsilon)

    def forward(self, x: torch.Tensor):
        mu = at_least_f32(self.MLP_0(x))
        sd = softplus_beta(at_least_f32(self.MLP_1(x)), self.beta) + self.epsilon
        return mu, sd


class _UpsampleHead(nn.Module):
    """``relu(Dense(x))`` to the likelihood's features (``stcn.py:704-712``)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, out_features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.Dense_0(x))


class STCN(BaseModel):
    """Keyword arguments and defaults are the flax ``STCN``'s fields; ``remat`` and
    ``fuse_gate_dots`` only schedule XLA and are ignored."""

    def __init__(self, likelihood: str = "DMoL", in_channels: int = 1, n_layers: int = 5,
                 n_stacks: Optional[int] = None, latent_size: Sequence[int] = (256, 128, 64, 32, 16),
                 res_channels: int = 256, kernel_size: int = 2, base_dilation: int = 2, n_stack_frames: int = 1,
                 precision_posterior: bool = True, dense: bool = True, top_down: bool = True, remat: bool = False,
                 bf16: bool = False, fuse_gate_dots: bool = False, device=None):
        latent_size = tuple(latent_size)
        super().__init__(likelihood=likelihood, in_channels=in_channels, n_layers=n_layers, n_stacks=n_stacks,
                         latent_size=latent_size, res_channels=res_channels, kernel_size=kernel_size,
                         base_dilation=base_dilation, n_stack_frames=n_stack_frames,
                         precision_posterior=precision_posterior, dense=dense, top_down=top_down, remat=remat,
                         bf16=bf16, fuse_gate_dots=fuse_gate_dots)
        if likelihood in ("GMM", "Gaussian"):
            raise NotImplementedError(f"the STCN's {likelihood} likelihood is not ported to blvm_tpu_torch yet "
                                      "(only DMoL)")
        if likelihood != "DMoL":
            raise ValueError(f"Unknown likelihood type {likelihood}")
        self.in_channels, self.n_layers, self.latent_size = in_channels, n_layers, latent_size
        self.res_channels, self.kernel_size, self.base_dilation = res_channels, kernel_size, base_dilation
        self.n_stack_frames, self.precision_posterior = n_stack_frames, precision_posterior
        self.dense, self.top_down, self.bf16 = dense, top_down, bf16
        n = len(latent_size)
        self.n_latents, self.n_stacks = n, n if n_stacks is None else n_stacks
        dtype = torch.bfloat16 if bf16 else None

        self.causal = CausalConv1d(in_channels * n_stack_frames, res_channels, kernel_size=kernel_size, device=device)
        self.res_stack = ResidualStack(n_layers, self.n_stacks, res_channels, kernel_size=kernel_size,
                                       base_dilation=base_dilation, dtype=dtype, device=device)
        # the heads in inference order, as flax's setup creates them (names carry the level)
        for l in self.order:
            cond = self.conditioning_level(l)
            in_features = res_channels + (latent_size[cond] if cond is not None else 0)
            for name, init_sd in (("prior", 0.5), ("posterior", 0.1)):
                self.add_module(f"{name}_{l}", DiagonalGaussianDenseSTCN(
                    in_features, latent_size[l], res_channels, init_sd_mean=init_sd, dtype=dtype, device=device))
        self.out_transform = ResidualStack(n_layers, 1, res_channels, kernel_size=kernel_size, base_dilation=1,
                                           dtype=dtype, in_features=self.z_dec_width, device=device)
        self.out_rf = ResidualStack.compute_receptive_fields(n_layers, 1, kernel_size, 1)[-1]
        self.inv_std = 1.0 / math.sqrt(self.n_stacks)
        self.likelihood_module = DiscretizedLogisticMixtureDense(LIKELIHOOD_FEATURES, y_dim=1, num_mix=10,
                                                                 num_bins=2**16, device=device)
        self.out_upsample = _UpsampleHead(res_channels, LIKELIHOOD_FEATURES * n_stack_frames, device=device)

    # ---- geometry ------------------------------------------------------------------------------

    @property
    def order(self) -> List[int]:
        """Latent levels in inference order: top-down from the highest, or bottom-up."""
        return list(reversed(range(self.n_latents))) if self.top_down else list(range(self.n_latents))

    def conditioning_level(self, l: int) -> Optional[int]:
        """The level whose z conditions level ``l``'s heads (None for the first in ``order``)."""
        cond = l + 1 if self.top_down else l - 1
        return cond if 0 <= cond < self.n_latents else None

    @property
    def used_blocks(self) -> List[int]:
        """The encoder blocks whose skips feed the latent levels, bottom to top (``stcn.py:289-291``)."""
        n, n_blocks = self.n_latents, self.n_layers * self.n_stacks
        return list(range(n - 1, n_blocks, n))[:n]

    @property
    def skip_mask(self) -> List[bool]:
        used = set(self.used_blocks)
        return [i in used for i in range(self.n_layers * self.n_stacks)]

    @property
    def z_offsets(self) -> List[int]:
        """Each level's first column in the concatenated z (levels in order 0 .. n-1)."""
        return [sum(self.latent_size[:l]) for l in range(self.n_latents)]

    @property
    def z_dec_width(self) -> int:
        """The decode stack's input width: all levels' z (dense) or z_0."""
        return sum(self.latent_size) if self.dense else self.latent_size[0]

    @property
    def receptive_fields(self) -> List[int]:
        rfs = ResidualStack.compute_receptive_fields(self.n_layers, self.n_stacks, self.kernel_size, self.base_dilation)
        return [rf + self.kernel_size - 1 for rf in rfs]

    @property
    def receptive_field(self) -> int:
        return self.receptive_fields[-1]

    def _head(self, kind: str, l: int) -> DiagonalGaussianDenseSTCN:
        return getattr(self, f"{kind}_{l}")

    # ---- the forward ---------------------------------------------------------------------------

    def infer(self, skips: List[torch.Tensor], generator: Optional[torch.Generator] = None,
              eps: Optional[Sequence[torch.Tensor]] = None):
        """Hierarchical inference from every n-th skip with the one-frame shift
        (``stcn.py:190-228``). Skips are (B, T+1, C); ``eps[l]`` (B, T, z_l) is level l's noise
        (drawn from ``generator`` when None). Returns ``(mu_p, sd_p, mu_q, sd_q, z)``, lists by level."""
        n = self.n_latents
        d = skips[n - 1 :: n][:n]
        d_p = [d_[:, :-1] for d_ in d]
        d_q = [d_[:, 1:] for d_ in d]
        mu_p, sd_p, mu_q, sd_q, z = ([None] * n for _ in range(5))
        for l in self.order:
            cond = self.conditioning_level(l)
            if cond is None:
                in_p, in_q = d_p[l], d_q[l]
            else:
                dt = d_p[l].dtype
                in_p = torch.cat([d_p[l], z[cond].to(dt)], dim=-1)
                in_q = torch.cat([d_q[l], z[cond].to(dt)], dim=-1)
            mu_p[l], sd_p[l] = self._head("prior", l)(in_p)
            mu_q[l], sd_q[l] = self._head("posterior", l)(in_q)
            if self.precision_posterior:
                mu_q[l], sd_q[l] = precision_weighted_gaussian(mu_p[l], sd_p[l], mu_q[l], sd_q[l])
            e = eps[l] if eps is not None else gaussian_noise(generator, mu_q[l].shape, mu_q[l])
            z[l] = mu_q[l] + sd_q[l] * e
        return mu_p, sd_p, mu_q, sd_q, z

    def compute_loss(self, y, x_sl, parameters, mu_p, sd_p, mu_q, sd_q, z, free_nats, beta):
        """Masked log-likelihood, per-level KL (analytic top-down, MC bottom-up), free nats per
        level (``stcn.py:230-249``): ``(loss, elbo, log_prob, kld, klds)``."""
        log_prob_twise = self.likelihood_module.log_prob(y, parameters)  # (B, T)
        seq_mask = sequence_mask(x_sl, max_len=y.shape[1], dtype=torch.float32)
        log_prob = (log_prob_twise * seq_mask).sum(dim=1)
        z_mask = seq_mask[:, :: self.n_stack_frames, None][:, : mu_p[0].shape[1]]
        n = self.n_latents
        if self.top_down:
            klds = [kl_divergence_gaussian(mu_q[l], sd_q[l], mu_p[l], sd_p[l]) * z_mask for l in range(n)]
        else:
            klds = [kl_divergence_gaussian_mc(mu_q[l], sd_q[l], mu_p[l], sd_p[l], z[l]) * z_mask for l in range(n)]
        klds_fn = [discount_free_nats(klds[l], free_nats, shared_dims=-1) * z_mask for l in range(n)]
        kld = torch.cat(klds, dim=-1).sum(dim=(1, 2))
        kld_fn = torch.cat(klds_fn, dim=-1).sum(dim=(1, 2))
        klds = [kl.sum(dim=(1, 2)) for kl in klds]
        elbo = log_prob - kld
        loss = -(log_prob - beta * kld_fn).sum() / x_sl.sum()
        return loss, elbo, log_prob, kld, klds

    def forward(self, x: torch.Tensor, x_sl: torch.Tensor, y: Optional[torch.Tensor] = None,
                pad_receptive_field: bool = True, free_nats=0.0, beta=1.0,
                generator: Optional[torch.Generator] = None, eps: Optional[Sequence[torch.Tensor]] = None):
        """``(loss, mets, outputs)`` as the JAX ``__call__`` (``stcn.py:251-300``). Without
        ``pad_receptive_field`` the first ``receptive_field`` frames are context only and
        ``x_sl`` is clamped at 0 after taking them off."""
        rf, s = self.receptive_field, self.n_stack_frames
        if y is None:
            y = x.detach()
            if not pad_receptive_field:
                y = y[:, rf * s :]
        if s > 1:
            x, p = stack_tensor(x, s, axis=1)
        else:
            p = 0
        x = x[..., None] if x.ndim == 2 else x
        y = y[..., None] if y.ndim == 2 else y
        if pad_receptive_field:
            T = x.shape[1]
            x = F.pad(x, (0, 0, rf, 0))
        else:
            T = x.shape[1] - rf
            x_sl = torch.clamp(x_sl - s * rf, min=0)
            if x.shape[1] <= rf:
                raise ValueError(f"Input must be at least as long as the receptive field if {pad_receptive_field=}")
        output = self.causal(x, pad_causal=False)
        skips = self.res_stack(output, skip_size=T + 1, skip_mask=self.skip_mask)
        return self.finish_from_skips(skips, y, x_sl, T, p, free_nats, beta, generator, eps)

    def _skip_sum(self, skips) -> torch.Tensor:
        """``sum(at_least_f32(s) for s in skips) * inv_std``: f32, in block order."""
        return sum(at_least_f32(s_) for s_ in skips) * self.inv_std

    def finish_from_skips(self, skips, y, x_sl, T: int, p: int, free_nats=0.0, beta=1.0,
                          generator: Optional[torch.Generator] = None, eps=None):
        """Latent inference, the decode stack, the head and the loss from the masked skip list
        (``stcn.py:302-374``)."""
        mu_p, sd_p, mu_q, sd_q, z = self.infer(skips, generator, eps)
        z_dec = [z_.to(torch.bfloat16) for z_ in z] if self.bf16 else z
        logits_in = torch.cat(z_dec, dim=-1) if self.dense else z_dec[0]
        logits_in = F.pad(logits_in, (0, 0, self.out_rf - 1, 0))
        logits = self.out_upsample(self._skip_sum(self.out_transform(logits_in, skip_size=T)))
        s = self.n_stack_frames
        if s > 1:
            B, Ts, _ = logits.shape
            logits = logits.reshape(B, Ts * s, LIKELIHOOD_FEATURES)
            if p:
                logits = logits[:, :-p]
        params = self.likelihood_module(logits)
        loss, elbo, log_prob, kld, klds = self.compute_loss(y, x_sl, params, mu_p, sd_p, mu_q, sd_q, z, free_nats,
                                                            beta)
        z_mask = sequence_mask(x_sl, max_len=y.shape[1], dtype=torch.float32)[:, ::s, None][:, : mu_p[0].shape[1]]
        mc_kl = sum((kl_divergence_gaussian_mc(mu_q[l], sd_q[l], mu_p[l], sd_p[l], z[l]) * z_mask).sum(dim=(1, 2))
                    for l in range(self.n_latents))
        reconstructions, reconstructions_mode = self.likelihood_module.sample_and_mode(generator, params)
        z_sl = torch.ceil(x_sl / s).to(torch.int32)
        mets = dict(loss=loss, elbo=elbo, log_prob=log_prob, kld=kld, klds=torch.stack(klds, dim=1), mc_kl=mc_kl, x_sl=x_sl,
                    beta=torch.as_tensor(beta, dtype=torch.float32),
                    free_nats=torch.as_tensor(free_nats, dtype=torch.float32))
        outputs = SimpleNamespace(
            loss=loss, elbo=elbo, klds=klds, log_prob=log_prob, z=z, z_sl=[z_sl] * self.n_stacks, enc_mus=mu_q,
            prior_mus=mu_p, params=params, y=y, reconstructions=reconstructions,
            reconstructions_mode=reconstructions_mode,
        )
        return loss, mets, outputs

    def build_metrics(self, mets: dict):
        """Per-level KL decomposition in nats, bits per z and bits per x (``stcn.py:646-678``). ``klds``
        is (B, levels) here, where JAX keeps a list of (B,) arrays."""
        mets = drop_padded_rows(mets)
        loss, elbo, log_prob, kld, x_sl = (mets[k] for k in ("loss", "elbo", "log_prob", "kld", "x_sl"))
        klds = np.asarray(mets["klds"]).T
        z_sl = np.asarray(x_sl) // self.n_stack_frames
        n, ln2 = self.n_latents, math.log(2)
        klds_nats = [KLMetric(klds[l], name=f"kl_{l} (nats)", log_to_console=False) for l in range(n)]
        klds_bpz = [KLMetric(np.asarray(klds[l]) / ln2, name=f"kl_{l} (bpz)", reduce_by=z_sl) for l in range(n)]
        klds_bpx = [KLMetric(np.asarray(klds[l]) / ln2, name=f"kl_{l} (bpx)", reduce_by=x_sl) for l in range(n)]
        return [
            LossMetric(loss, weight_by=int(np.asarray(elbo).size)),
            BitsPerDimMetric(elbo, name="elbo (bpx)", reduce_by=x_sl),
            LLMetric(elbo, name="elbo (nats)"),
            LatestMeanMetric(float(mets["beta"]), name="beta"),
            LatestMeanMetric(float(mets["free_nats"]), name="free_nats"),
            LLMetric(log_prob, name="rec (nats)", log_to_console=False),
            BitsPerDimMetric(log_prob, name="rec (bpx)", reduce_by=x_sl),
            KLMetric(kld, name="kl (nats)", log_to_console=False),
            KLMetric(np.asarray(kld) / ln2, name="kl (bpz)", reduce_by=z_sl),
            *klds_nats,
            *klds_bpz,
            *klds_bpx,
        ]

    def split_sequence(self, x, x_sl, length: int):
        """Chunks of a long (numpy) sequence overlapping by the receptive field (``stcn.py:680-694``)."""
        overlap = self.receptive_field * self.n_stack_frames
        length = get_modulo_length(length, stride=self.n_stack_frames)
        mode = "extend" if overlap >= length else "consume"
        return split_sequence(x, x_sl, length=length, overlap=overlap, mode=mode)

    def forward_split(self, x, x_sl, i_split: int, y=None, generator: Optional[torch.Generator] = None):
        return self(x, x_sl, y=y, pad_receptive_field=(i_split == 0), generator=generator)

    def example_inputs(self):
        device = self.causal.Conv1d_0.kernel.device
        T = (self.receptive_field + 8) * self.n_stack_frames
        x = torch.zeros((1, T), dtype=torch.float32, device=device)
        return (x, torch.full((1,), T, dtype=torch.int32, device=device)), {"generator": None}

    # ---- generation ----------------------------------------------------------------------------

    def sample_prior(self, d_cols: List[torch.Tensor], e: torch.Tensor) -> torch.Tensor:
        """Top-down (or bottom-up) prior sampling of one column from the conditioning columns
        ``d_cols`` (one (B, 1, C) a level), ``infer``'s prior branch: ``z_l = mu + sd e_l``, with
        ``e`` (B, 1, sum(latent_size)) holding each level at its ``z_offsets``. Returns the
        decode stack's input column: all z (dense) or z_0."""
        z = [None] * self.n_latents
        for l in self.order:
            cond = self.conditioning_level(l)
            in_p = d_cols[l] if cond is None else torch.cat([d_cols[l], z[cond].to(d_cols[l].dtype)], dim=-1)
            mu, sd = self._head("prior", l)(in_p)
            off = self.z_offsets[l]
            z[l] = mu + sd * e[..., off : off + self.latent_size[l]]
        return torch.cat(z, dim=-1) if self.dense else z[0]

    def _emit(self, params, use_mode: bool, keys: FrameKeys, step: int, frames: int = 1) -> torch.Tensor:
        if use_mode:
            return self.likelihood_module.mode(params)
        return self.likelihood_module.rsample(keys.generator, params, **keys.at(step, frames))

    def _window(self, n_samples: int, x: Optional[torch.Tensor]) -> torch.Tensor:
        """The generation window ``(B, rf, in_channels * n_stack_frames)``: zeros, or the last
        ``rf`` (stacked) frames of the history ``x`` (B or 1, T), left-padded with zeros."""
        device = self.causal.Conv1d_0.kernel.device
        rf, s = self.receptive_field, self.n_stack_frames
        if x is None:
            return torch.zeros((n_samples, rf, self.in_channels * s), dtype=torch.float32, device=device)
        x = x.to(device, torch.float32)
        if x.shape[0] == 1 and n_samples > 1:
            x = x.expand(n_samples, *x.shape[1:])
        if s > 1:
            x, _ = stack_tensor(x, s, axis=1)
        x = x[..., None] if x.ndim == 2 else x
        return F.pad(x[:, -rf:], (0, 0, max(0, rf - x.shape[1]), 0))

    def generate(self, n_samples: int = 1, max_timesteps: int = 100, use_mode_observations: bool = False,
                 x: Optional[torch.Tensor] = None, fast: bool = True, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None, uniforms=None):
        """Ancestral sampling (``stcn.py:376-484``): ``((x (B, frames), x_sl (B,)), SimpleNamespace())``.

        ``x`` (B or 1, T) primes the encoder's window with real audio (zeros otherwise). The
        latent noise ``eps`` (steps, B, sum(latent_size)), each level at its ``z_offsets``, is
        drawn once a generation from ``generator`` unless given; ``uniforms`` (``u_cat (frames,
        B, 10)``, ``u_log (frames, B, 1)``) replace the DMoL sampler's draws (:class:`FrameKeys`),
        so the fast and the windowed path can be compared draw for draw. ``use_mode_observations``
        decodes the DMoL mode (z is still sampled).

        ``fast`` with ``kernel_size == 2`` and one frame a step: the encoder's circular buffers
        are primed by one windowed forward over the history (which also gives frame 0's
        conditioning columns), the decode stack's by one over the all-zero z window; each frame
        then costs one column of both stacks. On the card the frame loop is K12
        (:class:`STCNDecoder`, which raises on a model it does not take), on the CPU
        :meth:`_generate_fast_plain`. Otherwise the windowed path."""
        s = self.n_stack_frames
        device = self.causal.Conv1d_0.kernel.device
        n_steps = max(1, max_timesteps // s) if s > 1 else max_timesteps
        keys = FrameKeys(generator, device, uniforms)
        with torch.no_grad():
            window = self._window(n_samples, x)
            B = window.shape[0]
            if eps is None:
                eps = gaussian_noise(generator, (n_steps, B, sum(self.latent_size)), window)
            eps = eps.to(device, torch.float32)
            if fast and self.kernel_size == 2 and s == 1:
                enc_tails, dec_tails, d_cols0 = self._prime(window)
                if window.is_cuda:
                    x_out = STCNDecoder(self, enc_tails, dec_tails).run(
                        window[:, -1, 0], d_cols0, max_timesteps, eps, keys, use_mode_observations)
                else:
                    x_out = self._generate_fast_plain(window[:, -1:], d_cols0, enc_tails, dec_tails, max_timesteps,
                                                      eps, keys, use_mode_observations)[0]
            else:
                x_out = self._generate_windowed(window, n_steps, eps, keys, use_mode_observations)
        x_sl = torch.full((B,), x_out.shape[1], dtype=torch.int32, device=device)
        return (x_out, x_sl), SimpleNamespace()

    def _generate_windowed(self, window, n_steps: int, eps, keys: FrameKeys, use_mode: bool) -> torch.Tensor:
        """The windowed oracle (``stcn.py:418-484``): every step runs the encoder over the rf
        window (the used skips only), samples the prior top-down, runs the decode stack over the
        ``out_rf`` z window and emits ``n_stack_frames`` frames, which enter the window as one
        stacked frame."""
        s, B = self.n_stack_frames, window.shape[0]
        z_window = torch.zeros((B, self.out_rf, self.z_dec_width), dtype=torch.float32, device=window.device)
        n = self.n_latents
        preds = []
        for step in range(n_steps):
            skips = self.res_stack(self.causal(window, pad_causal=False), skip_size=1, skip_mask=self.skip_mask)
            z_col = self.sample_prior(skips[n - 1 :: n][:n], eps[step][:, None])
            z_window = torch.cat([z_window[:, 1:], z_col], dim=1)
            z_dec = z_window.to(torch.bfloat16) if self.bf16 else z_window
            logits = self.out_upsample(self._skip_sum(self.out_transform(z_dec, skip_size=1)))
            if s > 1:
                logits = logits.reshape(B, s, LIKELIHOOD_FEATURES)
            pred = self._emit(self.likelihood_module(logits), use_mode, keys, step, s)
            preds.append(pred.reshape(B, 1, s))
            window = torch.cat([window[:, 1:], preds[-1]], dim=1)
        return torch.cat(preds, dim=1).reshape(B, -1)

    def _prime(self, window: torch.Tensor):
        """The two primes of fast generation (``stcn.py:535-543``): one windowed forward of the
        encoder (each block's last ``dilation`` input frames, and frame 0's conditioning columns)
        and one of the decode stack over the all-zero z window (each block's last input frame).
        Returns ``(enc_tails, dec_tails, d_cols0)``."""
        n = self.n_latents
        skips, enc_tails = self.res_stack(self.causal(window, pad_causal=False), 1, collect_tails=True,
                                          skip_mask=self.skip_mask)
        z_window0 = torch.zeros((window.shape[0], self.out_rf, self.z_dec_width), dtype=torch.float32,
                                device=window.device)
        z_dec0 = z_window0.to(torch.bfloat16) if self.bf16 else z_window0
        _, dec_tails = self.out_transform(z_dec0, 1, collect_tails=True)
        return enc_tails, dec_tails, skips[n - 1 :: n][:n]

    @staticmethod
    def _block_params(stack: ResidualStack, dtype):
        """Each block's ``(w_oc (2C, 2 half), b_gate (2 half,), w_rs (half, R + S), b_rs (R + S,))``
        in ``dtype``: both taps' ``[tanh | sigmoid]`` columns stacked as one ``[old | h]`` product,
        as JAX's fast step packs them (``stcn.py:549-567``)."""
        out = []
        for b in stack.blocks:
            w_old = torch.cat([b.gate_kernel_t[0], b.gate_kernel_s[0]], dim=-1)
            w_cur = torch.cat([b.gate_kernel_t[1], b.gate_kernel_s[1]], dim=-1)
            out.append((torch.cat([w_old, w_cur], dim=0).to(dtype), torch.cat([b.gate_bias_t, b.gate_bias_s]).to(dtype),
                        b.rs_kernel[0].to(dtype), b.rs_bias.to(dtype)))
        return out

    def _generate_fast_plain(self, x_last, d_cols0, enc_tails, dec_tails, n_frames: int, eps, keys: FrameKeys,
                             use_mode: bool = False, forced: Optional[torch.Tensor] = None):
        """The fast frame loop in plain PyTorch, op for op the JAX step (``stcn.py:586-644``):
        the twin of K12, on the same buffers.

        ``x_last`` (B, 1, 1) is the history's last frame, ``d_cols0`` frame 0's conditioning
        columns from the encoder prime, ``enc_tails`` / ``dec_tails`` the primed buffers. Frame 0
        decodes from ``d_cols0``; frame f >= 1 runs the causal tap on its two previous frames, the
        encoder's blocks over their circular buffers (slot ``(f - 1) % dilation``), the prior and
        the decode stack over its one-column buffers. ``forced`` (B, n_frames), teacher forcing:
        the next frame sees ``forced[:, f]`` as frame f instead of its own. Returns ``(x (B,
        n_frames), z (n_frames, B, Z), params (n_frames, B, 30))``: the frames, each frame's z
        column and its DMoL parameters (logits, locs, clamped log-scales)."""
        dtype = torch.bfloat16 if self.bf16 else torch.float32
        R, half = self.res_channels, self.res_stack.blocks[0].gate_kernel_t.shape[-1]
        enc_w, dec_w = self._block_params(self.res_stack, dtype), self._block_params(self.out_transform, dtype)
        enc_in_k, enc_in_b = self.res_stack.Conv1d_0.kernel[0].to(dtype), self.res_stack.Conv1d_0.bias.to(dtype)
        dec_in_k, dec_in_b = self.out_transform.Conv1d_0.kernel[0].to(dtype), self.out_transform.Conv1d_0.bias.to(dtype)
        ck, cb = self.causal.Conv1d_0.kernel, self.causal.Conv1d_0.bias  # (2, 1, C), (C,)
        enc_bufs = [t.to(dtype, copy=True) for t in enc_tails]
        dec_bufs = [t.to(dtype, copy=True) for t in dec_tails]
        inv_std_block = torch.tensor(math.sqrt(0.5), dtype=dtype)  # JAX's Python constant takes h's dtype
        used = self.used_blocks
        blocks = self.res_stack.blocks
        B = x_last.shape[0]

        def block_step(h, w, old):
            w_oc, b_gate, w_rs, b_rs = w
            gate = torch.cat([old, h], dim=-1) @ w_oc + b_gate
            act = torch.tanh(gate[..., :half]) * torch.sigmoid(gate[..., half:])
            rs = act @ w_rs + b_rs
            return (h + rs[..., :R]) * inv_std_block, rs[..., R:]

        def decode(z_col, f):
            h = z_col.to(dtype) @ dec_in_k + dec_in_b
            acc = torch.zeros((B, 1, R), dtype=torch.float32, device=h.device)
            for i, w in enumerate(dec_w):
                old = dec_bufs[i]
                dec_bufs[i] = h
                h, s_ = block_step(h, w, old)
                acc = acc + at_least_f32(s_)
            params = self.likelihood_module(self.out_upsample(acc * self.inv_std))
            flat = torch.cat([params[0], params[1][..., 0, :], params[2][..., 0, :]], dim=-1)  # (B, 1, 30)
            return self._emit(params, use_mode, keys, f), flat

        def fed(f, pred):
            return pred if forced is None else forced[:, f].reshape(B, 1, 1).to(pred)

        z0 = self.sample_prior(d_cols0, eps[0][:, None])
        pred, raw = decode(z0, 0)
        preds, zs, params = [pred], [z0], [raw]
        prev2, prev1 = x_last, fed(0, pred)
        for f in range(1, n_frames):
            idx = f - 1
            c = prev2 @ ck[0] + prev1 @ ck[1] + cb  # the causal k=2 tap, (B, 1, C), f32
            h = c.to(dtype) @ enc_in_k + enc_in_b
            d_cols = {}
            for i, (w, block) in enumerate(zip(enc_w, blocks)):
                slot = idx % block.dilation
                old = enc_bufs[i][:, slot : slot + 1].clone()
                enc_bufs[i][:, slot : slot + 1] = h
                h, s_ = block_step(h, w, old)
                d_cols[i] = s_
            z_col = self.sample_prior([d_cols[g] for g in used], eps[f][:, None])
            pred, raw = decode(z_col, f)
            preds.append(pred)
            zs.append(z_col)
            params.append(raw)
            prev2, prev1 = prev1, fed(f, pred)
        x_out = torch.cat(preds, dim=1).reshape(B, -1)
        return x_out, torch.cat(zs, dim=1).transpose(0, 1), torch.cat(params, dim=1).transpose(0, 1)
