"""The Clockwork-VAE, a hierarchical temporal VAE over raw audio (port of
``blvm_tpu/models/clockwork_vae/clockwork_vae.py``).

Levels run top-down; level ``l`` is its RSSM cell scanned over the level's steps (stride ``prod(strides[:l+1])``),
with the context the decoder-upsampled ``[z, h]`` of the level above (none at the top). Each level's cell runs as
one call of :meth:`blvm_tpu_torch.modules.rssm.RSSMCell.run` (K10 on the card), each coder block's depthwise chain
as one call of K11, the DMoL head's log-likelihood as K2 and its sample as K3. Per-level same paddings keep the
encoder's and the decoder's lengths aligned; the chunked test pass carries every level's ``(z, h)``, taken at each
example's true stop index (``outputs.state_n``).

The latent noise ``eps`` (one ``(B, T_l, z_l)`` tensor a level, top level first) is drawn by :func:`gaussian_noise`
from the caller's ``torch.Generator`` unless given. ``kld_l`` in ``mets`` is one ``(B, levels)`` tensor where JAX
keeps a list. Parameters keep the flax names (``cwvae/encoder/levels_0_0/...``, ``cwvae/cell_0/gru_cell/w_hh``,
``cwvae/likelihood/Dense_0/kernel``), so JAX trees load through :mod:`blvm_tpu_torch.weights`.
"""

import math
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from blvm_tpu_torch.evaluation.metrics import (
    BitsPerDimMetric,
    EMAMetric,
    KLMetric,
    LatestMeanMetric,
    LLMetric,
    LossMetric,
    drop_padded_rows,
)
from blvm_tpu_torch.models.base import BaseModel
from blvm_tpu_torch.models.clockwork_vae.conv_coders import ConvCoder1d
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense
from blvm_tpu_torch.modules.rssm import RSSMCell
from blvm_tpu_torch.ops.likelihoods import at_least_f32
from blvm_tpu_torch.ops.padding import get_modulo_length, get_same_padding, pad_modulo
from blvm_tpu_torch.ops.sequence import sequence_mask, split_sequence
from blvm_tpu_torch.ops.variational import (
    discount_free_nats,
    gaussian_noise,
    kl_divergence_gaussian,
    kl_divergence_gaussian_mc,
)

State = List[Tuple[torch.Tensor, torch.Tensor]]


class CWVAE(nn.Module):
    """``clockwork_vae.py:49-380``: the levels' RSSM cells between a conv encoder and a conv decoder."""

    def __init__(self, z_size: Sequence[int], h_size: Sequence[int], strides: Sequence[int], encoder: ConvCoder1d,
                 decoder: ConvCoder1d, likelihood: nn.Module, g_size: int = 0, residual_posterior: bool = False,
                 precision_posterior: bool = False, with_resets: bool = False, device=None):
        super().__init__()
        self.z_size, self.h_size, self.strides = list(z_size), list(h_size), list(strides)
        self.encoder, self.decoder, self.likelihood = encoder, decoder, likelihood
        self.g_size, self.with_resets = g_size, with_resets
        self.num_levels = len(self.strides)
        self.overall_strides = [int(s) for s in np.cumprod(self.strides)]
        self.overall_stride = self.overall_strides[-1]
        self.overall_receptive_field = encoder.overall_receptive_field
        self.receptive_fields = encoder.receptive_fields
        # context a level: the decoder's hidden of the level above; the top has none
        c_size = list(decoder.e_size[1:]) + [0]
        self.cells: List[RSSMCell] = []
        for l, (h, z, c, e) in enumerate(zip(self.h_size, self.z_size, c_size, encoder.e_size)):
            cell = RSSMCell(z, h, c, e, residual_posterior=residual_posterior,
                            precision_posterior=precision_posterior, device=device)
            self.add_module(f"cell_{l}", cell)
            self.cells.append(cell)

    def compute_elbo(self, y, seq_mask, level_masks, x_sl, parameters, kld_layerwise, beta=1.0, free_nats=0.0):
        """``clockwork_vae.py:89-104``: ``(loss, elbo, log_prob, kld, kld_l)``, the free-nats budget of level ``l``
        scaled by its stride over the bottom level's."""
        log_prob = (self.likelihood.log_prob(y, parameters) * seq_mask).reshape(y.shape[0], -1).sum(dim=1)
        kld_l, klds_fn = [], []
        for l in range(self.num_levels):
            mask = level_masks[l][..., None]
            fn = free_nats * self.overall_strides[l] / self.overall_strides[0]
            kld_l.append((kld_layerwise[l] * mask).sum(dim=(1, 2)))
            klds_fn.append((discount_free_nats(kld_layerwise[l], fn, shared_dims=-1) * mask).sum(dim=(1, 2)))
        kld, kld_fn = sum(kld_l), sum(klds_fn)
        elbo = log_prob - kld
        loss = -(log_prob - beta * kld_fn).sum() / x_sl.sum()
        return loss, elbo, log_prob, kld, kld_l

    def split_sequence(self, x, x_sl, length: int):
        """Chunks overlapping by ``rf - stride`` and wholly strideable (``clockwork_vae.py:108-113``)."""
        length = get_modulo_length(length, self.overall_stride, self.overall_receptive_field)
        return split_sequence(x, x_sl, length=length, overlap=self.overall_receptive_field - self.overall_stride)

    def _same_paddings(self, length: int, generation: bool = False) -> List[int]:
        """Each level's same padding for an input of ``length`` frames (``clockwork_vae.py:193-198``). JAX's
        ``generate`` passes the level's receptive field and stride to ``get_same_padding`` in the other order
        (``:347``), so its decoder crops less; ``generation`` keeps that."""
        paddings = []
        for l in range(self.num_levels):
            n = math.ceil(length / self.strides[l - 1]) if l > 0 else length
            rf, s = self.receptive_fields[l], self.strides[l]
            paddings.append(get_same_padding(n, rf, s) if generation else get_same_padding(n, s, rf))
        return paddings

    def forward(self, x: torch.Tensor, x_sl: torch.Tensor, state0: Optional[State] = None, beta=1.0, free_nats=0.0,
                y: Optional[torch.Tensor] = None, pad_strideable: bool = False, pad_same: bool = True,
                generator: Optional[torch.Generator] = None, eps: Optional[Sequence[torch.Tensor]] = None):
        """``(loss, mets, outputs)`` as JAX's ``__call__`` (``:162-297``). ``eps`` replaces the levels' latent
        noise (a ``(B, T_l, z_l)`` tensor a level, indexed by level); the reconstruction's sample draws from
        ``generator``."""
        if x.ndim == 2:
            x = x[..., None]
        if pad_strideable and not pad_same:
            x = pad_modulo(x, self.overall_stride, self.overall_receptive_field, axis=1)
        if y is None:
            y = x.detach()
        if not pad_same:
            # without same padding the convs consume the tail of x
            same_padding = get_same_padding(x.shape[1], self.overall_stride, self.overall_receptive_field)
            x_sl = torch.clamp(x_sl - same_padding, min=0)
            if same_padding:
                y = y[:, :-same_padding]
        B = x.shape[0]
        seq_mask = sequence_mask(x_sl, max_len=y.shape[1], dtype=torch.float32)
        same_paddings = self._same_paddings(x.shape[1])
        encodings = self.encoder(x, pad_right=same_paddings if pad_same else [0] * self.num_levels)
        encodings = [at_least_f32(e) for e in encodings]
        dtype = encodings[0].dtype
        states = state0 if state0 is not None else [
            (torch.zeros((B, self.z_size[l]), dtype=dtype, device=x.device),
             torch.zeros((B, self.h_size[l]), dtype=dtype, device=x.device)) for l in range(self.num_levels)]

        context = torch.zeros((B, encodings[-1].shape[1], 0), dtype=dtype, device=x.device)
        n = self.num_levels
        kld_l, mc_kld_l, latents, enc_mus, prior_mus = [None] * n, [None] * n, [None] * n, [None] * n, [None] * n
        level_masks, level_sl, next_state0 = [None] * n, [None] * n, [None] * n
        for l in range(n - 1, -1, -1):
            T_l = encodings[l].shape[1] if pad_same else context.shape[1]
            enc_l, ctx_l = encodings[l][:, :T_l], context[:, :T_l]
            resets = None
            if self.with_resets and l < n - 1:
                resets = torch.arange(T_l, device=x.device) % self.strides[l + 1] == 0
            eps_l = eps[l] if eps is not None else gaussian_noise(generator, (B, T_l, self.z_size[l]), enc_l)
            outs = self.cells[l].run(enc_l, ctx_l, *states[l], eps_l, resets)
            z_seq, h_seq = outs.z, outs.h

            # each example's state at its true stop index, for the chunk carry
            sl_l = torch.ceil(x_sl / self.overall_strides[l]).to(torch.int32)
            stop_idx = torch.clamp(sl_l - 1, 0, T_l - 1).long()
            rows = torch.arange(B, device=x.device)
            next_state0[l] = (z_seq[rows, stop_idx], h_seq[rows, stop_idx])
            level_sl[l] = sl_l
            level_masks[l] = sequence_mask(sl_l, max_len=T_l, dtype=torch.float32)
            latents[l], enc_mus[l], prior_mus[l] = z_seq, outs.enc_mu, outs.prior_mu
            kld_l[l] = kl_divergence_gaussian(outs.enc_mu, outs.enc_sd, outs.prior_mu, outs.prior_sd)
            mc_kld_l[l] = (kl_divergence_gaussian_mc(outs.enc_mu, outs.enc_sd, outs.prior_mu, outs.prior_sd, z_seq)
                           * level_masks[l][..., None]).sum(dim=(1, 2))

            # context for the level below: the decoder-upsampled [z, h]
            _, context = self.decoder.forward_level(torch.cat([z_seq, h_seq], dim=-1), level=l,
                                                    pad_right=same_paddings[l])
            context = at_least_f32(context)

        parameters = self.likelihood(context[:, : y.shape[1]])
        reconstruction, reconstruction_mode = self.likelihood.sample_and_mode(generator, parameters)
        loss, elbo, log_prob, kld, kld_l = self.compute_elbo(y, seq_mask, level_masks, x_sl, parameters, kld_l, beta,
                                                             free_nats)
        mets = dict(loss=loss, elbo=elbo, log_prob=log_prob, kld=kld, kld_l=torch.stack(kld_l, dim=1),
                    mc_kl=sum(mc_kld_l), x_sl=x_sl, beta=torch.as_tensor(beta, dtype=torch.float32),
                    free_nats=torch.as_tensor(free_nats, dtype=torch.float32))
        outputs = SimpleNamespace(
            elbo=elbo, log_prob=log_prob, kld=kld, y=y, seq_mask=seq_mask, z=latents, z_sl=level_sl, enc_mus=enc_mus,
            prior_mus=prior_mus, reconstructions=reconstruction, reconstructions_mode=reconstruction_mode,
            reconstructions_parameters=parameters, state_n=next_state0,
        )
        return loss, mets, outputs

    def generate(self, n_samples: int = 1, max_timesteps: int = 100, use_mode_observations: bool = False,
                 state0: Optional[State] = None, generator: Optional[torch.Generator] = None,
                 eps: Optional[Sequence[torch.Tensor]] = None):
        """The top-down prior rollout (``clockwork_vae.py:334-380``): each level's cell in prior mode over the
        context of the level above (one K10 launch a level on the card), its latents sampled (``eps``: a ``(B,
        T_l, z_l)`` tensor a level replaces the noise), ``[z, h]`` decoded into the next context, and the DMoL
        head's mode (``use_mode_observations``) or one sample (one K3 launch) of the bottom context's first
        ``max_timesteps`` frames. Returns ``((x (B, max_timesteps, 1), x_sl (B,)), SimpleNamespace())``."""
        B = n_samples
        device, dtype = self.cells[0].gru_in.kernel.device, self.cells[0].gru_in.kernel.dtype
        states = state0 if state0 is not None else [
            (torch.zeros((B, self.z_size[l]), dtype=dtype, device=device),
             torch.zeros((B, self.h_size[l]), dtype=dtype, device=device)) for l in range(self.num_levels)]
        same_paddings = self._same_paddings(max_timesteps, generation=True)
        context = torch.zeros((B, max_timesteps // self.overall_strides[-1], 0), dtype=dtype, device=device)
        with torch.no_grad():
            for l in range(self.num_levels - 1, -1, -1):
                T_l = context.shape[1]
                eps_l = eps[l] if eps is not None else gaussian_noise(generator, (B, T_l, self.z_size[l]), context)
                outs = self.cells[l].run(None, context, *states[l], eps_l, inference=False)
                _, context = self.decoder.forward_level(torch.cat([outs.z, outs.h], dim=-1), level=l,
                                                        pad_right=same_paddings[l])
                context = at_least_f32(context)
            parameters = self.likelihood(context[:, :max_timesteps])
            if use_mode_observations:
                x = self.likelihood.mode(parameters)
            else:
                x = self.likelihood.sample(generator, parameters)
        x_sl = torch.full((n_samples,), max_timesteps, dtype=torch.int32, device=device)
        return (x, x_sl), SimpleNamespace()


class CWVAEAudio(BaseModel):
    """The Clockwork-VAE over raw waveforms (``clockwork_vae.py:383-539``). Keyword arguments and defaults are the
    flax ``CWVAEAudio``'s fields; ``unroll`` only schedules XLA and is ignored. Only the DMoL likelihood and f32
    coders are ported (GMM, Gaussian and ``bf16`` raise ``NotImplementedError``)."""

    def __init__(self, z_size: Union[int, Sequence[int]] = 64, h_size: Union[int, Sequence[int]] = 128,
                 g_size: int = 0, strides: Sequence[int] = (64, 16, 16), residual_posterior: bool = False,
                 precision_posterior: bool = False, with_resets: bool = False, num_level_layers: int = 3,
                 stride_per_layer: int = 4, likelihood: str = "DMoL", num_mix: int = 10, num_bins: int = 256,
                 bf16: bool = False, unroll: int = 1, device=None):
        super().__init__(z_size=z_size, h_size=h_size, g_size=g_size, strides=tuple(strides),
                         residual_posterior=residual_posterior, precision_posterior=precision_posterior,
                         with_resets=with_resets, num_level_layers=num_level_layers, stride_per_layer=stride_per_layer,
                         likelihood=likelihood, num_mix=num_mix, num_bins=num_bins, bf16=bf16, unroll=unroll)
        if likelihood in ("Gaussian", "GMM"):
            raise NotImplementedError(f"the CW-VAE's {likelihood} likelihood is not ported to blvm_tpu_torch yet "
                                      "(only DMoL)")
        if likelihood != "DMoL":
            raise ValueError(f"Unknown likelihood type {likelihood}")
        if bf16:
            raise NotImplementedError("the CW-VAE's bf16 coders are not ported to blvm_tpu_torch yet (f32 only)")
        self.strides, self.stride_per_layer, self.num_level_layers = tuple(strides), stride_per_layer, num_level_layers
        num_levels = len(self.strides)
        z_sizes = [z_size] * num_levels if isinstance(z_size, int) else list(z_size)
        h_sizes = [h_size] * num_levels if isinstance(h_size, int) else list(h_size)
        if any(h != h_sizes[0] for h in h_sizes):
            raise AssertionError(f"every level takes one hidden size, got {h_sizes}")
        H = h_sizes[0]
        c_size = [h + z + g_size for h, z in zip(h_sizes, z_sizes)]
        encoder = ConvCoder1d(strides=self.strides, channels_in=1, channels=H, kernel_size=5,
                              num_blocks=num_level_layers, stride_per_block=stride_per_layer, transposed=False,
                              device=device)
        decoder = ConvCoder1d(strides=self.strides, channels_in=tuple(c_size), channels=H,
                              channels_out=(H,) + (None,) * (num_levels - 1), kernel_size=5,
                              num_blocks=num_level_layers, stride_per_block=stride_per_layer, transposed=True,
                              device=device)
        head = DiscretizedLogisticMixtureDense(H, y_dim=1, num_mix=num_mix, num_bins=num_bins, device=device)
        self.cwvae = CWVAE(z_sizes, h_sizes, self.strides, encoder, decoder, head, g_size=g_size,
                           residual_posterior=residual_posterior, precision_posterior=precision_posterior,
                           with_resets=with_resets, device=device)

    @property
    def overall_receptive_field(self) -> int:
        return ConvCoder1d.level_geometry(self.strides, 5, self.stride_per_layer, self.num_level_layers)[2][-1]

    @property
    def overall_stride(self) -> int:
        return int(np.prod(self.strides))

    def split_sequence(self, x, x_sl, length: int):
        """``(chunks, chunk_lengths)``: chunks of ``length`` made wholly strideable, overlapping by ``rf -
        stride`` (``clockwork_vae.py:467-470``)."""
        return self.cwvae.split_sequence(x, x_sl, length)

    def forward(self, x, x_sl, state0=None, beta=1.0, free_nats=0.0, pad_strideable: bool = True,
                pad_same: bool = True, y=None, generator=None, eps=None):
        return self.cwvae(x, x_sl, state0, beta, free_nats, y, pad_strideable, pad_same, generator=generator, eps=eps)

    def forward_split(self, x, x_sl, is_last_split: bool, state0=None, beta=1.0, free_nats=0.0, y=None,
                      generator=None, eps=None):
        return self.cwvae(x, x_sl, state0, beta, free_nats, y, pad_strideable=False, pad_same=is_last_split,
                          generator=generator, eps=eps)

    def build_metrics(self, mets: dict):
        """The reference's metric set (``clockwork_vae.py:491-527``) from host values, the EMA of bits/frame and
        each level's KL in nats and in bits per step of its level among them."""
        num_levels = len(self.strides)
        overall_strides = np.cumprod(self.strides)
        mets = drop_padded_rows(mets)
        elbo, log_prob, kld, kld_l = mets["elbo"], mets["log_prob"], mets["kld"], np.asarray(mets["kld_l"])
        x_sl = np.asarray(mets["x_sl"])
        ln2 = math.log(2)
        kld_nats = [KLMetric(kld_l[:, l], name=f"kl_{l} (nats)", log_to_console=False) for l in range(num_levels)]
        kld_bpd = [KLMetric(kld_l[:, l] / ln2, name=f"kl_{l} (bpt)", reduce_by=x_sl / overall_strides[l])
                   for l in range(num_levels)]
        return [
            LossMetric(mets["loss"], weight_by=int(np.asarray(elbo).size)),
            EMAMetric(-np.asarray(elbo) / ln2, name="elbo ema (bpt)", reduce_by=x_sl, weight_by=0.97),
            LLMetric(elbo, name="elbo (nats)"),
            BitsPerDimMetric(elbo, name="elbo (bpt)", reduce_by=x_sl),
            LLMetric(log_prob, name="rec (nats)", log_to_console=False),
            BitsPerDimMetric(log_prob, name="rec (bpt)", reduce_by=x_sl),
            KLMetric(kld, name="kl (nats)", log_to_console=False),
            KLMetric(np.asarray(kld) / ln2, name="kl (bpt)", reduce_by=x_sl / overall_strides[0]),
            *kld_nats,
            *kld_bpd,
            LatestMeanMetric(float(mets["beta"]), name="beta"),
            LatestMeanMetric(float(mets["free_nats"]), name="free_nats"),
        ]

    def generate(self, n_samples: int = 1, max_timesteps: int = 100, use_mode_observations: bool = False,
                 state0=None, generator=None, eps=None):
        return self.cwvae.generate(n_samples=n_samples, max_timesteps=max_timesteps,
                                   use_mode_observations=use_mode_observations, state0=state0, generator=generator,
                                   eps=eps)

    def example_inputs(self):
        device = self.cwvae.cells[0].gru_in.kernel.device
        T = 2 * self.overall_stride
        x = torch.zeros((1, T), dtype=torch.float32, device=device)
        return (x, torch.full((1,), T, dtype=torch.int32, device=device)), {"generator": None}
