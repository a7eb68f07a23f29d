"""SRNN, the stochastic recurrent neural network (port of ``blvm_tpu/models/srnn.py``).

A forward GRU ``d`` runs over the shifted input encoding (``u_0 = 0``, ``u_t = enc(x_{t-1})``)
and its outputs are shifted again (``d = [d_0, d_out[:, :-1]]``); smoothing runs a second GRU
``a`` over the full flip of ``[x_enc, d]`` under the flipped mask (its zeros leading), or a
LeakyReLU MLP without smoothing; the latent chain draws ``z_t`` from the posterior on
``[a_t, z_{t-1}]`` (the prior on ``[d_t, z_{t-1}]``); the decoder reads ``[z, d]``. Both GRUs
run :func:`blvm_tpu_torch.ops.recurrent.gru_recurrence` (K7 on the card; K7-bwd in the
backward) after one time-parallel input product; the chain runs
:func:`blvm_tpu_torch.ops.srnn.srnn_chain` (K9 on the card; K9-bwd in the backward) after the
hoisted products. As in the JAX package the chain has no mask (the
padding steps run too, so ``z_n`` is z after all T' steps), ``d_n`` is the d GRU's state
frozen at each length, and the reported ``kl`` is the true KL, not the free-nats-discounted one.

``gated_stochastic_transfer`` and ``use_phi_z``, fields of the JAX ``SRNN`` that
``SRNNAudio`` never sets, run a plain step loop on CPU tensors and raise on the card.

:class:`SRNNAudio` stacks ``input_size`` waveform frames a step and always scores them with a
DMoL of 10 mixtures over 2^16 bins, whatever ``num_mix`` and ``num_bins`` say
(``srnn.py:320-324``). Parameters keep the flax names (``srnn/d_forward_recurrent/w_hh``,
``srnn/step/prior_net/layers_0/Dense_0/kernel``, ``srnn/step/prior_net/layers_1/Dense_0/bias``,
...), so JAX trees load through :mod:`blvm_tpu_torch.weights`. The latent noise ``eps`` is
drawn by :func:`gaussian_noise` from the caller's ``torch.Generator`` unless given.
"""

import math
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
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
from blvm_tpu_torch.models.elbo import compute_sequence_elbo, masked_strided_sum
from blvm_tpu_torch.models.vrnn import _StackedEncoder, _UnstackingDecoder
from blvm_tpu_torch.modules.common import MLP, leaky_relu
from blvm_tpu_torch.modules.distributions import DiagonalGaussianDense, DiscretizedLogisticMixtureDense
from blvm_tpu_torch.modules.recurrent import GRU, GRUCell
from blvm_tpu_torch.ops import srnn as srnn_ops
from blvm_tpu_torch.ops.padding import get_modulo_length
from blvm_tpu_torch.ops.sequence import sequence_mask, split_sequence
from blvm_tpu_torch.ops.variational import (
    FrameKeys,
    gaussian_noise,
    kl_divergence_gaussian,
    kl_divergence_gaussian_mc,
)


class _GaussianNet(nn.Module):
    """flax's ``nn.Sequential([MLP([H] * 3), DiagonalGaussianDense(Z)])`` under its names
    ``layers_0`` and ``layers_1``: ``forward(h) -> (mu, sd)``."""

    def __init__(self, in_features: int, h_dim: int, z_dim: int, device=None):
        super().__init__()
        self.layers_0 = MLP(in_features, [h_dim] * 3, activation=leaky_relu, device=device)
        self.layers_1 = DiagonalGaussianDense(h_dim, z_dim, device=device)

    def forward(self, h):
        return self.layers_1(self.layers_0(h))

    def weights(self):
        mlp, head = self.layers_0, self.layers_1.Dense_0
        return [t for i in range(3) for t in (getattr(mlp, f"Dense_{i}").kernel, getattr(mlp, f"Dense_{i}").bias)] + [
            head.kernel, head.bias]


class _SRNNStep(nn.Module):
    """The latent chain's modules (``srnn.py:46-108``); :meth:`run` runs them over a sequence."""

    def __init__(self, h_dim: int, z_dim: int, r_dim: int, use_phi_z: bool = False,
                 gated_stochastic_transfer: bool = False, residual_posterior: bool = False, device=None):
        super().__init__()
        self.r_dim = r_dim
        self.use_phi_z, self.gated = use_phi_z, gated_stochastic_transfer
        self.residual_posterior = residual_posterior
        z_feat = h_dim if use_phi_z else z_dim
        net_in = r_dim if gated_stochastic_transfer else r_dim + z_feat
        self.prior_net = _GaussianNet(net_in, h_dim, z_dim, device=device)
        self.posterior_net = _GaussianNet(net_in, h_dim, z_dim, device=device)
        if use_phi_z:
            self.phi_z = MLP(z_dim, [h_dim] * 4, activation=leaky_relu, device=device)
        if gated_stochastic_transfer:
            self.gru_cell = GRUCell(r_dim + z_feat, r_dim, device=device)

    def chain_weights(self):
        """The 16 tensors :func:`srnn_ops.hoist` takes, in its order."""
        return (*self.prior_net.weights(), *self.posterior_net.weights())

    def run(self, d: torch.Tensor, a: Optional[torch.Tensor], z0: torch.Tensor, eps: Optional[torch.Tensor],
            inference: bool = True, use_mode: bool = False, h_p0: Optional[torch.Tensor] = None,
            h_q0: Optional[torch.Tensor] = None) -> Tuple[srnn_ops.SRNNChainOutputs, torch.Tensor, Optional[torch.Tensor]]:
        """The chain over the steps of ``d (B, T', R)`` and ``a`` (None in prior mode) from
        ``z0 (B, Z)`` with the noise ``eps (B, T', Z)``: ``(outputs, h_p_n, h_q_n)``. Ungated,
        ``h_p_n`` and ``h_q_n`` are the last step's inputs ``[d_{T'-1}, z_{T'-2}]`` and
        ``[a_{T'-1}, z_{T'-2}]`` (``z0`` for ``z_{-1}``); gated, the transfer GRU's states."""
        if self.use_phi_z or self.gated:
            return self._run_plain(d, a, z0, eps, inference, use_mode, h_p0, h_q0)
        xp, xq, kernel_weights = srnn_ops.hoist(self.chain_weights(), d, a, inference)
        head = self.prior_net.layers_1
        outs = srnn_ops.srnn_chain(kernel_weights, xp, xq, z0, eps, inference=inference,
                                   residual_posterior=self.residual_posterior, use_mode=use_mode, sd_beta=head.beta,
                                   sd_epsilon=head.epsilon)
        z_prev = outs.z[:, -2] if outs.z.shape[1] > 1 else z0
        h_q_n = torch.cat([a[:, -1], z_prev], dim=-1) if inference else None
        return outs, torch.cat([d[:, -1], z_prev], dim=-1), h_q_n

    def _run_plain(self, d, a, z0, eps, inference, use_mode, h_p0, h_q0):
        """The JAX step op for op with ``phi_z`` or the gated transfer (``srnn.py:68-108``), one
        step at a time; no kernel runs these (ROADMAP.md Queue 1 item 9)."""
        if d.is_cuda:
            raise NotImplementedError("the SRNN's gated stochastic transfer and use_phi_z have no kernel on the card "
                                      "yet (ROADMAP.md Queue 1 item 9); K9 runs the ungated chain without phi_z")
        B = d.shape[0]
        z, steps = z0, []
        h_p = torch.zeros((B, self.r_dim), dtype=d.dtype) if h_p0 is None else h_p0
        h_q = torch.zeros((B, self.r_dim), dtype=d.dtype) if h_q0 is None else h_q0
        for t in range(d.shape[1]):
            z_feat = self.phi_z(z) if self.use_phi_z else z
            if self.gated:
                h_p = self.gru_cell(torch.cat([d[:, t], z_feat], dim=-1), h_p)
                h_q = self.gru_cell(torch.cat([a[:, t], z_feat], dim=-1), h_q) if inference else None
            else:
                h_p = torch.cat([d[:, t], z_feat], dim=-1)
                h_q = torch.cat([a[:, t], z_feat], dim=-1) if inference else None
            prior_mu, prior_sd = self.prior_net(h_p)
            enc_mu = enc_sd = None
            if inference:
                enc_mu, enc_sd = self.posterior_net(h_q)
                if self.residual_posterior:
                    enc_mu = enc_mu + prior_mu
                z = enc_mu + enc_sd * eps[:, t]
            else:
                z = prior_mu if use_mode else prior_mu + prior_sd * eps[:, t]
            steps.append((z, enc_mu, enc_sd, prior_mu, prior_sd))
        outs = srnn_ops.SRNNChainOutputs(*(torch.stack(s, dim=1) if s[0] is not None else None for s in zip(*steps)))
        return outs, h_p, h_q

    def prior_step(self, z: torch.Tensor, d_in: torch.Tensor, d_t: torch.Tensor, eps: Optional[torch.Tensor],
                   use_mode: bool = False) -> torch.Tensor:
        """One prior step of a generation (``srnn.py:98-108``) from the carry ``(z (B, Z), d_in
        (B, R))`` and the step's ``d_t``: one launch of K9 in prior mode on the card. Returns the
        new ``z``; the gated transfer's state starts from ``d_in``, as JAX's carry has it."""
        outs, _, _ = self.run(d_t[:, None], None, z, None if eps is None else eps[:, None], inference=False,
                              use_mode=use_mode, h_p0=d_in)
        return outs.z[:, 0]


class SRNN(nn.Module):
    """The sequence-level SRNN with its encoder, decoder and likelihood (``srnn.py:111-283``)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, likelihood: nn.Module, x_dim: int, h_dim: int,
                 z_dim: int, r_dim: Optional[int] = None, gated_stochastic_transfer: bool = False,
                 use_phi_z: bool = False, dropout: float = 0.0, residual_posterior: bool = False,
                 smoothing: bool = True, device=None):
        super().__init__()
        self.encoder, self.decoder, self.likelihood = encoder, decoder, likelihood
        self.z_dim, self.dropout, self.smoothing = z_dim, dropout, smoothing
        self.r_dim = R = 2 * h_dim if r_dim is None else r_dim
        self.d_forward_recurrent = GRU(x_dim, R, device=device)
        if smoothing:
            self.a_backward_recurrent = GRU(x_dim + R, R, device=device)
        else:
            self.a_mlp = MLP(x_dim + R, [R, R], activation=leaky_relu, device=device)
        self.step = _SRNNStep(h_dim, z_dim, R, use_phi_z=use_phi_z, gated_stochastic_transfer=gated_stochastic_transfer,
                              residual_posterior=residual_posterior, device=device)

    def forward(self, x: torch.Tensor, x_sl: torch.Tensor, u: Optional[torch.Tensor] = None,
                d_0: Optional[torch.Tensor] = None, a_0: Optional[torch.Tensor] = None,
                z_0: Optional[torch.Tensor] = None, h_p_0: Optional[torch.Tensor] = None,
                h_q_0: Optional[torch.Tensor] = None, beta=1.0, free_nats=0.0,
                generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        """``(loss, mets, outputs)`` as JAX's. ``eps (B, T', Z)`` is the posterior's noise (drawn
        from ``generator`` when None); dropout on the decoder's output (whenever ``dropout`` is
        set, as in JAX) and the reconstruction sample draw from ``generator``."""
        if x.ndim == 2:
            x = x[..., None]
        B, T = x.shape[:2]
        y = x.detach()
        x_encoding = self.encoder(x)  # (B, T', D)
        Ts = x_encoding.shape[1]
        stride = math.ceil(T / Ts)
        x_sl_strided = torch.ceil(x_sl / stride).to(torch.int32)
        # u_t = enc(x_{t-1}), zeros first
        u_encoding = torch.cat([torch.zeros_like(x_encoding[:, :1]), x_encoding[:, :-1]], dim=1) if u is None else u
        mask = sequence_mask(x_sl_strided, max_len=Ts, dtype=x.dtype)

        R = self.r_dim
        d_0 = torch.zeros((B, R), dtype=x.dtype, device=x.device) if d_0 is None else d_0
        d_out, d_n = self.d_forward_recurrent(u_encoding, mask=mask, initial_state=d_0)
        d = torch.cat([d_0[:, None], d_out[:, :-1]], dim=1)  # the shift: d_0 first, the last output dropped

        concat = torch.cat([x_encoding, d], dim=-1)
        if self.smoothing:
            # the full flip (srnn.py:180-194): each row's valid frames end up last, the flipped mask's zeros
            # lead, and the GRU holds a_0 until they begin
            a_0 = torch.zeros((B, R), dtype=x.dtype, device=x.device) if a_0 is None else a_0
            a_flip, a_n = self.a_backward_recurrent(concat.flip(1), mask=mask.flip(1), initial_state=a_0)
            a = a_flip.flip(1)
        else:
            a, a_n = self.a_mlp(concat), None

        z_0 = torch.zeros((B, self.z_dim), dtype=x.dtype, device=x.device) if z_0 is None else z_0
        if eps is None:
            eps = gaussian_noise(generator, (B, Ts, self.z_dim), x_encoding)
        outs, h_p_n, h_q_n = self.step.run(d, a, z_0, eps, h_p0=h_p_0, h_q0=h_q_0)
        z = outs.z

        dec = self.decoder(torch.cat([z, d], dim=-1))[:, :T]
        if self.dropout:
            keep = torch.rand(dec.shape, generator=generator, dtype=dec.dtype, device=dec.device) < 1.0 - self.dropout
            dec = torch.where(keep, dec / (1.0 - self.dropout), 0.0)
        parameters = self.likelihood(dec)
        reconstruction, reconstruction_mode = self.likelihood.sample_and_mode(generator, parameters)

        kld = kl_divergence_gaussian(outs.enc_mu, outs.enc_sd, outs.prior_mu, outs.prior_sd)
        # the reference SRNN reports the true KL, not the discounted one (srnn.py:240-244)
        loss, elbo, log_prob, kl, _, seq_mask = compute_sequence_elbo(self.likelihood, y, parameters, kld, x_sl,
                                                                      stride, beta, free_nats)
        mc_kld = kl_divergence_gaussian_mc(outs.enc_mu, outs.enc_sd, outs.prior_mu, outs.prior_sd, z)
        mc_kl = masked_strided_sum(mc_kld, x_sl, T, stride)

        mets = dict(loss=loss, elbo=elbo, log_prob=log_prob, kl=kl, mc_kl=mc_kl, x_sl=x_sl,
                    beta=torch.as_tensor(beta, dtype=torch.float32),
                    free_nats=torch.as_tensor(free_nats, dtype=torch.float32))
        outputs = SimpleNamespace(
            elbo=elbo, log_prob=log_prob, kl=kl, y=y, parameters=parameters, seq_mask=seq_mask, z=z,
            z_sl=x_sl_strided, d_n=d_n, a_n=a_n, z_n=z[:, -1], h_p_n=h_p_n, h_q_n=h_q_n,
            reconstructions=reconstruction, reconstructions_mode=reconstruction_mode,
            reconstructions_parameters=parameters,
        )
        return loss, mets, outputs


class SRNNAudio(BaseModel):
    """SRNN over raw waveforms with frame stacking (``srnn.py:286-410``). Keyword arguments and
    defaults are the flax ``SRNNAudio``'s fields; ``unroll`` only schedules XLA and is ignored.
    Only the DMoL likelihood is ported (GMM and Gaussian raise)."""

    def __init__(self, likelihood: str = "DMoL", input_size: int = 200, hidden_size: int = 256, latent_size: int = 64,
                 dropout: float = 0.0, residual_posterior: bool = False, smoothing: bool = True, num_mix: int = 10,
                 num_bins: int = 256, unroll: int = 1, device=None):
        super().__init__(likelihood=likelihood, input_size=input_size, hidden_size=hidden_size,
                         latent_size=latent_size, dropout=dropout, residual_posterior=residual_posterior,
                         smoothing=smoothing, num_mix=num_mix, num_bins=num_bins, unroll=unroll)
        if likelihood in ("GMM", "Gaussian"):
            raise NotImplementedError(f"the SRNN's {likelihood} likelihood is not ported to blvm_tpu_torch yet "
                                      "(only DMoL)")
        if likelihood != "DMoL":
            raise ValueError(f"Unknown likelihood type {likelihood}")
        self.input_size, self.hidden_size, self.latent_size = input_size, hidden_size, latent_size
        H = hidden_size
        # 2**16 bins and 10 mixtures here, not num_bins / num_mix (reference srnn.py:322)
        head = DiscretizedLogisticMixtureDense(30, y_dim=1, num_mix=10, num_bins=2**16, device=device)
        self.srnn = SRNN(
            encoder=_StackedEncoder(input_size, H, device=device),
            decoder=_UnstackingDecoder(latent_size + 2 * H, H, input_size, 30, device=device),
            likelihood=head, x_dim=H, h_dim=H, z_dim=latent_size, dropout=dropout,
            residual_posterior=residual_posterior, smoothing=smoothing, device=device,
        )

    def split_sequence(self, x, x_sl, length: int):
        """Chunks with no overlap, their lengths made wholly strideable by the stack size
        (``srnn.py:346-350``): ``(chunks, chunk_lengths)`` as :func:`split_sequence` gives them."""
        length = get_modulo_length(length, self.input_size, kernel_size=self.input_size)
        return split_sequence(x, x_sl, length=length, overlap=0)

    def forward(self, x, x_sl, beta=1.0, free_nats=0.0, d_0=None, a_0=None, z_0=None, generator=None, eps=None):
        loss, mets, outputs = self.srnn(x, x_sl, d_0=d_0, a_0=a_0, z_0=z_0, beta=beta, free_nats=free_nats,
                                        generator=generator, eps=eps)
        outputs.x_hat = outputs.reconstructions
        return loss, mets, outputs

    forward_split = forward

    @staticmethod
    def build_metrics(mets: dict):
        """The reference's metric set (``srnn.py:353-365``) from host values."""
        mets = drop_padded_rows(mets)
        elbo, log_prob, kl, x_sl = mets["elbo"], mets["log_prob"], mets["kl"], mets["x_sl"]
        return [
            LossMetric(mets["loss"], weight_by=int(np.asarray(elbo).size)),
            LLMetric(elbo, name="elbo"),
            LLMetric(log_prob, name="rec"),
            KLMetric(kl),
            KLMetric(np.asarray(kl) / math.log(2), name="kl (bpt)", reduce_by=x_sl),
            BitsPerDimMetric(elbo, reduce_by=x_sl),
            LatestMeanMetric(float(mets["beta"]), name="beta"),
            LatestMeanMetric(float(mets["free_nats"]), name="free_nats"),
        ]

    def generate(self, n_samples: int = 1, max_timesteps: int = 100, use_mode: bool = False,
                 x: Optional[torch.Tensor] = None, d_0: Optional[torch.Tensor] = None,
                 z_0: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None, uniforms=None):
        """Prior rollout over ``max_timesteps`` stacks (``srnn.py:367-406``): encode the current
        stack, one step of the d GRU on it (one K7 launch on the card), one prior step from
        ``(z, d)`` with the new ``d_t`` (one K9 launch), decode ``[z, d_t]`` into the next stack's
        DMoL parameters and take their mode (``use_mode``) or one sample (one K3 launch), fed
        back. Starting from ``x = 0`` the first step's input is ``enc(0)``, not the forward's
        zero shift. Returns ``((x (B, max_timesteps * input_size, 1), x_sl (B,)), SimpleNamespace())``.

        ``x`` primes the rollout with one ``(B or 1, input_size, 1)`` stack (zeros when None);
        ``d_0`` and ``z_0`` are the initial states (zeros). ``eps (max_timesteps, B, Z)`` replaces
        the prior's noise and ``uniforms`` (``u_cat (n, B, 10)``, ``u_log (n, B, 1)``, ``n`` the
        frames) the DMoL sampler's draws (:class:`FrameKeys`), so two paths can be compared draw
        for draw.
        """
        S = self.input_size
        srnn = self.srnn
        device = srnn.d_forward_recurrent.w_hh.device
        if x is None:
            x = torch.zeros((n_samples, S, 1), dtype=torch.float32, device=device)
        else:
            x = x.to(device, torch.float32)
            if x.shape[0] == 1 and n_samples > 1:
                x = x.expand(n_samples, *x.shape[1:])
        B = x.shape[0]
        d = torch.zeros((B, srnn.r_dim), dtype=torch.float32, device=device) if d_0 is None else d_0
        z = torch.zeros((B, self.latent_size), dtype=torch.float32, device=device) if z_0 is None else z_0
        keys = FrameKeys(generator, device, uniforms)
        stacks = []
        with torch.no_grad():
            for step in range(max_timesteps):
                d_seq, d_new = srnn.d_forward_recurrent(srnn.encoder(x), initial_state=d)  # one stack, one step
                d_t = d_seq[:, 0]
                e = None
                if not use_mode:
                    e = eps[step].to(device) if eps is not None else gaussian_noise(generator, (B, self.latent_size),
                                                                                   d_t)
                z = srnn.step.prior_step(z, d, d_t, e, use_mode=use_mode)
                params = srnn.likelihood(srnn.decoder(torch.cat([z, d_t], dim=-1)[:, None, :]))
                if use_mode:
                    x = srnn.likelihood.mode(params)
                else:
                    x = srnn.likelihood.rsample(keys.generator, params, **keys.at(step, S))
                d = d_new
                stacks.append(x)
        x_out = torch.cat(stacks, dim=1) if stacks else torch.zeros((B, 0, 1), device=device)
        x_sl = torch.full((B,), x_out.shape[1], dtype=torch.int32, device=device)
        return (x_out, x_sl), SimpleNamespace()

    def example_inputs(self):
        device = self.srnn.d_forward_recurrent.w_hh.device
        T = 2 * self.input_size
        x = torch.zeros((1, T), dtype=torch.float32, device=device)
        return (x, torch.full((1,), T, dtype=torch.int32, device=device)), {"generator": None}
