"""VRNN, the variational recurrent neural network (port of ``blvm_tpu/models/vrnn.py``).

The cell (prior and posterior MLPs with Gaussian heads, ``z = mu + sd eps``, the phi
MLP, a GRU cell) runs over all steps in :func:`blvm_tpu_torch.ops.vrnn.vrnn_cell`:
its plain twin on the CPU, one launch of the K8 kernel on the card, and where a
gradient is needed K8 in save mode and one K8-bwd launch in the backward. As in the JAX
package the scan has no length mask (padding steps run too; only the ELBO masks
them), the decoder reads ``[phi_z, h]`` with ``h`` shifted by one step, and ``h_n`` is
the state *entering* the last step (the reference's stale ``h_n``, ``vrnn.py:226-229``).

:class:`VRNNAudio` stacks ``input_size`` waveform frames a step and always scores them
with a DMoL of 10 mixtures over 2^16 bins, whatever ``num_mix`` and ``num_bins`` say
(``vrnn.py:276-284``). Parameters keep the flax names (``vrnn/cell/prior_mlp/Dense_0/
kernel``, ``vrnn/cell/gru/w_hh``, ``vrnn/encoder/MLP_0/Dense_2/bias``, ...), so JAX trees
load through :mod:`blvm_tpu_torch.weights`. The noise ``eps`` of the latent samples is
drawn by :func:`gaussian_noise` from the caller's ``torch.Generator`` unless given.
"""

import math
from types import SimpleNamespace
from typing import Optional

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
from blvm_tpu_torch.models.elbo import compute_sequence_elbo, masked_strided_sum
from blvm_tpu_torch.modules.common import MLP, leaky_relu
from blvm_tpu_torch.modules.distributions import DiagonalGaussianDense, DiscretizedLogisticMixtureDense
from blvm_tpu_torch.modules.recurrent import GRUCell
from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops import vrnn as vrnn_ops
from blvm_tpu_torch.ops.sequence import stack_tensor
from blvm_tpu_torch.ops.variational import (
    FrameKeys,
    gaussian_noise,
    kl_divergence_gaussian,
    kl_divergence_gaussian_mc,
)


class VRNNCell(nn.Module):
    """One VRNN step's modules (``vrnn.py:46-103``); :meth:`run` runs them over a sequence."""

    def __init__(self, x_dim: int, h_dim: int, z_dim: int, r_dim: Optional[int] = None, condition_h_on_x: bool = True,
                 residual_posterior: bool = False, device=None):
        super().__init__()
        self.r_dim = r_dim or 2 * h_dim
        self.condition_h_on_x, self.residual_posterior = condition_h_on_x, residual_posterior
        R = self.r_dim
        self.prior_mlp = MLP(R, [h_dim] * 3, activation=F.relu, device=device)
        self.prior_head = DiagonalGaussianDense(h_dim, z_dim, device=device)
        self.posterior_mlp = MLP(R + x_dim, [h_dim] * 3, activation=F.relu, device=device)
        self.posterior_head = DiagonalGaussianDense(h_dim, z_dim, device=device)
        self.phi_z_net = MLP(z_dim, [h_dim] * 4, activation=F.relu, device=device)
        self.gru = GRUCell(x_dim + h_dim if condition_h_on_x else h_dim, R, orthogonal_hh=True, device=device)

    def cell_weights(self):
        """The 28 tensors :func:`vrnn_ops.vrnn_cell` takes, in its order."""
        def dense_pairs(mlp):
            return [t for i in range(mlp.n_layers) for t in (getattr(mlp, f"Dense_{i}").kernel,
                                                              getattr(mlp, f"Dense_{i}").bias)]

        return (*dense_pairs(self.prior_mlp), self.prior_head.Dense_0.kernel, self.prior_head.Dense_0.bias,
                *dense_pairs(self.posterior_mlp), self.posterior_head.Dense_0.kernel, self.posterior_head.Dense_0.bias,
                *dense_pairs(self.phi_z_net), self.gru.w_ih, self.gru.b_ih, self.gru.w_hh, self.gru.b_hh)

    def run(self, x: torch.Tensor, h0: torch.Tensor, eps: Optional[torch.Tensor], inference: bool = True,
            use_mode: bool = False) -> vrnn_ops.VRNNCellOutputs:
        """The cell over the steps of ``x (B, T', X)`` from ``h0``: posterior samples
        (``inference``) or prior ones (generation), with the noise ``eps (B, T', Z)``."""
        return vrnn_ops.vrnn_cell(
            self.cell_weights(), x, h0, eps, inference=inference, residual_posterior=self.residual_posterior,
            condition_h_on_x=self.condition_h_on_x, use_mode=use_mode, sd_beta=self.prior_head.beta,
            sd_epsilon=self.prior_head.epsilon,
        )

    def prior_params(self, h):
        return self.prior_head(self.prior_mlp(h))

    def posterior_params(self, h, x):
        return self.posterior_head(self.posterior_mlp(torch.cat([h, x], dim=-1)))

    def phi_z_features(self, z):
        return self.phi_z_net(z)

    def gru_step(self, inputs, h):
        return self.gru(inputs, h)

    def generate_step(self, h: torch.Tensor, x: torch.Tensor, eps: Optional[torch.Tensor], use_mode: bool = False):
        """One prior step (``vrnn.py:94-103``) from ``h (B, R)`` and ``x (B, X)``: one launch of
        K8 in prior mode on the card. Returns ``(h', dict(h=h', z=z, phi_z=phi_z))``."""
        out = self.run(x[:, None], h, None if eps is None else eps[:, None], inference=False, use_mode=use_mode)
        h_new = out.h[:, 0]
        return h_new, dict(h=h_new, z=out.z[:, 0], phi_z=out.phi_z[:, 0])


class VRNN(nn.Module):
    """The sequence-level VRNN with its encoder, decoder and likelihood (``vrnn.py:106-231``)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, likelihood: nn.Module, x_dim: int, h_dim: int,
                 z_dim: int, r_dim: Optional[int] = None, residual_posterior: bool = False,
                 condition_h_on_x: bool = True, condition_x_on_h: bool = True, device=None):
        super().__init__()
        self.encoder, self.decoder, self.likelihood = encoder, decoder, likelihood
        self.z_dim, self.condition_x_on_h = z_dim, condition_x_on_h
        self.cell = VRNNCell(x_dim, h_dim, z_dim, r_dim, condition_h_on_x=condition_h_on_x,
                             residual_posterior=residual_posterior, device=device)
        self.r_dim = self.cell.r_dim

    def forward(self, x: torch.Tensor, x_sl: torch.Tensor, beta=1.0, free_nats=0.0, h0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        """``(loss, mets, outputs)`` as JAX's. ``eps (B, T', Z)`` is the posterior's noise
        (drawn from ``generator`` when None); the reconstruction sample draws from ``generator``."""
        if x.ndim == 2:
            x = x[..., None]
        y = x.detach()
        encoding = self.encoder(x)  # (B, T', X)
        T = x.shape[1]
        stride = math.ceil(T / encoding.shape[1])
        B = x.shape[0]
        h = torch.zeros((B, self.r_dim), dtype=x.dtype, device=x.device) if h0 is None else h0
        if eps is None:
            eps = gaussian_noise(generator, (B, encoding.shape[1], self.z_dim), encoding)
        outs = self.cell.run(encoding, h, eps)

        all_h = torch.cat([h[:, None], outs.h[:, :-1]], dim=1)  # the state entering each step
        dec_in = torch.cat([outs.phi_z, all_h], dim=-1) if self.condition_x_on_h else outs.phi_z
        dec = self.decoder(dec_in)[:, :T]
        parameters = self.likelihood(dec)
        reconstruction, reconstruction_mode = self.likelihood.sample_and_mode(generator, parameters)

        kld = kl_divergence_gaussian(outs.enc_mu, outs.enc_sd, outs.prior_mu, outs.prior_sd)
        # the reference VRNN reports the free-nats-discounted KL (vrnn.py:272-278)
        loss, elbo, log_prob, _, kl, seq_mask = compute_sequence_elbo(self.likelihood, y, parameters, kld, x_sl,
                                                                      stride, beta, free_nats)
        mc_kld = kl_divergence_gaussian_mc(outs.enc_mu, outs.enc_sd, outs.prior_mu, outs.prior_sd, outs.z)
        mc_kl = masked_strided_sum(mc_kld, x_sl, T, stride)

        z_sl = torch.ceil(x_sl / stride).to(torch.int32)
        mets = dict(loss=loss, elbo=elbo, log_prob=log_prob, kl=kl, mc_kl=mc_kl, x_sl=x_sl,
                    beta=torch.as_tensor(beta, dtype=torch.float32), free_nats=torch.as_tensor(free_nats,
                                                                                              dtype=torch.float32))
        outputs = SimpleNamespace(
            elbo=elbo, log_prob=log_prob, kl=kl, y=y, seq_mask=seq_mask, z=outs.z, z_sl=z_sl,
            reconstructions=reconstruction, reconstructions_mode=reconstruction_mode,
            reconstructions_parameters=parameters, h_n=all_h[:, -1],
        )
        return loss, mets, outputs


class VRNNAudio(BaseModel):
    """VRNN over raw waveforms with frame stacking (``vrnn.py:234-361``). Keyword arguments
    and defaults are the flax ``VRNNAudio``'s fields; ``unroll`` only schedules XLA and is
    ignored. Only the DMoL likelihood is ported (GMM and Gaussian raise)."""

    def __init__(self, likelihood: str = "DMoL", input_size: int = 200, hidden_size: int = 256, latent_size: int = 64,
                 r_dim: Optional[int] = None, residual_posterior: bool = False, condition_h_on_x: bool = True,
                 condition_x_on_h: bool = True, num_mix: int = 10, num_bins: int = 256, unroll: int = 1, device=None):
        super().__init__(likelihood=likelihood, input_size=input_size, hidden_size=hidden_size,
                         latent_size=latent_size, r_dim=r_dim, residual_posterior=residual_posterior,
                         condition_h_on_x=condition_h_on_x, condition_x_on_h=condition_x_on_h, num_mix=num_mix,
                         num_bins=num_bins, unroll=unroll)
        if likelihood in ("GMM", "Gaussian"):
            raise NotImplementedError(f"the VRNN's {likelihood} likelihood is not ported to blvm_tpu_torch yet "
                                      "(only DMoL)")
        if likelihood != "DMoL":
            raise ValueError(f"Unknown likelihood type {likelihood}")
        self.input_size, self.hidden_size, self.latent_size = input_size, hidden_size, latent_size
        self.condition_x_on_h = condition_x_on_h
        H, R = hidden_size, r_dim or 2 * hidden_size
        # 2**16 bins and 10 mixtures here, not num_bins / num_mix (reference vrnn.py:468)
        head = DiscretizedLogisticMixtureDense(30, y_dim=1, num_mix=10, num_bins=2**16, device=device)
        self.vrnn = VRNN(
            encoder=_StackedEncoder(input_size, H, device=device),
            decoder=_UnstackingDecoder(H + R if condition_x_on_h else H, H, input_size, 30, device=device),
            likelihood=head, x_dim=H, h_dim=H, z_dim=latent_size, r_dim=r_dim, residual_posterior=residual_posterior,
            condition_h_on_x=condition_h_on_x, condition_x_on_h=condition_x_on_h, device=device,
        )

    def forward(self, x, x_sl, beta=1.0, free_nats=0.0, h0=None, generator=None, eps=None):
        return self.vrnn(x, x_sl, beta, free_nats, h0, generator=generator, eps=eps)

    @staticmethod
    def build_metrics(mets: dict):
        """The reference's metric set (``vrnn.py:346-355``) from host values."""
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
                 x: Optional[torch.Tensor] = None, h0: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None, uniforms=None):
        """Prior rollout over ``max_timesteps`` stacks (``vrnn.py:314-357``): encode the current
        stack, one prior step (one K8 launch on the card), decode the next stack's DMoL
        parameters, and take their mode (``use_mode``) or one sample (one K3 launch), fed back.
        Returns ``((x (B, max_timesteps * input_size, 1), x_sl (B,)), SimpleNamespace())``.

        ``x`` primes the rollout with one ``(B or 1, input_size, 1)`` stack (zeros when None),
        ``h0`` is the initial state (zeros). ``eps (max_timesteps, B, Z)`` replaces the prior's
        noise and ``uniforms`` (``u_cat (n, B, 10)``, ``u_log (n, B, 1)``, ``n`` the frames)
        the DMoL sampler's draws (:class:`FrameKeys`), so two paths can be compared draw for draw.
        """
        S = self.input_size
        device = self.vrnn.cell.gru.w_hh.device
        if x is None:
            x = torch.zeros((n_samples, S, 1), dtype=torch.float32, device=device)
        else:
            x = x.to(device, torch.float32)
            if x.shape[0] == 1 and n_samples > 1:
                x = x.expand(n_samples, *x.shape[1:])
        B = x.shape[0]
        h = torch.zeros((B, self.vrnn.r_dim), dtype=torch.float32, device=device) if h0 is None else h0
        keys = FrameKeys(generator, device, uniforms)
        stacks = []
        with torch.no_grad():
            for step in range(max_timesteps):
                enc = self.vrnn.encoder(x)[:, 0, :]  # one stack, one step
                e = None
                if not use_mode:
                    e = eps[step].to(device) if eps is not None else gaussian_noise(generator, (B, self.latent_size),
                                                                                   enc)
                h, outs = self.vrnn.cell.generate_step(h, enc, e, use_mode=use_mode)
                dec_in = torch.cat([outs["phi_z"], h], dim=-1) if self.condition_x_on_h else outs["phi_z"]
                params = self.vrnn.likelihood(self.vrnn.decoder(dec_in[:, None, :]))
                if use_mode:
                    x = self.vrnn.likelihood.mode(params)
                else:
                    x = self.vrnn.likelihood.rsample(keys.generator, params, **keys.at(step, S))
                stacks.append(x)
        x_out = torch.cat(stacks, dim=1) if stacks else torch.zeros((B, 0, 1), device=device)
        x_sl = torch.full((B,), x_out.shape[1], dtype=torch.int32, device=device)
        if x_out.is_cuda:  # one wait a generation, then any K8 launch that gave up raises
            torch.cuda.current_stream(device).synchronize()
            cuda.raise_on_status()
        return (x_out, x_sl), SimpleNamespace()

    def example_inputs(self):
        device = self.vrnn.cell.gru.w_hh.device
        T = 2 * self.input_size
        x = torch.zeros((1, T), dtype=torch.float32, device=device)
        return (x, torch.full((1,), T, dtype=torch.int32, device=device)), {"generator": None}


class _StackedEncoder(nn.Module):
    """``(B, T, 1)`` -> stacks of ``input_size`` frames (right-padded) -> a 3-layer LeakyReLU MLP
    -> ``(B, T', H)``."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.input_size = input_size
        self.MLP_0 = MLP(input_size, [hidden_size] * 3, activation=leaky_relu, device=device)

    def forward(self, x):
        x, _ = stack_tensor(x.reshape(x.shape[0], -1), self.input_size, axis=1)
        return self.MLP_0(x)


class _UnstackingDecoder(nn.Module):
    """``(B, T', in)`` -> a 3-layer LeakyReLU MLP to ``input_size * out_features`` ->
    ``(B, T' input_size, out_features)``."""

    def __init__(self, in_features: int, hidden_size: int, input_size: int, out_features: int, device=None):
        super().__init__()
        self.input_size, self.out_features = input_size, out_features
        self.MLP_0 = MLP(in_features, [hidden_size, hidden_size, input_size * out_features], activation=leaky_relu,
                         device=device)

    def forward(self, d):
        d = self.MLP_0(d)
        B, Ts, _ = d.shape
        return d.reshape(B, Ts * self.input_size, self.out_features)
