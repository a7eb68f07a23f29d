"""The RSSM cell, the per-level recurrent core of the Clockwork-VAE (port of ``blvm_tpu/modules/rssm.py``).

A GRU state transition on ``ReLU(Dense([z, context]))``, 3-layer ReLU MLP prior and posterior heads (the posterior
on ``[h_new, enc]``), and a residual or precision-weighted posterior. Parameters keep the flax names
(``gru_in/kernel``, ``gru_cell/w_hh``, ``prior_mlp/Dense_0/kernel``, ``posterior_head/Dense_0/bias``, ...); the
GRU cell's parameters are all U(-1/sqrt(H), 1/sqrt(H)), ``w_hh`` too (no orthogonal draw). :meth:`RSSMCell.run`
scans the cell over a level's steps: :func:`blvm_tpu_torch.ops.rssm.rssm_chain` after the hoisted products (K10 on
the card).
"""

from typing import Optional

import torch
from torch import nn

from blvm_tpu_torch.modules.common import MLP, Dense
from blvm_tpu_torch.modules.distributions import DiagonalGaussianDense
from blvm_tpu_torch.modules.recurrent import GRUCell
from blvm_tpu_torch.ops import rssm as rssm_ops


class RSSMCell(nn.Module):
    def __init__(self, z_dim: int, h_dim: int, c_dim: int, e_dim: int, residual_posterior: bool = False,
                 precision_posterior: bool = False, device=None):
        super().__init__()
        self.z_dim, self.h_dim, self.c_dim, self.e_dim = z_dim, h_dim, c_dim, e_dim
        self.residual_posterior, self.precision_posterior = residual_posterior, precision_posterior
        self.gru_in = Dense(z_dim + c_dim, h_dim, device=device)
        self.gru_cell = GRUCell(h_dim, h_dim, device=device)
        self.prior_mlp = MLP(h_dim, [h_dim] * 3, activation=torch.relu, device=device)
        self.prior_head = DiagonalGaussianDense(h_dim, z_dim, device=device)
        self.posterior_mlp = MLP(h_dim + e_dim, [h_dim] * 3, activation=torch.relu, device=device)
        self.posterior_head = DiagonalGaussianDense(h_dim, z_dim, device=device)

    def chain_weights(self):
        """The 22 tensors :func:`rssm_ops.hoist` takes, in its order: gru_in's kernel and bias, the GRU's four,
        the prior MLP's three (kernel, bias) pairs and its head's, then the posterior's."""
        g = self.gru_cell
        out = [self.gru_in.kernel, self.gru_in.bias, g.w_ih, g.b_ih, g.w_hh, g.b_hh]
        for mlp, head in ((self.prior_mlp, self.prior_head), (self.posterior_mlp, self.posterior_head)):
            for i in range(3):
                dense = getattr(mlp, f"Dense_{i}")
                out += [dense.kernel, dense.bias]
            out += [head.Dense_0.kernel, head.Dense_0.bias]
        return out

    def run(self, enc: Optional[torch.Tensor], context: torch.Tensor, z0: torch.Tensor, h0: torch.Tensor,
            eps: Optional[torch.Tensor], resets: Optional[torch.Tensor] = None, inference: bool = True,
            use_mode: bool = False) -> rssm_ops.RSSMChainOutputs:
        """The cell over the steps of ``context (B, T', c_dim)`` (and ``enc (B, T', e_dim)``; None in prior mode)
        from ``(z0, h0)`` with the noise ``eps (B, T', Z)``: posterior steps (``__call__``, ``rssm.py:46-62``)
        or, with ``inference=False``, prior steps (``generate``, ``:64-71``), z the prior's mean under
        ``use_mode``. ``resets`` (``(T',)`` bools): the steps that start from zeros."""
        xg, xq, kernel_weights = rssm_ops.hoist(self.chain_weights(), enc, context, inference)
        head = self.prior_head
        return rssm_ops.rssm_chain(kernel_weights, xg, xq, z0, h0, eps, resets, inference=inference,
                                   residual_posterior=self.residual_posterior,
                                   precision_posterior=self.precision_posterior, use_mode=use_mode, sd_beta=head.beta,
                                   sd_epsilon=head.epsilon)
