"""The sequence ELBO of the recurrent latent-variable models (port of ``blvm_tpu/models/elbo.py``).

The masked log-likelihood summed over time, the KL masked at the encoder's
stride, the free-nats floor shared across the latent dim, and the loss
``-(log p - beta KL_fn) / sum(x_sl)``.
"""

import torch

from blvm_tpu_torch.ops.sequence import sequence_mask
from blvm_tpu_torch.ops.variational import discount_free_nats


def _kl_mask(x_sl: torch.Tensor, max_len: int, stride: int, steps: int) -> torch.Tensor:
    """``(B, T', 1)``: the frame mask taken at every ``stride``-th frame, cut to ``steps``."""
    seq_mask = sequence_mask(x_sl, max_len=max_len, dtype=torch.float32)
    return seq_mask[:, ::stride, None][:, :steps]


def compute_sequence_elbo(likelihood, y, parameters, kld_twise, x_sl, stride: int, beta=1.0, free_nats=0.0):
    """``(loss, elbo, log_prob, kld, kld_fn, seq_mask)``, the per-example values ``(B,)``:
    ``kld`` the true KL, ``kld_fn`` the free-nats-discounted KL the loss uses (the VRNN
    reports ``kld_fn`` as its ``kl``). ``likelihood.log_prob(y, parameters)`` gives the
    per-frame log-likelihood ``(B, T)`` of ``y (B, T, D)``."""
    T = y.shape[1]
    seq_mask = sequence_mask(x_sl, max_len=T, dtype=torch.float32)
    log_prob = (likelihood.log_prob(y, parameters) * seq_mask).reshape(y.shape[0], -1).sum(dim=1)

    seq_mask_kl = _kl_mask(x_sl, T, stride, kld_twise.shape[1])
    kld = (kld_twise * seq_mask_kl).sum(dim=(1, 2))
    elbo = log_prob - kld

    kld_fn = (discount_free_nats(kld_twise, free_nats, shared_dims=-1) * seq_mask_kl).sum(dim=(1, 2))
    loss = -(log_prob - beta * kld_fn).sum() / x_sl.sum()
    return loss, elbo, log_prob, kld, kld_fn, seq_mask


def masked_strided_sum(kld_twise: torch.Tensor, x_sl: torch.Tensor, max_len: int, stride: int) -> torch.Tensor:
    """A latent quantity ``(B, T', Z)`` summed over time and the latent dim under the
    ELBO's KL mask, ``(B,)``."""
    return (kld_twise * _kl_mask(x_sl, max_len, stride, kld_twise.shape[1])).sum(dim=(1, 2))
