"""Reparameterized DMoL sampling (port of the DMoL sampler of ``blvm_tpu/ops/variational.py``).

Where JAX threads a PRNG key, these take an explicit ``torch.Generator`` (on the
tensors' device; ``None`` uses PyTorch's default generator). The two frameworks
draw different numbers from the same seed, so tests compare these samplers by
distribution or patch them, never bit for bit. The sampler kernel (K3) is later
work; this is plain PyTorch.
"""

from typing import Optional

import torch


def _uniform(generator: Optional[torch.Generator], like: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """U[low, high) in ``like``'s shape, dtype and device (``jax.random.uniform``'s
    ``minval + (maxval - minval) * u``)."""
    u = torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)
    return low + (high - low) * u


def _gumbel_argmax(generator: Optional[torch.Generator], logits: torch.Tensor, eps: float) -> torch.Tensor:
    """Gumbel-max categorical pick ``argmax(logits + G)`` with bounded-uniform Gumbel noise."""
    u = _uniform(generator, logits, eps, 1.0 - eps)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1, keepdim=True)


def rsample_logistic(generator, mu, log_scale, eps: float = 1e-8):
    """Reparameterized logistic sample: ``mu + s * (log u - log(1-u))``."""
    u = _uniform(generator, mu, eps, 1.0 - eps)
    return mu + torch.exp(log_scale) * (torch.log(u) - torch.log(1.0 - u))


def rsample_discretized_logistic(generator, mu, log_scale, eps: float = 1e-8):
    """Continuous logistic sample clamped to [-1, 1] (no further quantization)."""
    return torch.clamp(rsample_logistic(generator, mu, log_scale, eps), -1.0, 1.0)


def rsample_discretized_logistic_mixture(generator, logit_probs, locs, log_scales, eps: float = 1e-5):
    """Sample a DMoL: Gumbel-max component pick, then a clamped logistic sample.

    Args:
        logit_probs: ``(*, M)``; locs/log_scales: ``(*, D, M)``.
    Returns ``(*, D)``.
    """
    argmax = _gumbel_argmax(generator, logit_probs, eps)  # (*, 1)
    idx = argmax[..., None, :].expand(*locs.shape[:-1], 1)  # (*, D, 1)
    locs = torch.gather(locs, -1, idx)[..., 0]
    log_scales = torch.gather(log_scales, -1, idx)[..., 0]
    return rsample_discretized_logistic(generator, locs, log_scales)
