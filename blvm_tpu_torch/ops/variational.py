"""DMoL sampling (port of the DMoL sampler of ``blvm_tpu/ops/variational.py``).

Where JAX threads a PRNG key, these take an explicit ``torch.Generator`` (on the
tensors' device; ``None`` uses PyTorch's default generator). The two frameworks
draw different numbers from the same seed, so tests compare these samplers by
distribution, or feed them the same uniforms, never bit for bit.

:func:`rsample_discretized_logistic_mixture` is the plain twin;
:func:`dmol_sample_and_mode` is the entry point the DMoL head calls: for CPU
tensors the twin and the plain mode, for CUDA tensors one launch of the
hand-written kernel ``csrc/dmol_sample.cu`` (K3), or it raises.
"""

import math
from typing import Optional, Tuple

import torch

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import at_least_f32, _row_view

CATEGORICAL_EPS, LOGISTIC_EPS = 1e-5, 1e-8


def _uniform(generator: Optional[torch.Generator], like: torch.Tensor, low: float, high: float,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """U[low, high) in ``like``'s shape, dtype and device (``jax.random.uniform``'s
    ``minval + (maxval - minval) * u``), from ``u`` in [0, 1) when given, else drawn."""
    if u is None:
        u = torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)
    return low + (high - low) * u


def _gumbel_argmax(generator: Optional[torch.Generator], logits: torch.Tensor, eps: float,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-max categorical pick ``argmax(logits + G)`` with bounded-uniform Gumbel noise."""
    gumbel = -torch.log(-torch.log(_uniform(generator, logits, eps, 1.0 - eps, u)))
    return torch.argmax(logits + gumbel, dim=-1, keepdim=True)


def rsample_logistic(generator, mu, log_scale, eps: float = LOGISTIC_EPS, u: Optional[torch.Tensor] = None):
    """Reparameterized logistic sample: ``mu + s * (log u - log(1-u))``."""
    u = _uniform(generator, mu, eps, 1.0 - eps, u)
    return mu + torch.exp(log_scale) * (torch.log(u) - torch.log(1.0 - u))


def rsample_discretized_logistic(generator, mu, log_scale, eps: float = LOGISTIC_EPS, u: Optional[torch.Tensor] = None):
    """Continuous logistic sample clamped to [-1, 1] (no further quantization)."""
    return torch.clamp(rsample_logistic(generator, mu, log_scale, eps, u), -1.0, 1.0)


def rsample_discretized_logistic_mixture(generator, logit_probs, locs, log_scales, eps: float = CATEGORICAL_EPS,
                                         uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Sample a DMoL: Gumbel-max component pick, then a clamped logistic sample.

    Args:
        logit_probs: ``(*, M)``; locs/log_scales: ``(*, D, M)``.
        uniforms: optional ``(u_cat (*, M), u_logistic (*, D))`` in [0, 1) to use
            instead of drawing from ``generator`` (the kernel is fed the same).
    Returns ``(*, D)``.
    """
    u_cat, u_logistic = uniforms if uniforms is not None else (None, None)
    argmax = _gumbel_argmax(generator, logit_probs, eps, u_cat)  # (*, 1)
    idx = argmax[..., None, :].expand(*locs.shape[:-1], 1)  # (*, D, 1)
    locs = torch.gather(locs, -1, idx)[..., 0]
    log_scales = torch.gather(log_scales, -1, idx)[..., 0]
    return rsample_discretized_logistic(generator, locs, log_scales, u=u_logistic)


def dmol_mode(logit_probs, locs):
    """Location of the most probable component, ``(*, D)``."""
    idx = logit_probs.argmax(dim=-1, keepdim=True)[..., None, :].expand(*locs.shape[:-1], 1)
    return torch.gather(locs, -1, idx)[..., 0]


def dmol_sample_and_mode(generator: Optional[torch.Generator], logit_probs, locs, log_scales,
                         uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``(sample (*, D), mode (*, D))`` of a DMoL, without gradient.

    CPU tensors: :func:`rsample_discretized_logistic_mixture` and :func:`dmol_mode`.
    CUDA tensors (``D == 1``): one launch of K3, which draws its uniforms from a
    Philox generator keyed from ``generator`` (two int64 drawn on the device, no
    host sync), or takes ``uniforms`` as the twin does.
    """
    if not logit_probs.is_cuda:
        with torch.no_grad():
            return (rsample_discretized_logistic_mixture(generator, logit_probs, locs, log_scales, uniforms=uniforms),
                    dmol_mode(logit_probs, locs))

    lead, M = logit_probs.shape[:-1], logit_probs.shape[-1]
    if locs.shape != (*lead, 1, M) or log_scales.shape != locs.shape:
        raise ValueError(f"dmol_sample kernel takes logit_probs (*, M) and locs/log_scales (*, 1, M); got "
                         f"{tuple(logit_probs.shape)}, {tuple(locs.shape)}, {tuple(log_scales.shape)}")
    tensors = [logit_probs, locs, log_scales]
    if any(t.device != logit_probs.device for t in tensors):
        raise ValueError("dmol_sample: all inputs must lie on one CUDA device")
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in tensors):
        raise TypeError(f"dmol_sample kernel takes float32 or bfloat16, got {[t.dtype for t in tensors]}")
    dev = logit_probs.device
    views = [_row_view(at_least_f32(t.detach()), len(lead)) for t in tensors]
    sample = torch.empty((*lead, 1), dtype=torch.float32, device=dev)
    mode = torch.empty((*lead, 1), dtype=torch.float32, device=dev)
    N = math.prod(lead)
    if N == 0:
        return sample, mode
    if uniforms is None:
        seed, u_cat, u_logistic = torch.randint(0, 2**62, (2,), generator=generator, dtype=torch.int64, device=dev), None, None
    else:
        seed = None
        u_cat, u_logistic = (u.detach().to(dev, torch.float32).contiguous() for u in uniforms)
        if u_cat.shape != logit_probs.shape or u_logistic.shape != (*lead, 1):
            raise ValueError(f"uniforms must be (*, M) and (*, 1), got {tuple(u_cat.shape)}, {tuple(u_logistic.shape)}")
    lib = cuda.library()
    cuda.count_launch("dmol_sample")
    err = lib.blvm_dmol_sample(
        *(t.data_ptr() for t, _ in views), *(t.data_ptr() if t is not None else None for t in (u_cat, u_logistic, seed)),
        sample.data_ptr(), mode.data_ptr(), N, M, *(stride for _, stride in views),
        CATEGORICAL_EPS, (1.0 - CATEGORICAL_EPS) - CATEGORICAL_EPS, LOGISTIC_EPS, (1.0 - LOGISTIC_EPS) - LOGISTIC_EPS,
        cuda.stream_handle(logit_probs),
    )
    cuda.check(err, "dmol_sample")
    return sample, mode
