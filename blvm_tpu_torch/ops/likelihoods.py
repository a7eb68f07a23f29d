"""Log-likelihoods: the Gaussian, and the DMoL's plain PyTorch version and the K2 kernel's wrapper.

Port of the Gaussian and DMoL parts of ``blvm_tpu/ops/likelihoods.py``. All
likelihood math runs in at least float32 whatever the input dtype: bits/frame is
the parity surface, so it never runs in bf16.

:func:`gaussian_ll` is op for op the JAX function (the VRNN's latent heads).
:func:`discretized_logistic_mixture_ll` is the plain twin, op for op the JAX
function. :func:`dmol_log_prob` is the per-frame entry point the WaveNet head
calls: for CPU tensors it runs the twin, for CUDA tensors it launches the
hand-written kernels ``csrc/dmol.cu`` (K2, forward and backward) or raises.
"""

import math
from typing import Optional

import torch

from blvm_tpu_torch.ops import cuda


def reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim``; squeeze instead when that axis has size 1."""
    if x.shape[dim] == 1:
        return x.squeeze(dim)
    return x.sum(dim)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Promote to at least float32 (bf16 -> f32; f32 stays; f64 stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def gaussian_ll(y, mu, sd, epsilon: float = 1e-6, reduce_dim: Optional[int] = -1) -> torch.Tensor:
    """Elementwise Gaussian log-likelihood, reduced over ``reduce_dim`` (None or 0: not reduced).

    ``sd`` is clamped below at ``epsilon`` with a straight-through gradient: the
    clamp moves the value, not the gradient (``blvm_tpu/ops/likelihoods.py:44-56``).
    """
    y, mu, sd = at_least_f32(y), at_least_f32(mu), at_least_f32(sd)
    if epsilon:
        sd = sd + (torch.clamp_min(sd, epsilon) - sd).detach()
    log_prob = -((y - mu) ** 2) / (2.0 * sd**2) - torch.log(sd) - 0.5 * math.log(2.0 * math.pi)
    return reduce(log_prob, reduce_dim) if reduce_dim else log_prob


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``); torch's ``F.softplus`` switches to
    the identity above a threshold and would round differently. ``max(x, 0)`` is written
    ``(x + |x|) / 2`` (the same value) so that autograd's gradient at exactly 0 is JAX's,
    ``sigmoid(0) = 0.5``, not the 1 of ``clamp_min``."""
    return 0.5 * (x + x.abs()) + torch.log1p(torch.exp(-x.abs()))


def softplus_beta(x: torch.Tensor, beta: float) -> torch.Tensor:
    """``softplus(beta x) / beta`` with JAX's softplus: torch's ``Softplus(beta)``, the
    Gaussian heads' calibrated scale (``blvm_tpu/modules/distributions.py:38-40``)."""
    return _softplus(beta * x) / beta


def _dmol_elementwise(y, loc, log_scale, num_bins: int):
    """Per-element discretized-logistic log-mass with the PixelCNN++ edge cases
    (``blvm_tpu/ops/likelihoods.py:_dmol_elementwise``): lowest bin, highest bin,
    and the midpoint pdf where the bin's mass is at most 1e-5."""
    centered_y = y - loc
    inv_stdv = torch.exp(-log_scale)

    half_bin = 1.0 / (num_bins - 1)
    plus_in = inv_stdv * (centered_y + half_bin)
    cdf_plus = torch.sigmoid(plus_in)
    minus_in = inv_stdv * (centered_y - half_bin)
    cdf_minus = torch.sigmoid(minus_in)
    cdf_delta = cdf_plus - cdf_minus

    log_cdf_plus = plus_in - _softplus(plus_in)
    log_one_minus_cdf_minus = -_softplus(minus_in)

    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scale - 2.0 * _softplus(mid_in)
    log_prob_mid_safe = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp_min(cdf_delta, 1e-10)),
        log_pdf_mid - math.log(num_bins / 2.0),
    )

    log_prob = torch.where(y < 2.0 / num_bins - 1.0, log_cdf_plus, log_prob_mid_safe)
    return torch.where(y > 1.0 - 2.0 / num_bins, log_one_minus_cdf_minus, log_prob)


def discretized_logistic_mixture_ll(y, logit_probs, locs, log_scales, num_bins: int = 256, reduce_dim: int = -1):
    """DMoL log-mass, the plain twin of K2.

    Args:
        y: targets ``(*, D)`` in [-1, 1].
        logit_probs: mixture logits ``(*, M)``.
        locs, log_scales: component parameters ``(*, D, M)``.
    Returns ``(*,)``: the data dim reduced per component, then the mixture
    normalized in log space.
    """
    y, logit_probs, locs, log_scales = (at_least_f32(t) for t in (y, logit_probs, locs, log_scales))
    y = y[..., None].expand(*y.shape, logit_probs.shape[-1])
    log_prob = _dmol_elementwise(y, locs, log_scales, num_bins)
    log_prob = reduce(log_prob, reduce_dim - 1)  # reduce data dim per component
    log_prob = log_prob + torch.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_prob, dim=-1)


def dmol_f32_error_bound(y, logit_probs, locs, log_scales, num_bins: int, atol: float = 1e-5) -> torch.Tensor:
    """Per-frame bound on how far two correct float32 implementations of the DMoL
    log-mass may differ, for comparing them (``(*,)``, computed in float64).

    Elementwise float32 math rounds to within a few ulps, and two libms (XLA's
    and PyTorch's, or CUDA's) differ in the last ulp of ``exp`` and ``sigmoid``.
    That moves the result by ``atol`` (1e-5) where the mass is well conditioned,
    but ``cdf_delta = sigmoid(a+) - sigmoid(a-)`` cancels: an ulp of a sigmoid
    near 0.5 (6e-8) is 0.6 % of a ``cdf_delta`` just above its 1e-5 threshold,
    which 2^16 bins reach at ordinary scales. The bound is
    ``atol + 2 u (|lp| + sum_m w_m k_m)``: ``u = 2^-24``, ``w_m`` the mixture
    responsibilities and ``k_m`` each component's condition number on its branch
    of the ladder.
    """
    y, logit_probs, locs, log_scales = (t.detach().to(torch.float64) for t in (y, logit_probs, locs, log_scales))
    y = y[..., None].expand(*y.shape, logit_probs.shape[-1])
    comp = _dmol_elementwise(y, locs, log_scales, num_bins)[..., 0, :] + torch.log_softmax(logit_probs, dim=-1)
    lp = torch.logsumexp(comp, dim=-1)
    w = torch.exp(comp - lp[..., None])

    centered, inv_stdv, half_bin = y - locs, torch.exp(-log_scales), 1.0 / (num_bins - 1)
    plus, minus, mid = inv_stdv * (centered + half_bin), inv_stdv * (centered - half_bin), inv_stdv * centered
    sp, sm = torch.sigmoid(plus), torch.sigmoid(minus)
    delta = sp - sm
    k = torch.where(
        delta > 1e-5,
        (sp + sm + plus.abs() * sp * (1 - sp) + minus.abs() * sm * (1 - sm)) / delta.clamp_min(1e-30),
        1 + 3 * mid.abs() + log_scales.abs(),
    )
    k = torch.where(y < 2.0 / num_bins - 1.0, 1 + plus.abs(), k)
    k = torch.where(y > 1.0 - 2.0 / num_bins, 1 + minus.abs(), k)
    k = (w * k[..., 0, :]).sum(-1) + logit_probs.abs().amax(-1)
    return atol + 2 * 2.0**-24 * (lp.abs() + k)


def dmol_branch_flips(y, locs, log_scales, num_bins: int) -> torch.Tensor:
    """Per-frame ``(*,)`` mask of the frames where a component's ``cdf_delta`` lies
    within float32 rounding (8 ulps of its two sigmoids) of the ladder's 1e-5
    threshold, computed in float64: there two correct float32 implementations
    may take different branches, so comparisons count these frames apart."""
    y, locs, log_scales = (t.detach().to(torch.float64) for t in (y, locs, log_scales))
    centered, inv_stdv, half_bin = y[..., None] - locs, torch.exp(-log_scales), 1.0 / (num_bins - 1)
    sp, sm = torch.sigmoid(inv_stdv * (centered + half_bin)), torch.sigmoid(inv_stdv * (centered - half_bin))
    near = (sp - sm - 1e-5).abs() <= 8 * 2.0**-24 * (sp + sm)
    edge = (y < 2.0 / num_bins - 1.0) | (y > 1.0 - 2.0 / num_bins)  # (*, 1): the bin, not cdf_delta, decides
    return near.flatten(-2).any(-1) & ~edge[..., 0]


def _row_view(t: torch.Tensor, row_dims: int):
    """``(t, row_stride)`` for a tensor whose first ``row_dims`` dims index frames
    and whose remaining elements lie contiguous within a frame. Strided views
    with one uniform frame stride (slices of the head's Dense output) pass as
    they are; anything else is made contiguous."""
    inner = t.shape[row_dims:]
    inner_contiguous = all(
        t.stride(i) == math.prod(inner[i - row_dims + 1 :]) for i in range(row_dims, t.ndim) if t.shape[i] > 1
    )
    rows = [i for i in range(row_dims) if t.shape[i] > 1]
    stride = t.stride(rows[-1]) if rows else math.prod(inner)
    uniform = all(t.stride(a) == t.stride(b) * t.shape[b] for a, b in zip(rows, rows[1:]))
    if not (inner_contiguous and uniform):
        t = t.contiguous()
        stride = math.prod(inner)
    return t, stride


def dmol_log_prob(y, logit_probs, locs, log_scales, num_bins: int) -> torch.Tensor:
    """Per-frame DMoL log-mass ``(*,)`` in f32 for ``y (*, 1)``, ``logit_probs
    (*, M)`` and ``locs``/``log_scales (*, 1, M)`` as the head returns them.

    CPU tensors: the plain twin. CUDA tensors: :class:`DMoLLogProbFunction`, the
    K2 kernels (``csrc/dmol.cu``, forward and backward). The kernels give ``y``
    no gradient (the model detaches its targets) and refuse a ``y`` that wants one.
    """
    if not y.is_cuda:
        return discretized_logistic_mixture_ll(y, logit_probs, locs, log_scales, num_bins=num_bins)

    lead = logit_probs.shape[:-1]
    M = logit_probs.shape[-1]
    if y.shape != (*lead, 1) or locs.shape != (*lead, 1, M) or log_scales.shape != locs.shape:
        raise ValueError(
            "dmol_log_prob kernel takes y (*, 1), logit_probs (*, M), locs/log_scales (*, 1, M); got "
            f"{tuple(y.shape)}, {tuple(logit_probs.shape)}, {tuple(locs.shape)}, {tuple(log_scales.shape)}"
        )
    tensors = [y, logit_probs, locs, log_scales]
    if any(t.device != y.device for t in tensors):
        raise ValueError("dmol_log_prob: all inputs must lie on one CUDA device")
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in tensors):
        raise TypeError(f"dmol_log_prob kernel takes float32 or bfloat16, got {[t.dtype for t in tensors]}")
    if y.requires_grad:
        raise ValueError("dmol_log_prob kernel gives the targets no gradient: pass y detached")
    return DMoLLogProbFunction.apply(*(at_least_f32(t) for t in tensors), num_bins)


class DMoLLogProbFunction(torch.autograd.Function):
    """K2 under autograd: the forward kernel, and a backward kernel that
    recomputes each frame's components and writes the gradients of the logits,
    locs and log-scales (those autograd of the twin's where-ladder gives).
    Arguments were checked by :func:`dmol_log_prob`; all are f32."""

    @staticmethod
    def forward(ctx, y, logit_probs, locs, log_scales, num_bins: int):
        lead, M = logit_probs.shape[:-1], logit_probs.shape[-1]
        out = torch.empty(lead, dtype=torch.float32, device=y.device)
        ctx.save_for_backward(y, logit_probs, locs, log_scales)
        ctx.num_bins = num_bins
        N = math.prod(lead)
        if N == 0:
            return out
        views = [_row_view(t, len(lead)) for t in (y, logit_probs, locs, log_scales)]
        lib = cuda.library()
        cuda.count_launch("dmol_log_prob")
        err = lib.blvm_dmol_log_prob(
            *(t.data_ptr() for t, _ in views), out.data_ptr(), N, M, *(stride for _, stride in views), num_bins,
            cuda.stream_handle(y),
        )
        cuda.check(err, "dmol_log_prob")
        return out

    @staticmethod
    def backward(ctx, g):
        y, logit_probs, locs, log_scales = ctx.saved_tensors
        lead, M = logit_probs.shape[:-1], logit_probs.shape[-1]
        grads = [torch.empty(t.shape, dtype=torch.float32, device=y.device) for t in (logit_probs, locs, log_scales)]
        N = math.prod(lead)
        if N == 0:
            return None, *grads, None
        views = [_row_view(t, len(lead)) for t in (y, logit_probs, locs, log_scales)]
        g = g.to(torch.float32).contiguous()
        lib = cuda.library()
        cuda.count_launch("dmol_log_prob_bwd")
        err = lib.blvm_dmol_log_prob_bwd(
            *(t.data_ptr() for t, _ in views), g.data_ptr(), *(t.data_ptr() for t in grads), N, M,
            *(stride for _, stride in views), ctx.num_bins, cuda.stream_handle(y),
        )
        cuda.check(err, "dmol_log_prob_bwd")
        return None, *grads, None
