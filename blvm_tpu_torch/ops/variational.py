"""Variational math: Gaussian KL and free nats, the Gaussian and DMoL samplers
(port of ``blvm_tpu/ops/variational.py``).

Where JAX threads a PRNG key, these take an explicit ``torch.Generator`` (on the
tensors' device; ``None`` uses PyTorch's default generator). The two frameworks
draw different numbers from the same seed, so tests compare these samplers by
distribution, or feed them the same noise, never bit for bit.

:func:`kl_divergence_gaussian`, :func:`kl_divergence_gaussian_mc`,
:func:`discount_free_nats` and :func:`rsample_gaussian` are op for op the JAX
functions. :func:`rsample_discretized_logistic_mixture` is the plain twin of K3;
:func:`dmol_sample_and_mode` is the entry point the DMoL head calls: for CPU
tensors the twin and the plain mode, for CUDA tensors one launch of the
hand-written kernel ``csrc/dmol_sample.cu`` (K3), or it raises.
:class:`FrameKeys` is the sampling stream of one generation, frame by frame.
"""

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import at_least_f32, gaussian_ll, _row_view

CATEGORICAL_EPS, LOGISTIC_EPS = 1e-5, 1e-8
# the affine maps of the kernels' uniforms, (cat_low, cat_scale, logistic_low, logistic_scale): U[eps, 1 - eps)
# as ``_uniform`` computes it, ``low + (high - low) * u``
UNIFORM_MAPS = (CATEGORICAL_EPS, (1.0 - CATEGORICAL_EPS) - CATEGORICAL_EPS, LOGISTIC_EPS, (1.0 - LOGISTIC_EPS) - LOGISTIC_EPS)


def kl_divergence_gaussian(mu_q, sd_q, mu_p, sd_p):
    """Elementwise analytic KL(q || p) between diagonal Gaussians, not reduced."""
    return torch.log(sd_p) - torch.log(sd_q) + (sd_q**2 + (mu_q - mu_p) ** 2) / (2.0 * sd_p**2) - 0.5


def kl_divergence_gaussian_mc(mu_q, sd_q, mu_p, sd_p, z, epsilon: float = 0.0, reduce_dim: Optional[int] = None):
    """Elementwise single-sample Monte Carlo estimate of KL(q || p) at ``z``."""
    return gaussian_ll(z, mu_q, sd_q, epsilon, reduce_dim) - gaussian_ll(z, mu_p, sd_p, epsilon, reduce_dim)


def discount_free_nats(kld: torch.Tensor, free_nats: Optional[float] = None,
                       shared_dims: Union[Sequence[int], int, None] = None) -> torch.Tensor:
    """Free bits: elementwise ``max(kld, budget)``, the budget ``free_nats`` split
    equally over the elements of ``shared_dims`` when given (``free_nats / Z`` per
    element with ``shared_dims=-1``)."""
    if free_nats is None or (isinstance(free_nats, (int, float)) and free_nats == 0):
        return kld
    if isinstance(shared_dims, int):
        shared_dims = (shared_dims,)
    budget = free_nats / math.prod(kld.shape[d] for d in shared_dims) if shared_dims is not None else free_nats
    # the budget as a 0-dim tensor where it is (a host scalar stays on the host: the op reads it there, so a
    # CUDA kld needs no blocking copy); maximum, not clamp_min, splits a tie's gradient 0.5/0.5 as JAX's does
    return torch.maximum(kld, torch.as_tensor(budget, dtype=kld.dtype))


def gaussian_noise(generator: Optional[torch.Generator], shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normal noise of ``shape`` in ``like``'s dtype and device, drawn from ``generator``."""
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def rsample_gaussian(generator: Optional[torch.Generator], mu, sd, eps: Optional[torch.Tensor] = None):
    """Reparameterized Gaussian sample ``mu + sd * eps``, ``eps`` drawn from ``generator`` unless given."""
    if eps is None:
        eps = gaussian_noise(generator, mu.shape, mu)
    return mu + sd * eps


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
                         uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         seed: Optional[torch.Tensor] = None, step: int = 0):
    """``(sample (*, D), mode (*, D))`` of a DMoL, without gradient.

    CPU tensors: :func:`rsample_discretized_logistic_mixture` and :func:`dmol_mode`.
    CUDA tensors (``D == 1``): one launch of K3, which draws its uniforms from a
    Philox generator keyed from ``generator`` (two int64 drawn on the device, no
    host sync), or from ``seed`` (such a key, drawn once for many calls) at
    ``step``, or takes ``uniforms`` as the twin does.
    """
    if seed is not None and not logit_probs.is_cuda:
        raise ValueError("a Philox seed keys the kernel's stream: CUDA tensors only")
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
        if seed is None:
            seed = torch.randint(0, 2**62, (2,), generator=generator, dtype=torch.int64, device=dev)
        elif seed.shape != (2,) or seed.dtype != torch.int64 or seed.device != dev:
            raise ValueError(f"seed must be an int64[2] on {dev}, got {seed.dtype}{tuple(seed.shape)} on {seed.device}")
        u_cat = u_logistic = None
    else:
        seed = None
        u_cat, u_logistic = (u.detach().to(dev, torch.float32).contiguous() for u in uniforms)
        if u_cat.shape != logit_probs.shape or u_logistic.shape != (*lead, 1):
            raise ValueError(f"uniforms must be (*, M) and (*, 1), got {tuple(u_cat.shape)}, {tuple(u_logistic.shape)}")
    lib = cuda.library()
    cuda.count_launch("dmol_sample")
    err = lib.blvm_dmol_sample(
        *(t.data_ptr() for t, _ in views), *(t.data_ptr() if t is not None else None for t in (u_cat, u_logistic, seed)),
        step, sample.data_ptr(), mode.data_ptr(), N, M, *(stride for _, stride in views), *UNIFORM_MAPS,
        cuda.stream_handle(logit_probs),
    )
    cuda.check(err, "dmol_sample")
    return sample, mode


class FrameKeys:
    """The sampling stream of one generation, frame by frame: the port's
    ``jax.random.split(key, n_frames)``.

    With ``uniforms`` (``u_cat (n_frames, B, M)``, ``u_log (n_frames, B, 1)`` in [0, 1))
    frame f samples from their row f, on any device. Otherwise, on CUDA, one Philox
    key (``seed``, a device int64[2]) is drawn once from ``generator`` and frame f
    samples at step f of its stream, so K3 (a frame of the windowed path, or the
    primed first frame) and K4 (a frame of the decode loop) draw the same numbers
    for the same frame; on the CPU frame f draws from ``generator`` in frame order.
    """

    def __init__(self, generator: Optional[torch.Generator], device: torch.device,
                 uniforms: Optional[Sequence[torch.Tensor]] = None):
        self.generator, self.seed, self.uniforms = generator, None, None
        if uniforms is not None:
            u_cat, u_log = (u.detach().to(device, torch.float32).contiguous() for u in uniforms)
            if u_cat.ndim != 3 or u_log.shape != (*u_cat.shape[:2], 1):
                raise ValueError(f"uniforms must be (n_frames, B, M) and (n_frames, B, 1), got "
                                 f"{tuple(u_cat.shape)}, {tuple(u_log.shape)}")
            self.uniforms = (u_cat, u_log)
        elif device.type == "cuda":
            self.seed = torch.randint(0, 2**62, (2,), generator=generator, dtype=torch.int64, device=device)

    def at(self, step: int, frames: int = 1) -> dict:
        """The sampler's keyword arguments for generation step ``step``, which emits
        frames ``step * frames`` to ``(step + 1) * frames - 1``: the uniforms shaped
        as the head's ``(B, frames, M)`` and ``(B, frames, 1)``, or the seed and step."""
        if self.uniforms is not None:
            f0 = step * frames
            return dict(uniforms=tuple(u[f0 : f0 + frames].transpose(0, 1) for u in self.uniforms))
        if self.seed is not None:
            return dict(seed=self.seed, step=step)
        return {}


def precision_weighted_gaussian(mu_1, sd_1, mu_2, sd_2):
    """Two Gaussians fused by their precisions (``blvm_tpu/ops/variational.py:65-72``):
    ``(mu_w, sd_w)``. The precisions are ``1 / (sd * sd)``, as ``sd**-2`` lowers in JAX."""
    pr_1 = 1.0 / (sd_1 * sd_1)
    pr_2 = 1.0 / (sd_2 * sd_2)
    va_w = 1.0 / (pr_1 + pr_2)
    mu_w = va_w * (mu_1 * pr_1 + mu_2 * pr_2)
    return mu_w, torch.sqrt(va_w)
