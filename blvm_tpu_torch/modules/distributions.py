"""Dense-parameterized distribution heads (port of ``blvm_tpu/modules/distributions.py``).

Ported so far: the DMoL head (WaveNet, LSTMAudio, VRNN) and the diagonal
Gaussian head (the VRNN's latent prior and posterior);
:func:`get_likelihood_head` raises ``NotImplementedError`` for the others.
As in the JAX package, ``forward(x)`` returns the head's parameters and
``log_prob`` / ``rsample`` / ``sample`` / ``mode`` act on them; sampling takes an
explicit ``torch.Generator`` where JAX took a PRNG key.
"""

from typing import Optional

import math

import torch
from torch import nn

from blvm_tpu_torch.modules.common import Dense
from blvm_tpu_torch.ops import likelihoods
from blvm_tpu_torch.ops.variational import (
    dmol_mode,
    dmol_sample_and_mode,
    rsample_discretized_logistic_mixture,
    rsample_gaussian,
)


def sd_beta(initial_sd: float, epsilon: float) -> float:
    """The softplus slope that maps 0 to ``initial_sd`` once ``epsilon`` is added."""
    return math.log(2.0) / (initial_sd - epsilon)


class DiagonalGaussianDense(nn.Module):
    """Diagonal Gaussian head: ``Dense(2 * y_dim)`` split into ``mu`` and a raw scale,
    ``sd = softplus_beta(raw, log 2 / (initial_sd - epsilon)) + epsilon``
    (``blvm_tpu/modules/distributions.py:90-113``)."""

    def __init__(self, in_features: int, y_dim: int, initial_sd: float = 1.0, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.y_dim, self.initial_sd, self.epsilon = y_dim, initial_sd, epsilon
        self.Dense_0 = Dense(in_features, 2 * y_dim, device=device)

    @property
    def beta(self) -> float:
        return sd_beta(self.initial_sd, self.epsilon)

    def forward(self, x: torch.Tensor):
        """Returns ``(mu (*, y_dim), sd (*, y_dim))``."""
        mu, raw = self.Dense_0(x).chunk(2, dim=-1)
        sd = likelihoods.softplus_beta(raw, self.beta)
        if self.epsilon > 0:
            sd = sd + self.epsilon
        return mu, sd

    def log_prob(self, y: torch.Tensor, params, reduce_dim: Optional[int] = None) -> torch.Tensor:
        return likelihoods.gaussian_ll(y, params[0], params[1], epsilon=0, reduce_dim=reduce_dim)

    def rsample(self, generator: Optional[torch.Generator], params, eps: Optional[torch.Tensor] = None):
        return rsample_gaussian(generator, params[0], params[1], eps)

    def mode(self, params) -> torch.Tensor:
        return params[0]


class DiscretizedLogisticMixtureDense(nn.Module):
    """DMoL head: ``Dense(num_mix * (2*y_dim + 1))`` split into mixture logits,
    locations and log-scales, log-scales clamped below at ``log_epsilon``
    (``blvm_tpu/modules/distributions.py:217-248``)."""

    def __init__(self, in_features: int, y_dim: int, num_mix: int = 10, num_bins: int = 256,
                 log_epsilon: float = -7.0, device=None):
        super().__init__()
        self.y_dim, self.num_mix, self.num_bins, self.log_epsilon = y_dim, num_mix, num_bins, log_epsilon
        self.Dense_0 = Dense(in_features, num_mix * (2 * y_dim + 1), device=device)

    def forward(self, x: torch.Tensor):
        """Returns (logit_probs (*, M), locs (*, D, M), log_scales (*, D, M))."""
        params = self.Dense_0(x)
        logit_probs = params[..., : self.num_mix]
        locs_log_scales = params[..., self.num_mix :].reshape(*params.shape[:-1], self.y_dim, 2 * self.num_mix)
        locs, log_scales = locs_log_scales[..., : self.num_mix], locs_log_scales[..., self.num_mix :]
        log_scales = torch.clamp_min(log_scales, self.log_epsilon)
        return logit_probs, locs, log_scales

    def log_prob(self, y: torch.Tensor, params) -> torch.Tensor:
        """Per-frame log-mass ``(*,)``. With ``y_dim == 1`` (WaveNet) this goes
        through :func:`likelihoods.dmol_log_prob`, i.e. the K2 kernel on CUDA."""
        if self.y_dim == 1:
            return likelihoods.dmol_log_prob(y, *params, num_bins=self.num_bins)
        return likelihoods.discretized_logistic_mixture_ll(y, *params, num_bins=self.num_bins)

    def rsample(self, generator: Optional[torch.Generator], params, uniforms=None, seed=None, step: int = 0):
        """A sample ``(*, D)``. CPU tensors: the plain twin, reparameterized (autograd
        gives its gradient). CUDA tensors with ``y_dim == 1`` (WaveNet): one launch of
        K3 (:func:`dmol_sample_and_mode`, its ``uniforms`` / ``seed`` / ``step``), which
        has no backward, so parameters that need a gradient raise."""
        if self.y_dim == 1 and params[0].is_cuda:
            if torch.is_grad_enabled() and any(p.requires_grad for p in params):
                raise ValueError("DMoL rsample on CUDA runs the K3 kernel, which has no backward: "
                                 "sample under torch.no_grad() or from detached parameters")
            return dmol_sample_and_mode(generator, *params, uniforms=uniforms, seed=seed, step=step)[0]
        return rsample_discretized_logistic_mixture(generator, *params, uniforms=uniforms)

    def sample(self, generator: Optional[torch.Generator], params) -> torch.Tensor:
        return self.sample_and_mode(generator, params)[0]

    def mode(self, params) -> torch.Tensor:
        """Location of the most probable component, ``(*, D)``."""
        logit_probs, locs, _ = params
        return dmol_mode(logit_probs, locs)

    def sample_and_mode(self, generator: Optional[torch.Generator], params):
        """``(sample, mode)``, each ``(*, D)``, without gradient. With ``y_dim == 1``
        (WaveNet) this goes through :func:`dmol_sample_and_mode`, i.e. one launch
        of the K3 kernel on CUDA."""
        if self.y_dim == 1:
            return dmol_sample_and_mode(generator, *params)
        with torch.no_grad():
            return self.rsample(generator, params), self.mode(params)


def get_likelihood_head(name: str, in_features: int, y_dim: int, num_mix: int = 10, num_bins: int = 256,
                        device=None, **kwargs) -> nn.Module:
    """Build a likelihood head from its string name, as ``blvm_tpu`` does."""
    name_l = name.lower()
    if name_l in ("dmol", "discretized_logistic_mixture"):
        return DiscretizedLogisticMixtureDense(in_features, y_dim=y_dim, num_mix=num_mix, num_bins=num_bins,
                                               device=device, **kwargs)
    if name_l == "gaussian":
        return DiagonalGaussianDense(in_features, y_dim=y_dim, device=device, **kwargs)
    if name_l in ("dl", "discretized_logistic", "gmm", "gaussian_mixture", "categorical", "bernoulli"):
        raise NotImplementedError(f"likelihood {name!r} is not ported to blvm_tpu_torch yet (only DMoL and Gaussian)")
    raise ValueError(f"Unknown likelihood {name!r}")
