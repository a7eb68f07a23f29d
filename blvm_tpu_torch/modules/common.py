"""Shared NN building blocks, Dense and MLP (port of ``blvm_tpu/modules/common.py``).

Parameters keep the flax names and layouts: ``kernel`` is ``(in, out)`` and
``bias`` is ``(out,)``, so JAX parameter trees load without transposes.
"""

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def leaky_relu(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu`` of slope 0.01, ``where(v >= 0, v, 0.01 v)``: autograd of this form
    gives JAX's gradient at exactly 0, 1 (torch's ``F.leaky_relu`` gives 0.01 there)."""
    return torch.where(v >= 0, v, 0.01 * v)


def torch_uniform_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place: PyTorch's default Linear/Conv
    init for kernel and bias alike, which the JAX package also uses."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Dense(nn.Module):
    """``nn.Linear`` with a flax ``(in, out)`` kernel; ``dtype`` is the compute dtype."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.kernel.shape[0]
        torch_uniform_(self.kernel, fan_in, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class MLP(nn.Module):
    """Dense layers ``Dense_0 .. Dense_{n-1}`` with ``activation`` between them and,
    unless ``activate_final`` is False, after the last (``blvm_tpu/modules/common.py:47``;
    the flax default activation is tanh). ``dtype`` is every layer's compute dtype."""

    def __init__(self, in_features: int, features: Sequence[int], activation: Callable = torch.tanh,
                 activate_final: bool = True, dtype=None, device=None):
        super().__init__()
        self.activation, self.activate_final, self.n_layers = activation, activate_final, len(features)
        for i, (fan_in, feat) in enumerate(zip([in_features, *features[:-1]], features)):
            setattr(self, f"Dense_{i}", Dense(fan_in, feat, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1 or self.activate_final:
                x = self.activation(x)
        return x
