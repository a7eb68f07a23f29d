"""Depthwise 1-D convolutions and the per-channel GroupNorm (port of ``blvm_tpu/modules/convolutions.py:88-165``
and of flax's ``GroupNorm(num_groups=C, epsilon=1e-5)``).

Channels-last ``(B, T, C)`` with the JAX package's ``(k, 1, C)`` depthwise kernel. The JAX module's
``conv``/``fma``/``auto`` lowering switch exists only to dodge a JAX partitioner fault and is not ported:
both of its lowerings compute the function below. These are the plain PyTorch forms; the CW-VAE's
coders run their depthwise chain through :func:`blvm_tpu_torch.ops.depthwise.depthwise_norm` (K11 on
the card), whose twin is built from them.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

GROUP_NORM_EPSILON = 1e-5


def depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, padding: Tuple[int, int] = (0, 0),
                     dilation: int = 1) -> torch.Tensor:
    """Depthwise correlation (``conv_general_dilated(..., feature_group_count=C)``, NWC/WIO): ``x (B, T, C)``,
    ``kernel (k, 1, C)``, ``padding`` zeros on each side, then VALID: ``(T + pads - d(k-1) - 1) // s + 1``
    output rows."""
    C = x.shape[-1]
    xt = F.pad(x.transpose(1, 2), tuple(padding))
    y = F.conv1d(xt, kernel.permute(2, 1, 0).to(x.dtype), stride=stride, dilation=dilation, groups=C)
    return y.transpose(1, 2)


def depthwise_conv_transpose1d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, padding: int = 0,
                               dilation: int = 1) -> torch.Tensor:
    """Depthwise ConvTranspose1d with torch's geometry, ``(T - 1) s - 2p + d(k-1) + 1`` rows: the JAX form
    (the input zero-stuffed by ``s``, full padding, the kernel flipped) is ``F.conv_transpose1d`` with the
    kernel as it is."""
    C = x.shape[-1]
    y = F.conv_transpose1d(x.transpose(1, 2), kernel.permute(2, 1, 0).to(x.dtype), stride=stride, padding=padding,
                           dilation=dilation, groups=C)
    return y.transpose(1, 2)


def group_norm_channels(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        epsilon: float = GROUP_NORM_EPSILON) -> torch.Tensor:
    """flax's ``GroupNorm(num_groups=C)`` over ``(B, T, C)``: each ``(b, c)``'s statistics over the whole
    time axis (padding rows included), with flax's fast variance, ``max(E[x^2] - E[x]^2, 0)``, in at least
    float32, then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=1, keepdim=True) - mean * mean, 0.0)
    mul = torch.rsqrt(var + epsilon) * scale
    return (xf - mean) * mul + bias
