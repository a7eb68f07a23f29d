"""Receptive-field / output-size arithmetic for conv stacks.

Pure-Python copy of ``blvm_tpu/ops/conv_arithmetic.py`` (itself a rebuild of
reference ``blvm/utils/convolutions.py:83-210``): propagate output length,
effective stride ("jump"), receptive field and first-feature center through a
stack of (dilated, strided, padded) 1-D convolutions.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class ConvAttributes:
    """Geometry of a feature map relative to the network input."""

    out_size: int  # number of features (output length)
    stride: int  # distance between centers of adjacent features, in input samples
    receptive_field: int  # receptive field of one feature, in input samples
    start: float  # center coordinate of the first feature (negative = in padding)


def compute_conv_attributes_single(
    i: int = 0,
    k: int = 1,
    p: int = 0,
    s: int = 1,
    d: int = 1,
    s_in: int = 1,
    r_in: int = 1,
    start_in: float = 0.0,
) -> ConvAttributes:
    """Map (out_size, stride, receptive_field, start) through one conv layer.

    Standard receptive-field arithmetic: effective kernel ``k_eff = d(k-1)+1``,
    ``r_out = r_in + (k_eff - 1) * s_in``, ``o_out = (i - k_eff + 2p)//s + 1``.
    """
    k_eff = k + (k - 1) * (d - 1)
    s_out = s_in * s
    r_out = r_in + (k_eff - 1) * s_in
    o_out = (i - k_eff + 2 * p) // s + 1
    actual_padding = (o_out - 1) * s - i + k_eff
    pad_left = actual_padding // 2
    start_out = start_in + ((k_eff - 1) / 2 - pad_left) * s_in
    return ConvAttributes(o_out, s_out, r_out, start_out)


def compute_conv_attributes(
    kernels: Sequence[int],
    paddings: Sequence[int],
    strides: Sequence[int],
    dilations: Optional[Sequence[int]] = None,
    in_shape: int = 0,
    stride_in: int = 1,
    receptive_field_in: int = 1,
    start_in: float = 0.0,
    return_all: bool = False,
):
    """Propagate conv attributes through a stack of layers.

    Returns the final :class:`ConvAttributes` (or per-layer list if
    ``return_all``).
    """
    if dilations is None:
        dilations = [1] * len(kernels)
    if not (len(kernels) == len(paddings) == len(strides) == len(dilations)):
        raise ValueError("Number of layers in each of the parameters must be equal")

    attrs = ConvAttributes(in_shape, stride_in, receptive_field_in, start_in)
    all_attrs: List[ConvAttributes] = []
    for k, p, s, d in zip(kernels, paddings, strides, dilations):
        attrs = compute_conv_attributes_single(
            attrs.out_size, k, p, s, d, attrs.stride, attrs.receptive_field, attrs.start
        )
        all_attrs.append(attrs)

    return all_attrs if return_all else attrs


def receptive_field(kernels: Sequence[int], strides: Sequence[int], dilations: Optional[Sequence[int]] = None) -> int:
    """Receptive field of a conv stack in input samples."""
    return compute_conv_attributes(kernels, [0] * len(kernels), strides, dilations).receptive_field
