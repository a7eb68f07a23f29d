"""Padding arithmetic and padders (port of ``blvm_tpu/ops/padding.py``): the integer helpers
and :func:`pad_axis` / :func:`pad_modulo` on tensors."""

from typing import Tuple

import torch
import torch.nn.functional as F


def get_modulo_padding(
    length: int, stride: int, kernel_size: int = 0, dilation: int = 1, pad_to_kernel_size: bool = False
) -> int:
    """Padding ``p`` such that ``(length + p - kernel_size) mod stride == 0``."""
    if dilation > 1:
        raise NotImplementedError(f"Dilation greater than 1 not yet supported but got {dilation=}.")

    if length < kernel_size:
        if pad_to_kernel_size:
            return kernel_size - length
        raise ValueError(f"Input {length=} was shorter than {kernel_size=} and {pad_to_kernel_size=}.")

    missing = (length - kernel_size) % stride
    return stride - missing if missing else 0


def get_modulo_length(length: int, stride: int, kernel_size: int = 0) -> int:
    """Smallest length >= ``length`` that is wholly strideable given kernel."""
    return length + get_modulo_padding(length, stride, kernel_size)


def split_padding_left_right(padding: int, side: str = "both") -> Tuple[int, int]:
    """``(left, right)`` of a total padding; ``side="both"`` splits it as the reference does,
    ``(sym // 2, sym // 2 + asym)`` with ``sym = padding // 2`` (``padding.py:23-33``)."""
    if side == "left":
        return padding, 0
    if side == "right":
        return 0, padding
    if side == "both":
        sym = padding // 2
        return sym // 2, sym // 2 + padding - 2 * sym
    raise ValueError(f"Unknown side `{side=}`. Valid options are `left`, `right` and `both`")


def get_same_padding(length: int, stride: int, kernel_size: int, dilation: int = 1) -> int:
    """TF-style "same" padding, ``max(0, d(k-1) - (length-1) % s)``: a conv's output length
    becomes ``ceil(length / stride)``."""
    return max(0, dilation * (kernel_size - 1) - (length - 1) % stride)


def get_same_padding_transposed(kernel_size: int, stride: int, dilation: int = 1) -> int:
    """The padding (negative: a crop) a transposed conv needs to invert "same" geometry,
    ``d(k-1) + 1 - s``."""
    return dilation * (kernel_size - 1) + 1 - stride


def pad_axis(x: torch.Tensor, pad_left: int = 0, pad_right: int = 0, axis: int = 1, value: float = 0.0) -> torch.Tensor:
    """Pad (or crop, for negative amounts) one axis of ``x``."""
    axis = axis % x.ndim
    if pad_left < 0:
        x = x.narrow(axis, -pad_left, x.shape[axis] + pad_left)
        pad_left = 0
    if pad_right < 0:
        x = x.narrow(axis, 0, x.shape[axis] + pad_right)
        pad_right = 0
    if not pad_left and not pad_right:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [pad_left, pad_right]  # F.pad lists the last axis first
    return F.pad(x, widths, value=value)


def pad_modulo(x: torch.Tensor, stride: int, kernel_size: int = 0, dilation: int = 1, pad_to_kernel_size: bool = False,
               pad_side: str = "left", axis: int = 1) -> torch.Tensor:
    """Pad ``x`` so ``(length + p - kernel_size) mod stride == 0``."""
    p = get_modulo_padding(x.shape[axis], stride, kernel_size, dilation, pad_to_kernel_size)
    left, right = split_padding_left_right(p, pad_side)
    return pad_axis(x, left, right, axis=axis)
