"""Padding arithmetic (port of the integer helpers of ``blvm_tpu/ops/padding.py``)."""


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
