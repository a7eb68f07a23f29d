"""Shape bucketing of a dynamic batch dimension (copy of ``blvm_tpu/data/buckets.py``).

The JAX package rounds padded lengths up to a bounded grid so that XLA compiles
few shapes; the port keeps the same padding, so that a batch holds the same
numbers in both packages (the CTC probe pads features to a multiple of 64 frames
and labels to a multiple of 16).
"""

import math
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class BucketSpec:
    """Bucketing policy for one dynamic dimension.

    ``mode='multiple'``: round up to a multiple of ``multiple``.
    ``mode='pow2'``: round up to ``base * 2**k``.
    ``boundaries``: explicit sorted grid; values above the last boundary round
    up to a multiple of it.
    """

    mode: str = "multiple"
    multiple: int = 1024
    base: int = 128
    boundaries: Optional[Sequence[int]] = None

    def __call__(self, length: int) -> int:
        return bucket_length(length, self)


def bucket_length(length: int, spec: Optional[BucketSpec]) -> int:
    """Smallest bucketed length >= ``length`` under ``spec`` (identity if None)."""
    if spec is None or length <= 0:
        return length
    if spec.boundaries is not None:
        for b in spec.boundaries:
            if length <= b:
                return int(b)
        last = spec.boundaries[-1]
        return int(math.ceil(length / last) * last)
    if spec.mode == "multiple":
        return int(math.ceil(length / spec.multiple) * spec.multiple)
    if spec.mode == "pow2":
        if length <= spec.base:
            return spec.base
        return int(spec.base * 2 ** math.ceil(math.log2(length / spec.base)))
    raise ValueError(f"Unknown bucket mode {spec.mode!r}")
