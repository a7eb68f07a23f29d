"""Host-side numpy transforms (the mu-law pair of ``blvm_tpu/data/transforms.py``).

Numpy path only: the JAX package's optional C++ fast path (``blvm_tpu.native``)
computes the same companding.
"""

import math
from typing import Optional

import numpy as np


class Transform:
    def __call__(self, x, ctx: Optional[dict] = None):
        return self.forward(x)

    def forward(self, x):
        raise NotImplementedError()

    def __repr__(self):
        attrs = ", ".join(f"{k}={v}" for k, v in vars(self).items() if not k.startswith("_"))
        return f"{self.__class__.__name__}({attrs})"


class MuLawEncode(Transform):
    def __init__(self, bits: int = 8):
        """Continuous mu-law companding of PCM in [-1, 1]:
        ``sign(x) log(1 + mu|x|) / log(1 + mu)`` (reference ``transforms.py:192-201``)."""
        self.bits = bits
        self.mu = 2**bits - 1
        self._divisor = math.log(self.mu + 1)

    def forward(self, x):
        x = np.asarray(x)
        return np.sign(x) * np.log1p(self.mu * np.abs(x)) / self._divisor


class MuLawDecode(Transform):
    def __init__(self, bits: int = 8):
        self.bits = bits
        self.mu = 2**bits - 1
        self._divisor = math.log(self.mu + 1)

    def forward(self, x):
        x = np.asarray(x)
        return np.sign(x) * (np.exp(np.abs(x) * self._divisor) - 1.0) / self.mu
