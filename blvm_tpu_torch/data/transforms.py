"""Host-side numpy transforms (the mu-law pair and ``RandomSegment`` of
``blvm_tpu/data/transforms.py``).

Numpy path only: the JAX package's optional C++ fast path (``blvm_tpu.native``)
computes the same companding.
"""

import hashlib
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


class RandomSegment(Transform):
    def __init__(self, length: int, seed: Optional[int] = None):
        """Randomly crop a segment of ``length`` from an example of shape (T, *).

        With a ``ctx`` holding ``example_id`` (and ``epoch``) the crop is a pure
        function of (seed, epoch, example_id), hashed with blake2b as the JAX
        package does, so it does not depend on loading order and changes each
        epoch. Calls without ``ctx`` draw from a sequential RNG.
        """
        self.length = length
        self.seed = 0 if seed is None else int(seed)
        self._rng = np.random.default_rng(seed)

    def __call__(self, x, ctx: Optional[dict] = None):
        high = max(x.shape[0] - self.length, 1)
        if ctx and ctx.get("example_id") is not None:
            key = f"{self.seed}|{ctx.get('epoch', 0)}|{ctx['example_id']}".encode()
            digest = hashlib.blake2b(key, digest_size=8).digest()
            start_idx = int(int.from_bytes(digest, "little") % high)
        else:
            start_idx = int(self._rng.integers(0, high))
        return x[start_idx : start_idx + self.length]

    def forward(self, x):
        return self(x)
