"""Host-side numpy transforms (copies from ``blvm_tpu/data/transforms.py``): the mu-law
pair and ``RandomSegment`` of the audio drivers; ``Compose``, the text transforms
(``TextCleaner``, ``EncodeInteger``, ``DecodeInteger``), ``StackTensor`` and the
log-mel spectrogram of the CTC probe.

Numpy path only: the JAX package's optional C++ fast path (``blvm_tpu.native``)
computes the same companding.
"""

import hashlib
import math
from typing import Callable, Optional

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


class Compose(Transform):
    def __init__(self, *transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, x, ctx: Optional[dict] = None):
        for transform in self.transforms:
            x = transform(x, ctx) if isinstance(transform, Transform) else transform(x)
        return x

    def forward(self, x):
        return self(x)


class TextCleaner(Transform):
    def __init__(self, *cleaner_fcns: Callable):
        self.cleaner_fcns = cleaner_fcns

    def forward(self, x: str):
        for fcn in self.cleaner_fcns:
            x = fcn(x)
        return x


class EncodeInteger(Transform):
    def __init__(self, tokenizer, token_map):
        self.tokenizer = tokenizer
        self.token_map = token_map

    def forward(self, x: str):
        return self.token_map.encode(self.tokenizer(x))


class DecodeInteger(Transform):
    def __init__(self, join_token, token_map):
        self.join_token = join_token
        self.token_map = token_map

    def forward(self, x):
        return self.join_token.join(self.token_map.decode(x))


class StackTensor(Transform):
    def __init__(self, n_frames: int, axis: int = -1):
        """Frame-stack along ``axis`` with a new trailing stack dim, zero-padding ``axis`` to a
        multiple of ``n_frames``: a waveform (T,) becomes (ceil(T / n), n)."""
        self.n_frames = n_frames
        self.axis = axis

    def forward(self, x):
        x = np.asarray(x)
        axis = self.axis if self.axis >= 0 else x.ndim + self.axis
        padding = (-x.shape[axis]) % self.n_frames
        if padding:
            pad_width = [(0, 0)] * x.ndim
            pad_width[axis] = (0, padding)
            x = np.pad(x, pad_width)
        split_shape = list(x.shape)
        split_shape[axis : axis + 1] = [x.shape[axis] // self.n_frames, self.n_frames]
        x = x.reshape(split_shape)
        return np.moveaxis(x, axis + 1, -1)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0, f_max: Optional[float] = None):
    """HTK-style triangular mel filterbank, (n_mels, n_fft // 2 + 1)."""
    f_max = f_max or sample_rate / 2.0
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float32)
    for m in range(1, n_mels + 1):
        left, center, right = bins[m - 1], bins[m], bins[m + 1]
        for k in range(left, center):
            if center > left:
                fb[m - 1, k] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fb[m - 1, k] = (right - k) / (right - center)
    return fb


class LogMelSpectrogram(Transform):
    def __init__(
        self,
        sample_rate: int = 16000,
        n_fft: int = 400,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        n_mels: int = 80,
        normalize_frq_bins: bool = True,
    ) -> None:
        """Log-mel spectrogram with per-frequency-bin normalization, from a numpy STFT
        (centre-padded by reflection, a periodic Hann window centred in ``n_fft``):
        a waveform (T,) becomes (n_mels, 1 + T // hop_length)."""
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length or n_fft
        self.hop_length = hop_length or self.win_length // 2
        self.n_mels = n_mels
        self.normalize_frq_bins = normalize_frq_bins
        self._window = np.hanning(self.win_length + 1)[:-1].astype(np.float32)
        self._fb = mel_filterbank(sample_rate, n_fft, n_mels)

    def forward(self, waveform):
        x = np.asarray(waveform, dtype=np.float32).reshape(-1)
        pad = self.n_fft // 2
        x = np.pad(x, (pad, pad), mode="reflect")
        n_frames = 1 + (len(x) - self.n_fft) // self.hop_length
        idx = np.arange(self.n_fft)[None, :] + self.hop_length * np.arange(n_frames)[:, None]
        frames = x[idx]
        if self.win_length < self.n_fft:
            lpad = (self.n_fft - self.win_length) // 2
            window = np.pad(self._window, (lpad, self.n_fft - self.win_length - lpad))
        else:
            window = self._window
        spec = np.abs(np.fft.rfft(frames * window, n=self.n_fft, axis=-1)) ** 2  # power
        mel = spec @ self._fb.T  # (frames, n_mels)
        logmel = 10.0 * np.log10(np.clip(mel, 1e-10, None)).T  # (n_mels, frames)

        if self.normalize_frq_bins:
            logmel = logmel - logmel.mean(axis=-1, keepdims=True)
            logmel = logmel / (logmel.std(axis=-1, keepdims=True) + 1e-10)
        return logmel.astype(np.float32)
