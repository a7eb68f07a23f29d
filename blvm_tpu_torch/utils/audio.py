"""WAV writing for generated and reconstructed audio (the port's copy of
``blvm_tpu/utils/audio.py``, which is framework-neutral)."""

import wave

import numpy as np


def save_wav(path: str, samples, sample_rate: int = 16000) -> None:
    """Write mono float samples in [-1, 1] as 16-bit PCM."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    data = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(data.tobytes())
