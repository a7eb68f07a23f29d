"""WaveNet generation on the CPU: the port's ``generate`` against JAX ``WaveNet.generate``
with the samplers at the mode, fast against windowed, the windowed path with stacked
frames and the fast path with supplied uniforms against the forward, and the driver's
generation hook."""

import contextlib
import wave
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.models import WaveNet as JaxWaveNet
from blvm_tpu.modules.distributions import DiscretizedLogisticMixtureDense as JaxDMoLHead
from blvm_tpu.utils.audio import save_wav as jax_save_wav
from blvm_tpu_torch import weights
from blvm_tpu_torch.data.transforms import MuLawDecode
from blvm_tpu_torch.experiments import wavenet_audio
from blvm_tpu_torch.models import WaveNet
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense
from blvm_tpu_torch.ops.variational import rsample_discretized_logistic_mixture
from blvm_tpu_torch.utils.audio import save_wav
from tests._torch.helpers import torch_forward

SMALL = dict(n_layers=3, n_stacks=2, res_channels=16, num_mix=3, num_bins=256)
# the JAX suite's fast-vs-windowed tolerances (tests/models/test_wavenet.py:276): f32 the order
# of the sums; bf16 a one-ulp difference amplified by the gate's tanh and sigmoid
TOL = {False: 1e-5, True: 5e-2}
N_FRAMES = 40


def small_model(seed: int = 0, **kwargs):
    config = {**SMALL, **kwargs}
    model = WaveNet(**config)
    params = weights.random_jax_params(model, seed)
    weights.load_jax_params(model, params)
    return model, JaxWaveNet(**config), params


def history(model, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (2, model.receptive_field, 1)).astype(np.float32)


@contextlib.contextmanager
def samplers_at_the_mode():
    """Both packages' DMoL ``rsample`` replaced by the mode: JAX threefry and
    PyTorch's generators never draw the same numbers (ROADMAP Queue 3, random draws)."""
    with mock.patch.object(JaxDMoLHead, "rsample", lambda self, key, params: self.mode(params)), \
            mock.patch.object(DiscretizedLogisticMixtureDense, "rsample", lambda self, g, params, **kw: self.mode(params)):
        yield


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_generate_matches_jax_at_the_mode(bf16, fast):
    """Zero history (the port's default, JAX's given explicitly so both histories
    share one compile) and a waveform prefix, 40 frames."""
    model, jmodel, params = small_model(bf16=bf16)
    prefix = history(model)
    with samplers_at_the_mode():
        jgen = jax.jit(lambda p, x: jmodel.apply({"params": p}, n_samples=2, n_frames=N_FRAMES, x=x, fast=fast,
                                                 rngs={"sample": jax.random.PRNGKey(0)}, method=JaxWaveNet.generate))
        refs = [np.asarray(jgen(weights.unflatten(params), jnp.asarray(h))) for h in (np.zeros_like(prefix), prefix)]
        got = [model.generate(2, N_FRAMES, fast=fast), model.generate(2, N_FRAMES, x=torch.from_numpy(prefix), fast=fast)]
    for g, ref in zip(got, refs):
        assert g.shape == ref.shape == (2, N_FRAMES) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=TOL[bf16])


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_fast_matches_plain_naive_with_one_generator(bf16):
    """The port's ``test_fast_matches_naive``: same generator state, same draws frame by
    frame, so the circular buffers must reproduce the windowed path sample for sample."""
    model, _, _ = small_model(seed=2, bf16=bf16)
    prefix = torch.from_numpy(history(model, seed=3))
    for x in (None, prefix):
        fast = model.generate(2, N_FRAMES, x=x, generator=torch.Generator().manual_seed(5))
        naive = model.generate(2, N_FRAMES, x=x, fast=False, generator=torch.Generator().manual_seed(5))
        np.testing.assert_allclose(fast.numpy(), naive.numpy(), rtol=0, atol=TOL[bf16])


@pytest.mark.parametrize("n_stack_frames", [1, 2, 4])
def test_generated_samples_are_the_forwards_samples_from_the_same_uniforms(n_stack_frames):
    """Teacher forcing: fed the generation's uniforms, the sampler over the rf-padded
    forward of the generated waveform reproduces every frame (f32, the order of the sums).
    With stacked frames generation takes the windowed path (as in JAX); a step emits
    ``s`` frames, which enter the window as one stacked frame. JAX's windowed path
    raises there (it concatenates the (B, 1, 1) sample onto the (B, rf - 1, s) window),
    so the port's own forward is the reference."""
    model, _, _ = small_model(seed=6, n_stack_frames=n_stack_frames)
    rng = np.random.default_rng(7)
    u_cat, u_log = (torch.from_numpy(rng.random(shape, np.float32)) for shape in ((N_FRAMES, 2, 3), (N_FRAMES, 2, 1)))
    x = model.generate(2, N_FRAMES, uniforms=(u_cat, u_log))
    n = N_FRAMES // n_stack_frames * n_stack_frames
    assert x.shape == (2, n)
    _, _, out = torch_forward(model, x.numpy(), np.full(2, n, np.int32))
    again = rsample_discretized_logistic_mixture(None, *out.parameters, uniforms=(u_cat[:n].transpose(0, 1),
                                                                                   u_log[:n].transpose(0, 1)))
    np.testing.assert_allclose(again[..., 0].numpy(), x.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        model.generate(2, N_FRAMES + 1, uniforms=(u_cat, u_log))  # one row of uniforms a frame


@pytest.mark.parametrize("fast", [True, False])
def test_generate_shapes_and_range(fast):
    model, _, _ = small_model(seed=8)
    x = model.generate(2, 20, fast=fast, generator=torch.Generator().manual_seed(0))
    assert x.shape == (2, 20) and torch.isfinite(x).all() and x.abs().max() <= 1.0
    assert not torch.equal(x, model.generate(2, 20, fast=fast, generator=torch.Generator().manual_seed(1)))


def test_rsample_on_the_cpu_keeps_the_twins_gradient():
    head = DiscretizedLogisticMixtureDense(4, y_dim=1, num_mix=3)
    params = head(torch.randn(5, 4, generator=torch.Generator().manual_seed(0)))
    head.rsample(torch.Generator().manual_seed(1), params).sum().backward()
    assert head.Dense_0.kernel.grad is not None and torch.isfinite(head.Dense_0.kernel.grad).all()


def test_save_wav_is_the_jax_packages(tmp_path):
    samples = np.random.default_rng(0).uniform(-1.2, 1.2, 700).astype(np.float32)
    save_wav(tmp_path / "port.wav", samples)
    jax_save_wav(str(tmp_path / "jax.wav"), samples)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_generation_hook_cadence_names_and_contents(tmp_path, monkeypatch):
    """Every ``--generate_every`` epochs, two mu-law-decoded wav files of 2 x 16000
    generated frames (cut to 40 here by wrapping ``generate``); nothing otherwise."""
    args = wavenet_audio.build_args(
        "--n_stacks 2 --n_layers 3 --res_channels 8 --num_mix 3 --num_bits 8 --generate_every 2 --seed 0".split())
    model = wavenet_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    generate, calls = model.generate, []

    def short(n_samples, n_frames, **kwargs):
        calls.append((n_samples, n_frames))
        return generate(n_samples, N_FRAMES, **kwargs)

    monkeypatch.setattr(model, "generate", short)
    hook = wavenet_audio.make_generation_hook(model, args)
    assert hook(1, tmp_path) == [] and hook(3, tmp_path) == [] and not (tmp_path / "audio").exists()
    paths = hook(4, tmp_path, generator=torch.Generator().manual_seed(0))
    assert calls == [(2, 16000)]
    assert [p.relative_to(tmp_path).as_posix() for p in paths] == [
        "audio/epoch0004_generated_0.wav", "audio/epoch0004_generated_1.wav"]
    expected = MuLawDecode(bits=8)(generate(2, N_FRAMES, generator=torch.Generator().manual_seed(0)).numpy())
    for path, samples in zip(paths, expected):
        with wave.open(str(path)) as f:
            assert (f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()) == (1, 2, 16000, N_FRAMES)
            pcm = np.frombuffer(f.readframes(N_FRAMES), "<i2")
        np.testing.assert_array_equal(pcm, (np.clip(samples, -1, 1) * 32767.0).astype("<i2"))
    assert wavenet_audio.make_generation_hook(model, wavenet_audio.build_args(["--generate_every", "0"]))(4, tmp_path) == []
