"""The port's CWVAEAudio (``models/clockwork_vae/``) and its driver (``experiments/clockwork_audio.py``) against the
JAX package, the frozen golden ``cwvae.npz`` and ``experiments/experiment_clockwork_audio.py``, on the CPU, at
small widths (h = 8, z = 4) in the run specs' coder geometry (blocks of stride 4, kernel 5). Both packages' Gaussian
samplers are at the mean, as the golden is (``patch_modules: ["blvm_tpu.modules.rssm"]``). GroupNorm is
ill-conditioned over a handful of rows, so every comparison has at least 30 top-level steps, and both packages see
the same padded input. The forwards and the generation are held to JAX's in f64 (``jax.enable_x64``): the port's
f64 frames at a tight tolerance, its f32 outputs at the tolerances below. Inputs and weights come from numpy seeds;
each JAX reference compiles once, in a module-scoped fixture, at XLA's CPU optimization level 0."""

import json
import shlex
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.modules.rssm as jax_rssm
from blvm_tpu.evaluation.tracker import Tracker as JaxTracker
from blvm_tpu.models import CWVAEAudio as JaxCWVAEAudio
from blvm_tpu.training import CosineAnnealer as JaxCosineAnnealer
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import clockwork_audio, common
from blvm_tpu_torch.models import CWVAEAudio
from blvm_tpu_torch.models.clockwork_vae import clockwork_vae as port_cwvae
from blvm_tpu_torch.training.eval_step import make_eval_step

REPO = Path(__file__).resolve().parent.parent.parent
GOLDENS = REPO / "tests" / "parity" / "goldens"
# name: model keyword arguments (the drivers' 3 blocks of stride 4 a level) and call keyword arguments
CONFIGS = {
    "two_levels_precision_resets": (dict(strides=(16, 4), precision_posterior=True, with_resets=True),
                                    dict(beta=0.8, free_nats=0.5)),
    "one_level_s64_residual": (dict(strides=(64,), residual_posterior=True), dict(beta=1.0, free_nats=0.0)),
}
SMALL = dict(z_size=4, h_size=8, num_level_layers=3, stride_per_layer=4, num_mix=2, likelihood="DMoL")
# each config's batch: 32 (30) top-level steps, two rows right-padded; 1941 samples at stride 64 are also a chunk
# of the state-carry pass, so one JAX compile serves both
LENGTHS = {"two_levels_precision_resets": (2048, 1700, 1240), "one_level_s64_residual": (1941, 1700, 1240)}
METRICS = ("loss", "elbo", "log_prob", "kld", "mc_kl")
CARRY_SEGMENT = 1920  # chunks of 1941 samples: 30 top-level steps at stride 64
GEN_FRAMES = 2048
# the port's f32 frames (the DMoL mode) against JAX's f64 ones: the decoder's GroupNorms amplify f32 rounding in the
# head's parameters with these random weights (JAX's own f32 forward lies 3.1e-4 from its f64 one, its f32 rollout
# 2.4e-4; the port's f32 lies 3.2e-4 and 7.7e-5 from them), so no 1e-5 holds there while it does for the losses
F32_FRAMES_ATOL = 1e-3


def _batch(lengths, T, seed=1):
    x = np.random.default_rng(seed).uniform(-1, 1, (len(lengths), T)).astype(np.float32)
    for row, n in enumerate(lengths):
        x[row, n:] = 0.0
    return x, np.asarray(lengths, np.int32)


def _port_model(config, seed=3, dtype=torch.float32):
    model = CWVAEAudio(**SMALL, **CONFIGS[config][0], device="cpu").to(dtype)
    params = weights.random_jax_params(model, seed)
    weights.load_jax_params(model, params)
    return model, weights.unflatten(params)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _at_the_mean():
    """Both packages' Gaussian latent samples at their mean."""
    return (mock.patch.object(jax_rssm, "rsample_gaussian", lambda key, mu, sd: mu),
            mock.patch.object(port_cwvae, "gaussian_noise",
                              lambda g, shape, like: torch.zeros(shape, dtype=like.dtype, device=like.device)))


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's CPU backend optimization level 0: the same program compiled
    faster; only the order of some sums may differ, well inside the tolerances below."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def _carry_batch():
    return _batch([5000, 3900, 2600], 5000, seed=5)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX forward of every config in f64, the state-carry pass of the one-level config in f32 as
    ``experiment_clockwork_audio.py:123-135`` runs it (every chunk given its state, zeros first, which is the
    ``state0=None`` of the first chunk), and the JAX generation of the two-level config at the mode in f64."""
    out = {}
    patch_jax, _ = _at_the_mean()
    key = jax.random.PRNGKey(0)
    with patch_jax:
        config = "two_levels_precision_resets"
        _, params = _port_model(config)
        jmodel = JaxCWVAEAudio(**SMALL, **CONFIGS[config][0])
        x, x_sl = _batch(LENGTHS[config], LENGTHS[config][0])
        with jax.enable_x64(True):
            p64, x64 = _f64(params), x.astype(np.float64)
            _, mets, o = _compiled(lambda p, x_, s_: jmodel.apply({"params": p}, x_, s_, rngs={"sample": key},
                                                                  **CONFIGS[config][1]), p64, x64, x_sl)(p64, x64, x_sl)
            out[config] = jax.tree_util.tree_map(np.asarray, (mets, o.z, o.state_n, o.reconstructions_mode))
            (gen, _), _ = _compiled(lambda p: jmodel.apply({"params": p}, n_samples=2, max_timesteps=GEN_FRAMES,
                                                           use_mode_observations=True, rngs={"sample": key},
                                                           method=JaxCWVAEAudio.generate), p64)(p64)
            out["generate"] = np.asarray(gen)

        config = "one_level_s64_residual"
        _, params = _port_model(config)
        jmodel = JaxCWVAEAudio(**SMALL, **CONFIGS[config][0])
        x, x_sl = _carry_batch()
        chunks, lens = jmodel.split_sequence(x, x_sl, length=CARRY_SEGMENT)
        state0 = [(np.zeros((3, 4), np.float32), np.zeros((3, 8), np.float32))]
        steps = {}
        tracker = JaxTracker()
        for i, (xs, sl) in enumerate(zip(chunks, lens)):
            is_last = i == len(chunks) - 1
            if is_last not in steps:
                steps[is_last] = _compiled(lambda p, x_, s_, st, last=is_last: jmodel.apply(
                    {"params": p}, x_, s_, state0=st, beta=1.0, free_nats=0.0, pad_strideable=False, pad_same=last,
                    rngs={"sample": key}), params, jnp.asarray(xs), jnp.asarray(sl), state0)
            _, mets, o = steps[is_last](params, jnp.asarray(xs), jnp.asarray(sl), state0)
            state0 = o.state_n
            tracker.update(jmodel.cwvae_build_metrics(jax.device_get(mets)), source="test", check_unique=False)
        out["carry"] = dict(tracker.values["test"]), jax.tree_util.tree_map(np.asarray, state0), len(chunks)
        # the forward of the one-level config: the last chunk's program in f64 (same padding; state0 zeros is None)
        x, x_sl = _batch(LENGTHS[config], LENGTHS[config][0])
        with jax.enable_x64(True):
            p64, x64, zeros = _f64(params), x.astype(np.float64), [(np.zeros((3, 4)), np.zeros((3, 8)))]
            _, mets, o = _compiled(lambda p, x_, s_, st: jmodel.apply(
                {"params": p}, x_, s_, state0=st, beta=1.0, free_nats=0.0, pad_strideable=False, pad_same=True,
                rngs={"sample": key}), p64, x64, x_sl, zeros)(p64, x64, x_sl, zeros)
            out[config] = jax.tree_util.tree_map(np.asarray, (mets, o.z, o.state_n, o.reconstructions_mode))

    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cwvae_audio_matches_jax(jax_side, config):
    """Loss, per-example elbo, log_prob, kld, each level's KL and mc_kl, every level's latents and carried state
    (at each example's stop index) and the reconstruction's mode of the port's f32 forward against the JAX forward
    at the mean in f64, over 32 top-level steps, two rows right-padded: rtol 1e-5 on the loss and the metrics (atol
    1e-4 on the per-example sums of ~2000 frames), 1e-5 on latents and states (f32 rounding; 2.4e-6 at most),
    ``F32_FRAMES_ATOL`` on the mode. The port's f64 mode agrees with JAX's to 1e-10 (summation orders: ~2e-13)."""
    model, _ = _port_model(config)
    x, x_sl = _batch(LENGTHS[config], LENGTHS[config][0])
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, out = model(torch.from_numpy(x), torch.from_numpy(x_sl), **CONFIGS[config][1])
    jmets, jz, jstate, jmode = jax_side[config]
    np.testing.assert_allclose(float(loss), float(jmets["loss"]), rtol=1e-5)
    for name in METRICS[1:]:
        np.testing.assert_allclose(mets[name].numpy(), jmets[name], rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(mets["kld_l"].numpy(), np.stack(jmets["kld_l"], axis=1), rtol=1e-5, atol=1e-4)
    for l, ref in enumerate(jz):
        np.testing.assert_allclose(out.z[l].numpy(), ref, atol=1e-5, rtol=1e-5, err_msg=f"z level {l}")
        for got, ref_s in zip(out.state_n[l], jstate[l]):
            np.testing.assert_allclose(got.numpy(), ref_s, atol=1e-5, rtol=1e-5, err_msg=f"state level {l}")
    model64, _ = _port_model(config, dtype=torch.float64)
    with patch_port, torch.no_grad():
        _, _, out64 = model64(torch.from_numpy(x).double(), torch.from_numpy(x_sl), **CONFIGS[config][1])
    np.testing.assert_allclose(out64.reconstructions_mode.numpy(), jmode, atol=1e-10, rtol=0)
    np.testing.assert_allclose(out.reconstructions_mode.numpy(), jmode, atol=F32_FRAMES_ATOL, rtol=0)
    assert out.reconstructions.shape == (3, LENGTHS[config][0], 1)
    assert out.z_sl[-1].tolist() == [-(-n // 64) for n in LENGTHS[config]]


def test_frozen_cwvae_golden():
    """``tests/parity/goldens/cwvae.npz`` (two levels, strides [4, 2] in blocks of 2, beta 0.7, free nats 2): the
    torch reference's loss and per-example elbo, log-probability and kl at ``tests/parity/test_goldens.py``'s
    tolerances (loss rtol 5e-5, metrics rtol 2e-4)."""
    data = np.load(GOLDENS / "cwvae.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    assert meta["patch_modules"] == ["blvm_tpu.modules.rssm"]
    model = CWVAEAudio(**{k: tuple(v) if isinstance(v, list) else v for k, v in meta["kwargs"].items()})
    weights.load_jax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p|")})
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, _ = model(torch.from_numpy(data["x"]), torch.from_numpy(data["x_sl"]), **meta["call_kwargs"])
    np.testing.assert_allclose(float(loss), float(data["g|loss"]), rtol=5e-5, atol=1e-5)
    for name, key in (("elbo", "elbo"), ("log_prob", "log_prob"), ("kld", "kl")):
        np.testing.assert_allclose(mets[name].numpy(), data[f"g|{key}"], rtol=2e-4, atol=2e-3, err_msg=name)


def test_state_carry_test_pass_matches_jax(jax_side):
    """``--split_eval`` at stride 64: chunks of 1941 samples overlapping by ``rf - stride`` (21), ``(z, h)``
    carried, same padding on the last chunk only (``experiment_clockwork_audio.py:123-135``), against the same
    loop over the JAX forward: the tracker's values (rtol 1e-5; the EMA of bits/frame too) and the last chunk's
    states; the driver's ``evaluate`` takes the same path."""
    jvalues, jstate, n_chunks = jax_side["carry"]
    model, _ = _port_model("one_level_s64_residual")
    args = clockwork_audio.build_args(f"--hidden_size 8 --latent_size 4 --strides 64 --num_mix 2 --split_eval true "
                                      f"--residual_posterior true --random_segment_size {CARRY_SEGMENT}".split())
    carry = clockwork_audio.make_state_carry_eval(model, args)
    tracker = Tracker()
    x, x_sl = _carry_batch()
    _, patch_port = _at_the_mean()
    with patch_port:
        out = carry(make_eval_step(common.loss_fn), model, None, x, x_sl, {}, tracker, "test")
    assert n_chunks == 3
    assert set(tracker.values["test"]) == set(jvalues)
    for key, value in jvalues.items():
        np.testing.assert_allclose(tracker.values["test"][key], value, rtol=1e-5, err_msg=key)
    for got, ref in zip(out.state_n[0], jstate[0]):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    with patch_port:
        values = clockwork_audio.evaluate(model, args, [(x, x_sl)], Tracker())
    assert values["elbo (bpt)"] == tracker.values["test"]["elbo (bpt)"]


def test_generate_at_the_mode_matches_jax(jax_side):
    """``generate(use_mode_observations=True)`` with the latents at the prior's mean, 2048 frames over two levels
    (32 top-level steps; resets not applied and the decoder's same padding computed with the receptive field and
    the stride swapped, as JAX's ``generate`` does), held to JAX's f64 rollout: the port's f64 frames within 1e-6
    (JAX rounds each level's decoded context to f32 even in f64, ``clockwork_vae.py:373``, the port keeps f64:
    3.1e-7 apart), its f32 frames within ``F32_FRAMES_ATOL``."""
    model, _ = _port_model("two_levels_precision_resets")
    model64, _ = _port_model("two_levels_precision_resets", dtype=torch.float64)
    _, patch_port = _at_the_mean()
    with patch_port:
        (x, x_sl), _ = model.generate(n_samples=2, max_timesteps=GEN_FRAMES, use_mode_observations=True)
        (x64, _), _ = model64.generate(n_samples=2, max_timesteps=GEN_FRAMES, use_mode_observations=True)
    assert x.shape == (2, GEN_FRAMES, 1) and x_sl.tolist() == [GEN_FRAMES] * 2
    assert model.cwvae._same_paddings(GEN_FRAMES, generation=True) == [8, 0] != model.cwvae._same_paddings(GEN_FRAMES)
    np.testing.assert_allclose(x64.numpy(), jax_side["generate"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(x.numpy(), jax_side["generate"], atol=F32_FRAMES_ATOL, rtol=0)


def test_generation_hook_and_supplied_noise():
    """The hook writes 2 clips of ``--generate_frames`` frames as wav files; a rollout from supplied latent noise
    (level 0's 72 steps: the context JAX's generation padding leaves) is a pure function of it."""
    args = clockwork_audio.build_args("--hidden_size 8 --latent_size 4 --strides 16 4 --num_mix 2 --generate_every 2 "
                                      "--generate_frames 640".split())
    model = clockwork_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    rng = np.random.default_rng(6)
    eps = [torch.from_numpy(rng.normal(size=(2, n, 4)).astype(np.float32)) for n in (72, 10)]  # levels 0 and 1
    (a, _), _ = model.generate(n_samples=2, max_timesteps=640, use_mode_observations=True, eps=eps)
    (b, _), _ = model.generate(n_samples=2, max_timesteps=640, use_mode_observations=True, eps=eps)
    (c, _), _ = model.generate(n_samples=2, max_timesteps=640, use_mode_observations=True, eps=[-e for e in eps])
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    hook = clockwork_audio.make_generation_hook(model, args)
    assert hook(3, "unused") == []
    with mock.patch.object(common, "save_wav") as save:
        paths = hook(4, Path("run"), generator=torch.Generator().manual_seed(0))
    assert [p.as_posix() for p in paths] == ["run/audio/epoch0004_generated_0.wav", "run/audio/epoch0004_generated_1.wav"]
    assert [call.args[1].shape for call in save.call_args_list] == [(640,), (640,)]


def _spec_lines():
    return [line for line in (REPO / "experiments" / "benchmarks.txt").read_text().splitlines()
            if line.startswith("python experiments/experiment_clockwork_audio.py")]


def test_benchmark_cwvae_specs_parse_and_the_unbuildable_raise_in_both_packages():
    """All 12 CW-VAE run specs parse (unused flags warn): d = 192, DMoL 10 x 2^16, the precision posterior, f32,
    the length sampler accepted. At the drivers' 3 blocks of stride 4 only strides [64] builds; [64, 8] and [256, 8]
    raise ``ValueError`` and [256] ``AssertionError`` in the port's ``build_model`` as in the JAX model; the
    annealers follow the flags as JAX's do."""
    lines = _spec_lines()
    assert len(lines) == 12
    built = 0
    for line in lines:
        with pytest.warns(UserWarning, match="--dataset"):
            args = clockwork_audio.build_args(shlex.split(line)[2:])
        assert (args.hidden_size[0], args.num_bits, args.num_mix, args.likelihood) == (192, 16, 10, "DMoL")
        assert args.precision_posterior and not args.residual_posterior and not args.bf16 and args.length_sampler
        n = len(args.strides)
        jmodel = JaxCWVAEAudio(z_size=tuple(args.latent_size), h_size=tuple(args.hidden_size * n),
                               strides=tuple(args.strides), precision_posterior=True, num_mix=10, num_bins=2**16)
        try:
            jax_rf = jmodel.overall_receptive_field
        except (AssertionError, ValueError) as err:
            with pytest.raises(type(err), match=str(err)[:16]):
                clockwork_audio.build_model(args, device="cpu")
            assert tuple(args.strides) in ((64, 8), (256,), (256, 8))
            continue
        model = clockwork_audio.build_model(args, device="cpu")
        built += 1
        assert tuple(args.strides) == (64,) and model.overall_receptive_field == jax_rf == 85
        cell = model.cwvae.cells[0]
        assert (cell.h_dim, cell.z_dim, cell.c_dim, cell.precision_posterior) == (192, 128, 0, True)
        assert model.cwvae.likelihood.num_bins == 2**16 and model.cwvae.likelihood.num_mix == 10
        blocks = model.cwvae.encoder.levels[0]
        assert [(b.stride, b.transposed) for b in blocks] == [(4, False)] * 3
        assert blocks[0]._DepthwiseSeparable_0.depthwise_kernel.shape == (5, 1, 768)
    assert built == 4
    annealers = clockwork_audio.build_annealers(args)
    jax_annealers = dict(beta=JaxCosineAnnealer(anneal_steps=150000, start_value=0, end_value=1.0),
                         free_nats=JaxCosineAnnealer(anneal_steps=150000, constant_steps=150000, start_value=2.0,
                                                     end_value=0.0))
    for name, annealer in annealers.items():
        assert [annealer.step() for _ in range(3)] == [jax_annealers[name].step() for _ in range(3)]


def test_build_model_runs_on_the_card_unless_asked(monkeypatch):
    """On the card unless given ``device="cpu"``; the unported likelihoods and bf16 coders raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = clockwork_audio.build_args("--hidden_size 8 --latent_size 4 --strides 64".split())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clockwork_audio.build_model(args)
    assert next(clockwork_audio.build_model(args, device="cpu").parameters()).device.type == "cpu"
    for flags, match in (("--likelihood GMM", "GMM"), ("--bf16 true", "bf16")):
        with pytest.raises(NotImplementedError, match=match):
            clockwork_audio.build_model(clockwork_audio.build_args(f"--strides 64 {flags}".split()), device="cpu")


def test_weights_round_trip_flax_names_and_init_rules():
    """``random_jax_params`` -> ``load_jax_params`` -> ``export_jax_params`` gives the same tree; its names and
    shapes are a flax init's (``cwvae.npz``'s names among them); GroupNorm scales are ones and biases zeros, the
    depthwise biases zeros and the RSSM GRU's ``w_hh`` uniform, as flax initializes them."""
    kw = dict(z_size=4, h_size=8, strides=(4, 2), num_level_layers=2, stride_per_layer=2, num_mix=2)
    model = CWVAEAudio(**kw)
    flat = weights.random_jax_params(model, seed=9)
    weights.load_jax_params(model, weights.unflatten(flat))
    back = weights.flatten(weights.export_jax_params(model))
    assert back.keys() == flat.keys()
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name])
    x = np.zeros((1, 16), np.float32)
    variables = jax.eval_shape(lambda: JaxCWVAEAudio(**kw).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, np.array([16], np.int32)))
    assert weights.param_shapes(model) == {k: tuple(v.shape) for k, v in weights.flatten(variables["params"]).items()}
    golden = np.load(GOLDENS / "cwvae.npz")
    assert {k[2:] for k in golden.files if k.startswith("p|")} == set(flat)
    for name, value in flat.items():
        if "/GroupNorm_" in name:
            assert np.all(value == (1.0 if name.endswith("scale") else 0.0)), name
        if name.endswith("depthwise_bias"):
            assert not value.any(), name
    w_hh = flat["cwvae/cell_0/gru_cell/w_hh"]
    assert 0.8 / np.sqrt(8) < np.abs(w_hh).max() <= 1 / np.sqrt(8)
    with pytest.raises(ValueError, match="shapes differ"):
        weights.load_jax_params(model, {**flat, "cwvae/cell_0/gru_cell/w_hh": np.zeros((8, 25), np.float32)})
