"""The port's SRNNAudio (``models/srnn.py``) and its driver (``experiments/srnn_audio.py``)
against the JAX package, the frozen golden ``srnn.npz`` and ``experiments/experiment_srnn_audio.py``,
on the CPU. Both packages' Gaussian samplers are at the mean, as the golden is
(``patch_modules: ["blvm_tpu.models.srnn"]``). Inputs and weights come from numpy seeds; each
JAX reference compiles once, in a module-scoped fixture."""

import json
import shlex
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.models.srnn as jax_srnn
from blvm_tpu.evaluation.tracker import Tracker as JaxTracker
from blvm_tpu.models import SRNNAudio as JaxSRNNAudio
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, srnn_audio
from blvm_tpu_torch.models import SRNNAudio
from blvm_tpu_torch.models import srnn as port_srnn
from blvm_tpu_torch.training.eval_step import make_eval_step

REPO = Path(__file__).resolve().parent.parent.parent
GOLDENS = REPO / "tests" / "parity" / "goldens"
SMALL = dict(likelihood="DMoL", input_size=8, hidden_size=16, latent_size=4)
B, T, R = 3, 128, 32  # 16 stacks of 8; r_dim = 2 * hidden_size
# name: (smoothing, lengths, a given d_0 and z_0); the driver's residual posterior
FORWARD_CASES = {
    "smoothing_ragged_with_a_zero_length_row": (True, np.asarray([128, 100, 0]), False),
    "smoothing_given_state": (True, np.asarray([128, 77, 41]), True),
    "no_smoothing_given_state_and_a_zero_length_row": (False, np.asarray([128, 61, 0]), True),
}
METRICS = ("loss", "elbo", "log_prob", "kl", "mc_kl")


def _batch(lengths, T_, seed):
    x = np.random.default_rng(seed).uniform(-1, 1, (len(lengths), T_)).astype(np.float32)
    for row, n in enumerate(lengths):
        x[row, n:] = 0.0
    return x, np.asarray(lengths, np.int32)


def _state(seed=2, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(batch, R)).astype(np.float32),
            rng.normal(scale=0.5, size=(batch, SMALL["latent_size"])).astype(np.float32))


def _port_model(smoothing=True):
    model = SRNNAudio(**SMALL, residual_posterior=True, smoothing=smoothing)
    params = weights.random_jax_params(model, seed=3 + smoothing)
    weights.load_jax_params(model, params)
    return model, params


def _at_the_mean():
    """Both packages' Gaussian latent samples at their mean."""
    return (mock.patch.object(jax_srnn, "rsample_gaussian", lambda key, mu, sd: mu),
            mock.patch.object(port_srnn, "gaussian_noise", lambda g, shape, like: torch.zeros(shape, dtype=like.dtype)))


def _carry_batch():
    return _batch([300, 210, 97], 300, seed=5)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX forward (one compile a smoothing setting at (B, T)) over every forward case, the
    state-carry pass replayed as ``experiment_srnn_audio.py:103-116`` runs it, and the JAX
    generation at the mode."""
    out = {}
    patch_jax, _ = _at_the_mean()
    forwards = {}
    with patch_jax:
        for smoothing in (True, False):
            _, params = _port_model(smoothing)
            jmodel = JaxSRNNAudio(**SMALL, residual_posterior=True, smoothing=smoothing)
            forwards[smoothing] = jax.jit(lambda x_, sl_, d_, z_, p=weights.unflatten(params), m=jmodel: m.apply(
                {"params": p}, x_, sl_, d_0=d_, z_0=z_, rngs={"sample": jax.random.PRNGKey(0)}))
        for name, (smoothing, lengths, given) in FORWARD_CASES.items():
            d0, z0 = _state() if given else (np.zeros_like(a) for a in _state())
            _, mets, o = forwards[smoothing](*_batch(lengths, T, seed=1), d0, z0)
            out[name] = jax.tree_util.tree_map(np.asarray, (mets, o.d_n, o.a_n, o.z_n, o.z, o.reconstructions_mode))

        x, x_sl = _carry_batch()
        jmodel = JaxSRNNAudio(**SMALL, residual_posterior=True)
        chunks, lens = jmodel.split_sequence(x, x_sl, length=16 * SMALL["input_size"])
        tracker = JaxTracker()
        d0, z0 = np.zeros((B, R), np.float32), np.zeros((B, SMALL["latent_size"]), np.float32)
        for xs, sl in zip(chunks, lens):
            _, mets, o = forwards[True](jnp.asarray(xs), jnp.asarray(sl), d0, z0)
            d0, z0 = o.d_n, o.z_n
            tracker.update(JaxSRNNAudio.build_metrics(jax.device_get(mets)), source="test")
        out["carry"] = dict(tracker.values["test"]), np.asarray(d0), np.asarray(z0), len(chunks)

        _, params = _port_model()
        prime = np.random.default_rng(4).uniform(-1, 1, (2, SMALL["input_size"], 1)).astype(np.float32)
        (gen, _), _ = jax.jit(lambda p_: jmodel.apply({"params": p_}, n_samples=2, max_timesteps=8, use_mode=True,
                                                      x=prime, rngs={"sample": jax.random.PRNGKey(0)},
                                                      method=JaxSRNNAudio.generate))(weights.unflatten(params))
        out["generate"] = prime, np.asarray(gen)
    return out


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_srnn_audio_matches_jax(jax_side, case):
    """Loss, per-example elbo, log_prob, kl (the true KL) and mc_kl, the carried states ``d_n``
    (frozen at each length), ``a_n`` and ``z_n`` (after all T' steps), the latents and the
    reconstruction's mode against the JAX forward at the mean in f32: rtol 1e-5 on the loss and
    the metrics (atol 1e-4 on the per-example sums of ~128 frames), 1e-5 on states (the products
    sum in another order)."""
    smoothing, lengths, given = FORWARD_CASES[case]
    model, _ = _port_model(smoothing)
    x, x_sl = _batch(lengths, T, seed=1)
    state = dict(zip(("d_0", "z_0"), map(torch.from_numpy, _state()))) if given else {}
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, out = model(torch.from_numpy(x), torch.from_numpy(x_sl), **state)
    jmets, jd_n, ja_n, jz_n, jz, jmode = jax_side[case]
    np.testing.assert_allclose(float(loss), float(jmets["loss"]), rtol=1e-5)
    for name in METRICS[1:]:
        np.testing.assert_allclose(mets[name].numpy(), jmets[name], rtol=1e-5, atol=1e-4, err_msg=name)
    for got, ref in ((out.d_n, jd_n), (out.z_n, jz_n), (out.z, jz), (out.reconstructions_mode, jmode)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    if smoothing:
        np.testing.assert_allclose(out.a_n.numpy(), ja_n, atol=1e-5, rtol=1e-5)
    else:
        assert out.a_n is None and ja_n is None
    assert out.reconstructions.shape == (B, T, 1) and out.z_sl.tolist() == [-(-n // 8) for n in lengths]


def test_frozen_srnn_golden():
    """``tests/parity/goldens/srnn.npz`` (beta 0.8, free nats 1): the torch reference's loss and
    per-example elbo, log-probability and kl at ``tests/parity/test_goldens.py``'s tolerances
    (loss rtol 5e-5, metrics rtol 2e-4)."""
    data = np.load(GOLDENS / "srnn.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    assert meta["patch_modules"] == ["blvm_tpu.models.srnn"]
    model = SRNNAudio(**meta["kwargs"])
    weights.load_jax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p|")})
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, _ = model(torch.from_numpy(data["x"]), torch.from_numpy(data["x_sl"]), **meta["call_kwargs"])
    np.testing.assert_allclose(float(loss), float(data["g|loss"]), rtol=5e-5, atol=1e-5)
    for name in ("elbo", "log_prob", "kl"):
        np.testing.assert_allclose(mets[name].numpy(), data[f"g|{name}"], rtol=2e-4, atol=2e-3, err_msg=name)


def test_state_carry_test_pass_matches_jax(jax_side):
    """``--split_eval``: chunks of 16 stacks, no overlap, ``d_n`` and ``z_n`` carried and ``a``
    from zeros in every chunk (``experiment_srnn_audio.py:92-116``), against the same loop over
    the JAX forward: the tracker's values (rtol 1e-5) and the last chunk's ``d_n``, ``z_n``."""
    jvalues, jd_n, jz_n, n_chunks = jax_side["carry"]
    model, _ = _port_model()
    args = srnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL "
                                 "--split_eval true".split())
    carry = srnn_audio.make_state_carry_eval(model, args)
    tracker = Tracker()
    x, x_sl = _carry_batch()
    _, patch_port = _at_the_mean()
    with patch_port:
        out = carry(make_eval_step(common.loss_fn), model, None, x, x_sl, {}, tracker, "test")
    assert n_chunks == 3
    for key in ("loss", "elbo", "rec", "kl", "bpd", "beta", "free_nats"):
        np.testing.assert_allclose(tracker.values["test"][key], jvalues[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(out.d_n.numpy(), jd_n, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.z_n.numpy(), jz_n, atol=1e-5, rtol=1e-5)
    with patch_port:  # the driver's evaluate takes the same path under --split_eval
        values = srnn_audio.evaluate(model, args, [(x, x_sl)], Tracker())
    assert values["bpd"] == tracker.values["test"]["bpd"]


def test_generate_at_the_mode_matches_jax(jax_side):
    """``generate(use_mode=True)`` from the same prime stack, 8 stacks: the JAX rollout's frames
    (the d GRU on ``enc(x)``, the prior step from ``(z, d)``, ``[z, d_t]`` decoded) at atol 1e-5."""
    prime, jgen = jax_side["generate"]
    model, _ = _port_model()
    (x, x_sl), _ = model.generate(n_samples=2, max_timesteps=8, use_mode=True, x=torch.from_numpy(prime))
    assert x.shape == (2, 64, 1) and x_sl.tolist() == [64, 64]
    np.testing.assert_allclose(x.numpy(), jgen, atol=1e-5, rtol=1e-5)


def test_generation_hook_and_supplied_noise():
    """The hook writes 2 sequences of ``--generate_frames // stack_frames`` stacks as wav files; a
    sampled rollout from supplied noise and uniforms is a pure function of them."""
    args = srnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL "
                                 "--input_coding mu_law --generate_every 2 --generate_frames 40".split())
    model = srnn_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    S, steps = 8, 4
    rng = np.random.default_rng(6)
    eps = torch.from_numpy(rng.normal(size=(steps, 2, 4)).astype(np.float32))
    uniforms = tuple(torch.from_numpy(rng.uniform(size=(steps * S, 2, n)).astype(np.float32)) for n in (10, 1))
    (a, _), _ = model.generate(n_samples=2, max_timesteps=steps, eps=eps, uniforms=uniforms)
    (b, _), _ = model.generate(n_samples=2, max_timesteps=steps, eps=eps, uniforms=uniforms)
    (c, _), _ = model.generate(n_samples=2, max_timesteps=steps, eps=-eps, uniforms=uniforms)
    assert torch.equal(a, b) and not torch.equal(a, c) and a.abs().max() <= 1
    hook = srnn_audio.make_generation_hook(model, args)
    assert hook(3, "unused") == []
    with mock.patch.object(common, "save_wav") as save:
        paths = hook(4, Path("run"), generator=torch.Generator().manual_seed(0))
    assert [p.as_posix() for p in paths] == ["run/audio/epoch0004_generated_0.wav", "run/audio/epoch0004_generated_1.wav"]
    assert [call.args[1].shape for call in save.call_args_list] == [(40,), (40,)]


def test_benchmark_srnn_specs_parse_and_build():
    """Every SRNN run spec of ``experiments/benchmarks.txt`` (``:21-23``, ``:75-77``) parses (unused
    flags warn) into the JAX driver's model: H = Z = 256, r_dim 512, the driver's residual posterior
    and smoothing, DMoL over 2^16 bins and 10 mixtures, f32; the annealers follow the flags."""
    lines = [line for line in (REPO / "experiments" / "benchmarks.txt").read_text().splitlines()
             if line.startswith("python experiments/experiment_srnn_audio.py")]
    assert len(lines) == 6
    for line in lines:
        with pytest.warns(UserWarning, match="--dataset"):
            args = srnn_audio.build_args(shlex.split(line)[2:])
        assert (args.hidden_size, args.latent_size, args.num_bits, args.num_mix) == (256, 256, 16, 10)
        assert args.residual_posterior and args.smoothing and not args.bf16 and args.dropout == 0.0
        assert args.stack_frames in (1, 64, 256) and args.likelihood == "DMoL"
        assert (args.max_grad_norm, args.max_grad_value, args.generate_frames) == (3000.0, 1000.0, 128000)
        annealers = srnn_audio.build_annealers(args)
        assert annealers["free_nats"].constant_steps == args.free_nats_steps // 2
        assert annealers["free_nats"].step() == 2.0 and annealers["beta"].step() == 0.0
    srnn = srnn_audio.build_model(args, device="cpu").srnn
    assert srnn.d_forward_recurrent.w_hh.shape == (512, 1536) and srnn.a_backward_recurrent.w_ih.shape == (768, 1536)
    assert srnn.step.residual_posterior and srnn.likelihood.num_bins == 2**16 and srnn.likelihood.num_mix == 10


def test_build_model_runs_on_the_card_unless_asked(monkeypatch):
    """On the card unless given ``device="cpu"``; the unported likelihoods raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = srnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL".split())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srnn_audio.build_model(args)
    assert next(srnn_audio.build_model(args, device="cpu").parameters()).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="GMM"):
        srnn_audio.build_model(srnn_audio.build_args("--stack_frames 8 --hidden_size 16".split()), device="cpu")


@pytest.mark.parametrize("smoothing", [True, False])
def test_weights_round_trip_flax_names_and_uniform_grus(smoothing):
    """``random_jax_params`` -> ``load_jax_params`` -> ``export_jax_params`` gives the same tree;
    its names and shapes are a flax init's (``srnn.npz``'s names among them), and every
    parameter of both GRUs takes the recurrent rule U(-1/sqrt(R), 1/sqrt(R)), ``w_hh`` too: neither
    has ``orthogonal_hh`` (``blvm_tpu/models/srnn.py:125-128``)."""
    model = SRNNAudio(**SMALL, smoothing=smoothing)
    flat = weights.random_jax_params(model, seed=9)
    weights.load_jax_params(model, weights.unflatten(flat))
    back = weights.flatten(weights.export_jax_params(model))
    assert back.keys() == flat.keys()
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name])
    x = np.zeros((1, 16), np.float32)
    variables = jax.eval_shape(lambda: JaxSRNNAudio(**SMALL, smoothing=smoothing).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, np.array([16], np.int32)))
    assert weights.param_shapes(model) == {k: tuple(v.shape) for k, v in weights.flatten(variables["params"]).items()}
    if smoothing:
        golden = np.load(GOLDENS / "srnn.npz")
        assert {k[2:] for k in golden.files if k.startswith("p|")} == set(flat)
    # an orthogonal (32, 96) w_hh has entries of scale 1/sqrt(96) whose largest exceeds 1/sqrt(32)
    grus = ("d_forward_recurrent", "a_backward_recurrent") if smoothing else ("d_forward_recurrent",)
    for gru in grus:
        for leaf in ("w_ih", "b_ih", "w_hh", "b_hh"):
            bound = np.abs(flat[f"srnn/{gru}/{leaf}"]).max()
            assert 0.8 / np.sqrt(R) < bound <= 1 / np.sqrt(R), (gru, leaf)
