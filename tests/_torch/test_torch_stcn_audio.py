"""The port's STCN (``models/stcn.py``) and its driver (``experiments/stcn_audio.py``) against the
JAX package, the frozen golden ``stcn.npz`` and ``experiments/experiment_stcn_audio.py``, on the
CPU, at the golden's size (2 layers a stack, latents (8, 4), 16 channels). Both packages' Gaussian
samplers are at the mean, as the golden is (``patch_modules: ["blvm_tpu.models.stcn.stcn"]``).
Inputs and weights come from numpy seeds; each JAX reference compiles once, in a module-scoped
fixture."""

import json
import shlex
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.models.stcn.stcn as jax_stcn
from blvm_tpu.evaluation.tracker import Tracker as JaxTracker
from blvm_tpu.models import STCN as JaxSTCN
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, stcn_audio
from blvm_tpu_torch.models import STCN
from blvm_tpu_torch.models import stcn as port_stcn
from blvm_tpu_torch.ops.variational import FrameKeys
from blvm_tpu_torch.training.eval_step import make_eval_step

REPO = Path(__file__).resolve().parent.parent.parent
GOLDENS = REPO / "tests" / "parity" / "goldens"
SMALL = dict(likelihood="DMoL", n_layers=2, latent_size=(8, 4), res_channels=16)
LENGTHS = (64, 43)
# name: model keyword arguments, call keyword arguments; inputs of the chunked pass's first chunk's
# length (its last chunk's, with the receptive field ahead, without the rf padding)
FORWARD_CASES = {
    "top_down": (dict(), dict(beta=0.9, free_nats=0.5)),
    "bottom_up": (dict(top_down=False), dict(beta=0.9, free_nats=0.5)),
    "stacked_4": (dict(n_stack_frames=4), dict(beta=1.0, free_nats=0.0)),
    "no_rf_padding": (dict(), dict(pad_receptive_field=False, beta=0.7, free_nats=0.2)),
}
METRICS = ("loss", "elbo", "log_prob", "kld", "mc_kl")
GEN_FRAMES = 25


def _batch(T, seed=1):
    x = np.random.default_rng(seed).uniform(-1, 1, (len(LENGTHS), T)).astype(np.float32)
    lengths = np.asarray([T, T - 21], np.int32)
    x[1, lengths[1]:] = 0.0
    return x, lengths


def _port_model(seed=3, **kwargs):
    model = STCN(**SMALL, **kwargs, device="cpu")
    params = weights.random_jax_params(model, seed)
    weights.load_jax_params(model, params)
    return model, weights.unflatten(params)


def _at_the_mean():
    """Both packages' Gaussian latent samples at their mean."""
    return (mock.patch.object(jax_stcn, "rsample_gaussian", lambda key, mu, sd: mu),
            mock.patch.object(port_stcn, "gaussian_noise", lambda g, shape, like: torch.zeros(shape, dtype=like.dtype)))


def _speech(T, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (2, T)).astype(np.float32)


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's CPU backend optimization level 0: the same program,
    compiled ~4x faster (its runs here take milliseconds); only the order of some sums may differ, as on
    other hardware, well inside the tolerances below."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def _chunks():
    """The chunked pass's utterances, split as ``--random_segment_size 200`` splits them."""
    x, x_sl = _speech(700, 2), np.asarray([700, 555], np.int32)
    model, _ = _port_model()
    return x, x_sl, model.split_sequence(x, x_sl, length=200)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX forward in every case, the rf-chunked pass replayed as ``experiments/common.py:1003-1037``
    runs it, and JAX's fast generation at the mode from a zero and a real history. One compiled forward
    a configuration and padding, its scalars traced: the cases share the chunks' shapes, so each
    compiles once."""
    out, fns = {}, {}
    patch_jax, _ = _at_the_mean()
    _, _, (chunks, lens) = _chunks()
    with patch_jax:
        for name, (model_kw, call_kw) in FORWARD_CASES.items():
            _, params = _port_model(**model_kw)
            pad = call_kw.get("pad_receptive_field", True)
            key = (tuple(sorted(model_kw.items())), pad)
            args = (params, *map(jnp.asarray, _batch(chunks[0 if pad else 1].shape[1])),
                    jnp.float32(call_kw["beta"]), jnp.float32(call_kw["free_nats"]))
            if key not in fns:
                jmodel = JaxSTCN(**SMALL, **model_kw)
                fns[key] = _compiled(lambda p, x_, s_, beta, free_nats, m=jmodel, pad=pad: m.apply(
                    {"params": p}, x_, s_, pad_receptive_field=pad, beta=beta, free_nats=free_nats,
                    rngs={"sample": jax.random.PRNGKey(0)}), *args)
            _, mets, o = fns[key](*args)
            out[name] = jax.tree_util.tree_map(np.asarray, (mets, o.reconstructions_mode))

        _, params = _port_model()
        jmodel = JaxSTCN(**SMALL)
        tracker, per_chunk = JaxTracker(), []
        for i, (xs, sl) in enumerate(zip(chunks, lens)):
            _, mets, _ = fns[((), i == 0)](params, jnp.asarray(xs), jnp.asarray(sl), jnp.float32(1.0), jnp.float32(0.0))
            per_chunk.append(float(mets["loss"]))
            tracker.update(JaxSTCN.build_metrics(jmodel, jax.device_get(mets)), source="test")
        out["chunked"] = dict(tracker.values["test"]), per_chunk

        history = _speech(48, 4)
        gen = _compiled(lambda p, h: jmodel.apply(
            {"params": p}, n_samples=2, max_timesteps=GEN_FRAMES, use_mode_observations=True, x=h,
            rngs={"sample": jax.random.PRNGKey(0)}, method=JaxSTCN.generate), params, jnp.asarray(history))
        # a zero history of 48 frames is the zero window of rf frames
        for hist, h in (("zero", np.zeros_like(history)), ("speech", history)):
            out[("generate", hist)] = np.asarray(gen(params, jnp.asarray(h))[0][0])
        out["history"] = history
    return out


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_stcn_forward_matches_jax(jax_side, case):
    """Loss, per-example elbo, log_prob, kld and mc_kl, each level's KL and the reconstruction's mode
    against the JAX forward at the mean in f32: the JAX parity suite's tolerances (loss rtol 1e-5,
    the per-example sums rtol 1e-4 with atol 1e-3 on values of ~1e3 nats, the mode 1e-5)."""
    model_kw, call_kw = FORWARD_CASES[case]
    model, _ = _port_model(**model_kw)
    _, _, (chunks, _) = _chunks()
    x, x_sl = _batch(chunks[0 if call_kw.get("pad_receptive_field", True) else 1].shape[1])
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, out = model(torch.from_numpy(x), torch.from_numpy(x_sl), **call_kw)
    jmets, jmode = jax_side[case]
    np.testing.assert_allclose(float(loss), float(jmets["loss"]), rtol=1e-5, atol=1e-6)
    for name in METRICS[1:]:
        np.testing.assert_allclose(mets[name].numpy(), jmets[name], rtol=1e-4, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(mets["klds"].numpy().T, np.stack(jmets["klds"]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out.reconstructions_mode.numpy(), jmode, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(mets["x_sl"].numpy(), jmets["x_sl"])
    assert out.reconstructions.shape == out.reconstructions_mode.shape and len(out.z_sl) == 2


def test_frozen_stcn_golden():
    """``tests/parity/goldens/stcn.npz`` (beta 0.9, free nats 0.5): the torch reference's loss and
    per-example elbo, log-probability and KL at ``tests/parity/test_goldens.py``'s tolerances (loss
    rtol 5e-5, metrics rtol 2e-4)."""
    data = np.load(GOLDENS / "stcn.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    assert meta["patch_modules"] == ["blvm_tpu.models.stcn.stcn"] and meta["call_kwargs"] == dict(beta=0.9, free_nats=0.5)
    model = STCN(**meta["kwargs"], device="cpu")
    weights.load_jax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p|")})
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, _ = model(torch.from_numpy(data["x"]), torch.from_numpy(data["x_sl"]), **meta["call_kwargs"])
    np.testing.assert_allclose(float(loss), float(data["g|loss"]), rtol=5e-5, atol=1e-5)
    for name, key in (("elbo", "elbo"), ("log_prob", "log_prob"), ("kld", "kl")):
        if f"g|{key}" in data.files:
            np.testing.assert_allclose(mets[name].numpy(), data[f"g|{key}"], rtol=2e-4, atol=2e-3, err_msg=name)


def test_rf_chunked_test_pass_matches_jax(jax_side):
    """``--split_eval``: chunks of ``--random_segment_size`` samples overlapping by the receptive field,
    the first rf-padded, beta 1 and free nats 0 threaded into every forward, against the same loop over
    the JAX forward: every chunk's loss and the tracker's values (rtol 1e-5); the whole pass scores the
    same frames, so its bits per x agree with the chunks' (rtol 1e-5)."""
    jvalues, jlosses = jax_side["chunked"]
    model, _ = _port_model()
    args = stcn_audio.build_args("--num_layers 2 --latent_size 8 4 --hidden_size 16 --random_segment_size 200 "
                                 "--split_eval true".split())
    x, x_sl, _ = _chunks()
    losses = []

    def eval_step(model_, generator, batch, scalars):
        mets, out = make_eval_step(common.loss_fn)(model_, generator, batch, scalars)
        losses.append(float(mets["loss"]))
        return mets, out

    tracker = Tracker()
    _, patch_port = _at_the_mean()
    with patch_port:
        stcn_audio.make_rf_chunked_eval(model, args)(eval_step, model, None, x, x_sl, {}, tracker, "test")
        whole = stcn_audio.evaluate(model, stcn_audio.build_args("--num_layers 2 --latent_size 8 4 --hidden_size 16"
                                                                 .split()), [(x, x_sl)], Tracker())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert len(losses) == 4
    for key, value in jvalues.items():
        np.testing.assert_allclose(tracker.values["test"][key], value, rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(whole["rec (bpx)"], tracker.values["test"]["rec (bpx)"], rtol=1e-5)


@pytest.mark.parametrize("history", ["zero", "speech"])
def test_generation_matches_jax(jax_side, history):
    """``use_mode_observations`` with z at the prior mean, 25 frames: the windowed path and the plain
    fast loop (``_generate_fast_plain``, K12's twin) each against JAX's fast generation (f32, 1e-5;
    JAX's own suite holds its fast path to its windowed one, ``tests/models/test_stcn.py``)."""
    model, _ = _port_model()
    hist = None if history == "zero" else torch.from_numpy(jax_side["history"])
    eps = torch.zeros(GEN_FRAMES, 2, 12)
    for fast in (True, False):
        (x, x_sl), _ = model.generate(2, GEN_FRAMES, use_mode_observations=True, x=hist, fast=fast, eps=eps)
        assert x.shape == (2, GEN_FRAMES) and x_sl.tolist() == [GEN_FRAMES] * 2
        np.testing.assert_allclose(x.numpy(), jax_side[("generate", history)], atol=1e-5, rtol=0)


def test_fast_loop_records_and_teacher_forcing():
    """The plain fast loop's record (each frame's z and DMoL parameters) is what the forward of the
    same frames computes at the prior: teacher forcing with its own frames changes nothing, and the
    conditioning columns of the prime are the forward's ``d_p`` at the window's end (1e-5)."""
    model, _ = _port_model()
    n = 12
    hist = torch.from_numpy(_speech(48, 4))
    g = torch.Generator().manual_seed(3)
    eps = torch.randn(n, 2, 12, generator=g)
    uniforms = (torch.rand(n, 2, 10, generator=g), torch.rand(n, 2, 1, generator=g))
    with torch.no_grad():
        window = model._window(2, hist)
        enc_tails, dec_tails, d0 = model._prime(window)
        args = (window[:, -1:], d0, enc_tails, dec_tails, n, eps, FrameKeys(None, torch.device("cpu"), uniforms))
        x, z, params = model._generate_fast_plain(*args)
        x_f, z_f, params_f = model._generate_fast_plain(*args, forced=x)
        rf = model.receptive_field
        full = torch.nn.functional.pad(hist[..., None], (0, 0, rf, 0))
        skips = model.res_stack(model.causal(full, pad_causal=False), skip_size=48 + 1, skip_mask=model.skip_mask)
    assert torch.equal(x, x_f) and torch.equal(z, z_f) and torch.equal(params, params_f)
    assert z.shape == (n, 2, 12) and params.shape == (n, 2, 30) and (params[..., 20:] >= -7.0).all()
    for level, block in enumerate(model.used_blocks):
        np.testing.assert_allclose(d0[level][:, 0].numpy(), skips[block][:, -1].numpy(), atol=1e-5, rtol=1e-5)


def test_generation_hook_writes_two_clips():
    args = stcn_audio.build_args("--num_layers 2 --latent_size 8 4 --hidden_size 16 --generate_every 2 "
                                 "--generate_frames 30".split())
    model = stcn_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    hook = stcn_audio.make_generation_hook(model, args)
    assert hook(3, "unused") == []
    with mock.patch.object(common, "save_wav") as save:
        paths = hook(4, Path("run"), generator=torch.Generator().manual_seed(0))
    assert [p.as_posix() for p in paths] == ["run/audio/epoch0004_generated_0.wav", "run/audio/epoch0004_generated_1.wav"]
    assert [call.args[1].shape for call in save.call_args_list] == [(30,), (30,)]
    assert all(np.abs(call.args[1]).max() <= 1 for call in save.call_args_list)


def test_benchmark_stcn_specs_parse_and_build():
    """Every STCN run spec of ``experiments/benchmarks.txt`` (``:26-30``, ``:46``, ``:58``, ``:78-82``)
    parses (unused flags warn) into the JAX driver's model: 256 channels, 5 blocks a stack, DMoL over
    2^16 bins, f32, dense top-down with the precision-weighted posterior; the annealers follow the
    flags. ``:26`` is the slice's s = 1 spec."""
    lines = [line for line in (REPO / "experiments" / "benchmarks.txt").read_text().splitlines()
             if line.startswith("python experiments/experiment_stcn_audio.py")]
    assert len(lines) == 12
    for line in lines:
        with pytest.warns(UserWarning, match="--dataset"):
            args = stcn_audio.build_args(shlex.split(line)[2:])
        assert (args.hidden_size, args.num_layers, args.num_bits, args.likelihood) == (256, 5, 16, "DMoL")
        assert args.dense and args.top_down and args.precision_posterior and not args.bf16
        annealers = stcn_audio.build_annealers(args)
        assert annealers["free_nats"].constant_steps == args.free_nats_steps // 2
    args = stcn_audio.build_args(shlex.split(lines[0])[2:])
    assert (args.num_stack_frames, tuple(args.latent_size), args.random_segment_size) == (1, (256, 128, 64, 32, 16), 1000)
    assert args.accum_steps == 4 and args.batch_size == 20
    with torch.device("meta"):
        model = stcn_audio.build_model(args, device="meta")
    # out_rf counts the decode stack as JAX does, with dilations 1, 1, 2, 4, 8: 17 (the stack itself runs at 1)
    assert model.receptive_field == 157 and model.used_blocks == [4, 9, 14, 19, 24] and model.out_rf == 17
    assert sum(model.skip_mask) == 5 and model.out_transform.Conv1d_0.kernel.shape == (1, 496, 256)


def test_build_model_runs_on_the_card_unless_asked(monkeypatch):
    """On the card unless given ``device="cpu"``; the unported likelihoods raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = stcn_audio.build_args("--num_layers 2 --latent_size 8 4 --hidden_size 16".split())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stcn_audio.build_model(args)
    assert next(stcn_audio.build_model(args, device="cpu").parameters()).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="GMM"):
        stcn_audio.build_model(stcn_audio.build_args("--num_layers 2 --latent_size 8 --likelihood GMM".split()),
                               device="cpu")


def test_weights_round_trip_flax_names():
    """``random_jax_params`` -> ``load_jax_params`` -> ``export_jax_params`` gives the same tree; its
    names and shapes are a flax init's, ``stcn.npz``'s names among them."""
    model = STCN(**SMALL, device="cpu")
    flat = weights.random_jax_params(model, seed=9)
    weights.load_jax_params(model, weights.unflatten(flat))
    back = weights.flatten(weights.export_jax_params(model))
    assert back.keys() == flat.keys()
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name])
    x = np.zeros((1, 40), np.float32)
    variables = jax.eval_shape(lambda: JaxSTCN(**SMALL).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, np.array([40], np.int32)))
    assert weights.param_shapes(model) == {k: tuple(v.shape) for k, v in weights.flatten(variables["params"]).items()}
    golden = np.load(GOLDENS / "stcn.npz")
    assert {k[2:] for k in golden.files if k.startswith("p|")} == set(flat)


# benchmarks.txt:27's geometry scaled down: one latent level over 5 stacks of 2 blocks, whose only read skip is block
# 0's; stacked 4 frames a step (the forward and the test pass) and 1 (generation: JAX's windowed generation raises
# at more than one frame a step)
ONE_LEVEL = dict(likelihood="DMoL", n_layers=2, n_stacks=5, latent_size=(8,), res_channels=16)


def _one_level(n_stack_frames):
    model = STCN(**ONE_LEVEL, n_stack_frames=n_stack_frames, device="cpu")
    params = weights.random_jax_params(model, 11)
    weights.load_jax_params(model, params)
    return model, weights.unflatten(params)


@pytest.fixture(scope="module")
def jax_one_level():
    """The JAX forward of the stacked one-level model and the JAX fast generation of the unstacked one at the
    mode, one compile each."""
    patch_jax, _ = _at_the_mean()
    x, x_sl = _batch(240, seed=9)
    with patch_jax:
        _, params = _one_level(4)
        jmodel = JaxSTCN(**ONE_LEVEL, n_stack_frames=4)
        fn = _compiled(lambda p, x_, s_: jmodel.apply({"params": p}, x_, s_, beta=1.0, free_nats=0.0,
                                                      rngs={"sample": jax.random.PRNGKey(0)}), params, x, x_sl)
        _, mets, o = fn(params, x, x_sl)
        _, params1 = _one_level(1)
        jmodel1 = JaxSTCN(**ONE_LEVEL)
        gen = _compiled(lambda p: jmodel1.apply({"params": p}, n_samples=2, max_timesteps=GEN_FRAMES,
                                                use_mode_observations=True, rngs={"sample": jax.random.PRNGKey(0)},
                                                method=JaxSTCN.generate), params1)(params1)
    return (x, x_sl), jax.tree_util.tree_map(np.asarray, (mets, o.reconstructions_mode)), np.asarray(gen[0][0])


def test_one_level_stack_stops_after_its_only_read_skip(jax_one_level):
    """A one-level STCN reads block 0's skip only, so the encoder stack runs block 0 alone (the 9 after it reach no
    output, as XLA drops them from JAX's loop), in the forward, the test pass and the windowed generation, while the
    numbers stay JAX's: the forward's loss and metrics (rtol 1e-5), the driver's test pass built from them, and the
    generation at the mode (windowed and fast) against JAX's (1e-5). Fast generation's prime still steps every
    block: the frame loop reads every block's buffer."""
    from blvm_tpu_torch.models.wavenet.modules import Conv1dResidualGLU

    (x, x_sl), (jmets, jmode), jgen = jax_one_level
    ran = []
    forward = Conv1dResidualGLU.forward

    def counting(self, *args, **kwargs):
        ran.append(self)
        return forward(self, *args, **kwargs)

    model, _ = _one_level(4)
    encoder = model.res_stack.blocks
    _, patch_port = _at_the_mean()
    with patch_port, mock.patch.object(Conv1dResidualGLU, "forward", counting), torch.no_grad():
        loss, mets, out = model(torch.from_numpy(x), torch.from_numpy(x_sl))
        assert [b for b in ran if b in encoder] == [encoder[0]] and len(encoder) == 10
        args = stcn_audio.build_args("--num_layers 2 --num_stacks 5 --latent_size 8 --hidden_size 16 "
                                     "--num_stack_frames 4".split())
        values = stcn_audio.evaluate(model, args, [(x, x_sl)], Tracker())
        model1, _ = _one_level(1)
        encoder1, ran[:] = model1.res_stack.blocks, []
        (windowed, _), _ = model1.generate(2, GEN_FRAMES, use_mode_observations=True, fast=False,
                                           eps=torch.zeros(GEN_FRAMES, 2, 8))
        assert [b for b in ran if b in encoder1] == [encoder1[0]] * GEN_FRAMES
        ran[:] = []
        (fast, _), _ = model1.generate(2, GEN_FRAMES, use_mode_observations=True, eps=torch.zeros(GEN_FRAMES, 2, 8))
        assert [b for b in ran if b in encoder1] == list(encoder1)
    np.testing.assert_allclose(float(loss), float(jmets["loss"]), rtol=1e-5, atol=1e-6)
    for name in METRICS[1:]:
        np.testing.assert_allclose(mets[name].numpy(), jmets[name], rtol=1e-4, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(out.reconstructions_mode.numpy(), jmode, atol=1e-5, rtol=1e-5)
    tracker = JaxTracker()
    tracker.update(JaxSTCN.build_metrics(JaxSTCN(**ONE_LEVEL, n_stack_frames=4), jmets), source="test")
    for key, value in tracker.values["test"].items():
        np.testing.assert_allclose(values[key], value, rtol=1e-5, atol=1e-7, err_msg=key)
    for got in (windowed, fast):
        np.testing.assert_allclose(got.numpy(), jgen, atol=1e-5, rtol=0)
