"""The port's VRNNAudio (``models/vrnn.py``) and its driver (``experiments/vrnn_audio.py``)
against the JAX package, the frozen golden ``vrnn.npz`` and ``experiments/experiment_vrnn_audio.py``,
on the CPU. Both packages' Gaussian samplers are patched to the mean, as the goldens are
(``tests/parity/test_goldens.py:48-51``). Inputs and weights come from numpy seeds; each JAX
reference compiles once, in a module-scoped fixture."""

import json
import shlex
import wave
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.models.vrnn as jax_vrnn
from blvm_tpu.evaluation.tracker import Tracker as JaxTracker
from blvm_tpu.models import VRNNAudio as JaxVRNNAudio
from blvm_tpu.ops.sequence import split_sequence as jax_split_sequence
from blvm_tpu.training.annealers import CosineAnnealer as JaxCosineAnnealer
from blvm_tpu_torch import weights
from blvm_tpu_torch.data.transforms import MuLawDecode
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, vrnn_audio
from blvm_tpu_torch.models import VRNNAudio
from blvm_tpu_torch.models import vrnn as port_vrnn
from blvm_tpu_torch.training.annealers import CosineAnnealer
from blvm_tpu_torch.training.eval_step import make_eval_step

REPO = Path(__file__).resolve().parent.parent.parent
GOLDENS = REPO / "tests" / "parity" / "goldens"
SMALL = dict(likelihood="DMoL", input_size=8, hidden_size=16, latent_size=4)
B, T = 3, 128  # 16 stacks of 8
# name: (lengths, a given h0); the driver's residual posterior (the golden holds the class default, without)
FORWARD_CASES = {
    "ragged": (np.asarray([128, 100, 41]), False),
    "given_h0_and_a_padding_row": (np.asarray([128, 77, 0]), True),
}
METRICS = ("loss", "elbo", "log_prob", "kl", "mc_kl")


def _batch(lengths, T_, seed):
    x = np.random.default_rng(seed).uniform(-1, 1, (len(lengths), T_)).astype(np.float32)
    for row, n in enumerate(lengths):
        x[row, n:] = 0.0
    return x, np.asarray(lengths, np.int32)


def _h0(seed=2, batch=B):
    return np.random.default_rng(seed).normal(scale=0.5, size=(batch, 2 * SMALL["hidden_size"])).astype(np.float32)


def _port_model():
    model = VRNNAudio(**SMALL, residual_posterior=True)
    params = weights.random_jax_params(model, seed=3)
    weights.load_jax_params(model, params)
    return model, params


def _at_the_mean():
    """Both packages' Gaussian latent samples at their mean."""
    return (mock.patch.object(jax_vrnn, "rsample_gaussian", lambda key, mu, sd: mu),
            mock.patch.object(port_vrnn, "gaussian_noise", lambda g, shape, like: torch.zeros(shape, dtype=like.dtype)))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX forward (one compile at (B, T)) over every forward case and every chunk of the
    state-carry pass, and the JAX generation at the mode."""
    out = {}
    patch_jax, _ = _at_the_mean()
    _, params = _port_model()
    jmodel = JaxVRNNAudio(**SMALL, residual_posterior=True)
    with patch_jax:
        forward = jax.jit(lambda x_, sl_, h_: jmodel.apply({"params": weights.unflatten(params)}, x_, sl_, h0=h_,
                                                           rngs={"sample": jax.random.PRNGKey(0)}))
        for name, (lengths, given) in FORWARD_CASES.items():
            _, mets, o = forward(*_batch(lengths, T, seed=1), _h0() if given else np.zeros_like(_h0()))
            out[name] = jax.tree_util.tree_map(np.asarray, (mets, o.h_n, o.reconstructions_mode, o.z))

        x, x_sl = _carry_batch()
        chunks, lens = jax_split_sequence(x, x_sl, length=16 * SMALL["input_size"], overlap=0)
        tracker, h0 = JaxTracker(), np.zeros_like(_h0())
        for xs, sl in zip(chunks, lens):
            _, mets, o = forward(jnp.asarray(xs), jnp.asarray(sl), h0)
            h0 = o.h_n
            tracker.update(JaxVRNNAudio.build_metrics(jax.device_get(mets)), source="test")
        out["carry"] = dict(tracker.values["test"]), np.asarray(h0), len(chunks)

        prime = np.random.default_rng(4).uniform(-1, 1, (2, SMALL["input_size"], 1)).astype(np.float32)
        (gen, _), _ = jax.jit(lambda p_: jmodel.apply({"params": p_}, n_samples=2, max_timesteps=5, use_mode=True,
                                                      x=prime, rngs={"sample": jax.random.PRNGKey(0)},
                                                      method=JaxVRNNAudio.generate))(weights.unflatten(params))
        out["generate"] = prime, np.asarray(gen)
    return out


def _carry_batch():
    return _batch([300, 210, 97], 300, seed=5)


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_vrnn_audio_matches_jax(jax_side, case):
    """Loss, per-example elbo, log_prob, kl (free-nats-discounted: 0 here) and mc_kl, the stale
    ``h_n`` (the state entering the last step), the latents and the reconstruction's mode against
    the JAX forward at the mean in f32: rtol 1e-5 on the loss, atol 1e-4 on the per-example sums
    of ~128 frames, 1e-5 on states (the products sum in another order)."""
    lengths, given = FORWARD_CASES[case]
    model, _ = _port_model()
    x, x_sl = _batch(lengths, T, seed=1)
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, out = model(torch.from_numpy(x), torch.from_numpy(x_sl),
                                h0=torch.from_numpy(_h0()) if given else None)
    jmets, jh_n, jmode, jz = jax_side[case]
    np.testing.assert_allclose(float(loss), float(jmets["loss"]), rtol=1e-5)
    for name in METRICS[1:]:
        np.testing.assert_allclose(mets[name].numpy(), jmets[name], rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(out.h_n.numpy(), jh_n, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.z.numpy(), jz, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.reconstructions_mode.numpy(), jmode, atol=1e-5, rtol=1e-5)
    assert out.reconstructions.shape == (B, T, 1) and out.z_sl.tolist() == [-(-n // 8) for n in lengths]


def test_frozen_vrnn_golden():
    """``tests/parity/goldens/vrnn.npz`` (beta 0.7, free nats 2): the torch reference's loss
    and per-example elbo, log-probability and kl at ``tests/parity/test_goldens.py:66-71``'s
    tolerances (loss rtol 5e-5, metrics rtol 2e-4)."""
    data = np.load(GOLDENS / "vrnn.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    model = VRNNAudio(**meta["kwargs"])
    weights.load_jax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p|")})
    _, patch_port = _at_the_mean()
    with patch_port, torch.no_grad():
        loss, mets, _ = model(torch.from_numpy(data["x"]), torch.from_numpy(data["x_sl"]), **meta["call_kwargs"])
    np.testing.assert_allclose(float(loss), float(data["g|loss"]), rtol=5e-5, atol=1e-5)
    for name in ("elbo", "log_prob", "kl"):
        np.testing.assert_allclose(mets[name].numpy(), data[f"g|{name}"], rtol=2e-4, atol=2e-3, err_msg=name)


def test_state_carry_test_pass_matches_jax(jax_side):
    """``--split_eval``: chunks of 16 stacks, no overlap, ``h_n`` carried
    (``experiment_vrnn_audio.py:116-137``), against the same loop over the JAX forward: the
    tracker's loss, elbo, rec, kl and bpd (rtol 1e-5) and the last chunk's ``h_n``."""
    jvalues, jh_n, n_chunks = jax_side["carry"]
    model, _ = _port_model()
    args = vrnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL "
                                 "--split_eval true".split())
    carry = vrnn_audio.make_state_carry_eval(model, args)
    tracker = Tracker()
    x, x_sl = _carry_batch()
    _, patch_port = _at_the_mean()
    with patch_port:
        out = carry(make_eval_step(common.loss_fn), model, None, x, x_sl, {}, tracker, "test")
    assert n_chunks == 3
    for key in ("loss", "elbo", "rec", "kl", "bpd", "beta", "free_nats"):
        np.testing.assert_allclose(tracker.values["test"][key], jvalues[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(out.h_n.numpy(), jh_n, atol=1e-5, rtol=1e-5)
    with patch_port:  # the driver's evaluate takes the same path under --split_eval
        values = vrnn_audio.evaluate(model, args, [(x, x_sl)], Tracker())
    assert values["bpd"] == tracker.values["test"]["bpd"]


def test_generate_at_the_mode_matches_jax(jax_side):
    """``generate(use_mode=True)`` from the same prime stack, 5 stacks: the JAX rollout's frames
    at atol 1e-5."""
    prime, jgen = jax_side["generate"]
    model, _ = _port_model()
    (x, x_sl), _ = model.generate(n_samples=2, max_timesteps=5, use_mode=True, x=torch.from_numpy(prime))
    assert x.shape == (2, 40, 1) and x_sl.tolist() == [40, 40]
    np.testing.assert_allclose(x.numpy(), jgen, atol=1e-5, rtol=1e-5)


def test_generation_from_supplied_noise_is_its_own_replay():
    """A sampled rollout from supplied prior noise and DMoL uniforms is a pure function of them:
    the same draws give the same frames, other draws other frames."""
    S, steps = SMALL["input_size"], 4
    model, _ = _port_model()
    rng = np.random.default_rng(6)
    eps = torch.from_numpy(rng.normal(size=(steps, 2, SMALL["latent_size"])).astype(np.float32))
    uniforms = tuple(torch.from_numpy(rng.uniform(size=(steps * S, 2, n)).astype(np.float32)) for n in (10, 1))
    (a, _), _ = model.generate(n_samples=2, max_timesteps=steps, eps=eps, uniforms=uniforms)
    (b, _), _ = model.generate(n_samples=2, max_timesteps=steps, eps=eps, uniforms=uniforms)
    (c, _), _ = model.generate(n_samples=2, max_timesteps=steps, eps=-eps, uniforms=uniforms)
    assert torch.equal(a, b) and not torch.equal(a, c) and a.abs().max() <= 1


def test_generation_hook_writes_two_wav_files(tmp_path):
    """Every ``--generate_every`` epochs: 2 sequences of ``--generate_frames // stack_frames``
    stacks, mu-law decoded, as ``audio/epoch{epoch:04d}_generated_{i}.wav``."""
    args = vrnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL "
                                 "--input_coding mu_law --generate_every 2 --generate_frames 40".split())
    model = vrnn_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    hook = vrnn_audio.make_generation_hook(model, args)
    assert hook(3, tmp_path) == []
    paths = hook(4, tmp_path, generator=torch.Generator().manual_seed(0))
    assert [p.relative_to(tmp_path).as_posix() for p in paths] == [
        "audio/epoch0004_generated_0.wav", "audio/epoch0004_generated_1.wav"]
    (expected, _), _ = model.generate(2, 5, generator=torch.Generator().manual_seed(0))
    for path, samples in zip(paths, MuLawDecode(bits=8)(expected[..., 0].numpy())):
        with wave.open(str(path)) as f:
            assert (f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()) == (1, 2, 16000, 40)
            pcm = np.frombuffer(f.readframes(40), "<i2")
        np.testing.assert_array_equal(pcm, (np.clip(samples, -1, 1) * 32767.0).astype("<i2"))
    off = vrnn_audio.build_args("--stack_frames 8 --likelihood DMoL --generate_every 1 --generate_frames 0".split())
    assert vrnn_audio.make_generation_hook(model, off)(4, tmp_path) == []


def test_benchmark_vrnn_specs_parse_and_build():
    """Every VRNN run spec of ``experiments/benchmarks.txt`` (``:16-18``, ``:72-74``) parses
    (unused flags warn) into the JAX driver's model: H = Z = 256, r_dim 512, the driver's
    residual posterior, DMoL over 2^16 bins and 10 mixtures, f32; the annealers follow the
    flags."""
    lines = [line for line in (REPO / "experiments" / "benchmarks.txt").read_text().splitlines()
             if line.startswith("python experiments/experiment_vrnn_audio.py")]
    assert len(lines) == 6
    for line in lines:
        with pytest.warns(UserWarning, match="--dataset"):
            args = vrnn_audio.build_args(shlex.split(line)[2:])
        assert (args.hidden_size, args.latent_size, args.num_bits, args.num_mix) == (256, 256, 16, 10)
        assert args.residual_posterior and args.condition_h_on_x and args.condition_x_on_h and not args.bf16
        assert args.stack_frames in (1, 64, 256) and args.likelihood == "DMoL"
        assert (args.max_grad_norm, args.max_grad_value, args.generate_frames) == (3000.0, 1000.0, 128000)
        annealers = vrnn_audio.build_annealers(args)
        assert annealers["free_nats"].constant_steps == args.free_nats_steps // 2
        assert annealers["free_nats"].step() == 2.0 and annealers["beta"].step() == 0.0
    model = vrnn_audio.build_model(args, device="cpu")
    cell = model.vrnn.cell
    assert cell.gru.w_hh.shape == (512, 1536) and cell.residual_posterior
    assert model.vrnn.likelihood.num_bins == 2**16 and model.vrnn.likelihood.num_mix == 10


def test_build_model_runs_on_the_card_unless_asked(monkeypatch):
    """On the card unless given ``device="cpu"``; the unported likelihoods raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = vrnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL".split())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vrnn_audio.build_model(args)
    assert next(vrnn_audio.build_model(args, device="cpu").parameters()).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="GMM"):
        vrnn_audio.build_model(vrnn_audio.build_args("--stack_frames 8 --hidden_size 16".split()), device="cpu")


def test_cosine_annealer_matches_jax():
    """The copy against ``blvm_tpu.training.annealers.CosineAnnealer``, step for step."""
    for kwargs in (dict(anneal_steps=7, start_value=0.0, end_value=1.0),
                   dict(anneal_steps=5, constant_steps=5, start_value=2.0, end_value=0.0)):
        ours, ref = CosineAnnealer(**kwargs), JaxCosineAnnealer(**kwargs)
        assert [ours.step() for _ in range(14)] == [ref.step() for _ in range(14)]
        assert ours.state_dict() == ref.state_dict()


def test_weights_round_trip_and_flax_names():
    """``random_jax_params`` -> ``load_jax_params`` -> ``export_jax_params`` gives the same tree;
    its names and shapes are a flax init's, and the GRU's parameters take the recurrent rule
    U(-1/sqrt(R), 1/sqrt(R)) (``blvm_tpu/modules/recurrent.py:32-38``) but for ``w_hh``, which
    is orthogonal (``orthogonal_hh``, ``blvm_tpu/models/vrnn.py:63``)."""
    model = VRNNAudio(**SMALL)
    flat = weights.random_jax_params(model, seed=9)
    weights.load_jax_params(model, weights.unflatten(flat))
    back = weights.flatten(weights.export_jax_params(model))
    assert back.keys() == flat.keys()
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name])
    x = np.zeros((1, 16), np.float32)
    variables = jax.eval_shape(lambda: JaxVRNNAudio(**SMALL).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, np.array([16], np.int32)))
    assert weights.param_shapes(model) == {k: tuple(v.shape) for k, v in weights.flatten(variables["params"]).items()}
    R = 2 * SMALL["hidden_size"]
    for leaf in ("w_ih", "b_ih", "b_hh"):
        bound = np.abs(flat[f"vrnn/cell/gru/{leaf}"]).max()
        assert 0.8 / np.sqrt(R) < bound <= 1 / np.sqrt(R), leaf
    w_hh = flat["vrnn/cell/gru/w_hh"].astype(np.float64)
    np.testing.assert_allclose(w_hh @ w_hh.T, np.eye(R), atol=1e-5)
