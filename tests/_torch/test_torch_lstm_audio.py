"""The port's LSTMAudio (``models/lstm.py``) and its driver (``experiments/lstm_audio.py``)
against the JAX package, the frozen goldens ``lstm.npz`` and ``train_step_lstm.npz``,
and ``experiments/experiment_lstm_audio.py``, on the CPU. Inputs and weights come
from numpy seeds; each JAX reference compiles once, in a module-scoped fixture."""

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

from blvm_tpu.evaluation.tracker import Tracker as JaxTracker
from blvm_tpu.models import LSTMAudio as JaxLSTMAudio
from blvm_tpu.modules.distributions import DiscretizedLogisticMixtureDense as JaxDMoLHead
from blvm_tpu.ops.sequence import split_sequence as jax_split_sequence
from blvm_tpu.training.optim import get_optimizer as jax_get_optimizer
from blvm_tpu_torch import weights
from blvm_tpu_torch.data.transforms import MuLawDecode
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, lstm_audio
from blvm_tpu_torch.models import LSTMAudio
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense
from blvm_tpu_torch.training.eval_step import make_eval_step
from blvm_tpu_torch.training.optim import get_optimizer
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step

REPO = Path(__file__).resolve().parent.parent.parent
GOLDENS = REPO / "tests" / "parity" / "goldens"
SMALL = dict(stack_size=8, hidden_size=16, num_layers=2, num_mix=3, num_bins=256)
B, T = 3, 128  # one chunk of the state-carry pass: 16 stacks of 8
FORWARD_CASES = {
    "ragged": (np.asarray([128, 100, 41]), False),
    "initial_state_and_a_padding_row": (np.asarray([128, 77, 0]), True),
}


def _batch(lengths, T_, seed):
    x = np.random.default_rng(seed).uniform(-1, 1, (len(lengths), T_)).astype(np.float32)
    for row, n in enumerate(lengths):
        x[row, n:] = 0.0
    return x, np.asarray(lengths, np.int32)


def _state(seed, batch=B):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(scale=0.5, size=(SMALL["num_layers"], batch, SMALL["hidden_size"])).astype(np.float32)
                 for _ in range(2))


def _port_model(params=None):
    model = LSTMAudio(**SMALL)
    params = weights.random_jax_params(model, seed=3) if params is None else params
    weights.load_jax_params(model, params)
    return model, params


def _at_the_mode():
    """Both packages' samplers patched to the DMoL mode, so the forwards are deterministic."""
    return (mock.patch.object(JaxDMoLHead, "sample", lambda self, key, params: self.mode(params)),
            mock.patch.object(DiscretizedLogisticMixtureDense, "sample_and_mode",
                              lambda self, g, params: (self.mode(params),) * 2))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX forward (one compile at (B, T)) over every forward case and every chunk of the
    state-carry pass, and the JAX generation at the mode."""
    _, params = _port_model()
    jmodel = JaxLSTMAudio(**SMALL)
    tree = weights.unflatten(params)
    out = {}
    patch_jax, _ = _at_the_mode()
    with patch_jax:
        forward = jax.jit(lambda x_, sl_, s_: jmodel.apply({"params": tree}, x_, sl_, s_0=s_,
                                                           rngs={"sample": jax.random.PRNGKey(0)}))
        zeros = tuple(np.zeros_like(s) for s in _state(0))
        for name, (lengths, initial) in FORWARD_CASES.items():
            _, mets, o = forward(*_batch(lengths, T, seed=1), _state(2) if initial else zeros)
            out[name] = jax.tree_util.tree_map(np.asarray, (mets, o.s_n, o.reconstruction_sample))

        x, x_sl = _carry_batch()
        chunks, lens = jax_split_sequence(x, x_sl, length=16 * SMALL["stack_size"], overlap=0)
        tracker, s_0 = JaxTracker(), zeros
        for xs, sl in zip(chunks, lens):
            _, mets, o = forward(jnp.asarray(xs), jnp.asarray(sl), s_0)
            s_0 = o.s_n
            tracker.update(JaxLSTMAudio.build_metrics(jax.device_get(mets)), source="test")
        out["carry"] = dict(tracker.values["test"]), jax.tree_util.tree_map(np.asarray, s_0), len(chunks)

        prime = np.random.default_rng(4).uniform(-1, 1, (2, SMALL["stack_size"])).astype(np.float32)
        (gen, _), _ = jax.jit(lambda p_: jmodel.apply({"params": p_}, n_samples=2, max_timesteps=5, use_mode=True,
                                                      x=prime, rngs={"sample": jax.random.PRNGKey(0)},
                                                      method=JaxLSTMAudio.generate))(tree)
        out["generate"] = prime, np.asarray(gen)
    return out


def _carry_batch():
    return _batch([300, 210, 97], 300, seed=5)


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_lstm_audio_matches_jax(jax_side, case):
    """Loss, per-example ``log_prob``, the carried state ``s_n`` and the reconstruction
    (at the mode) against the JAX forward in f32: atol 1e-5 / rtol 1e-5 (the recurrence
    and the decoder sum in another order; ``log_prob`` sums ~1000 frames)."""
    lengths, initial = FORWARD_CASES[case]
    model, _ = _port_model()
    x, x_sl = _batch(lengths, T, seed=1)
    s_0 = tuple(map(torch.from_numpy, _state(2))) if initial else None
    _, patch_port = _at_the_mode()
    with patch_port, torch.no_grad():
        loss, mets, out = model(torch.from_numpy(x), torch.from_numpy(x_sl), s_0=s_0)
    jmets, js_n, jsample = jax_side[case]
    np.testing.assert_allclose(float(loss), float(jmets["loss"]), rtol=1e-5)
    np.testing.assert_allclose(mets["log_prob"].numpy(), jmets["log_prob"], rtol=1e-5, atol=1e-4)
    for got, ref in zip(out.s_n, js_n):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.reconstruction_sample.numpy(), jsample, atol=1e-5, rtol=1e-5)
    assert out.z.shape == (B, T // 8 - 1, 16) and out.reconstruction_mode.shape == (B, T - 8, 1)


def test_state_carry_test_pass_matches_jax(jax_side):
    """``--split_eval``: chunks of 16 stacks, no overlap, ``s_n`` carried
    (``experiment_lstm_audio.py:69-89``), against the same loop over the JAX forward:
    the tracker's loss, ll and bpd (rtol 1e-5) and the last chunk's state."""
    jvalues, js_n, n_chunks = jax_side["carry"]
    model, _ = _port_model()
    args = lstm_audio.build_args("--stack_size 8 --hidden_size 16 --num_layers 2 --split_eval true".split())
    carry = lstm_audio.make_state_carry_eval(model, args)
    tracker = Tracker()
    x, x_sl = _carry_batch()
    _, patch_port = _at_the_mode()
    with patch_port:
        out = carry(make_eval_step(common.loss_fn), model, None, x, x_sl, {}, tracker, "test")
    assert n_chunks == 3
    for key in ("loss", "ll", "bpd"):
        np.testing.assert_allclose(tracker.values["test"][key], jvalues[key], rtol=1e-5, err_msg=key)
    for got, ref in zip(out.s_n, js_n):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    with patch_port:  # the driver's evaluate takes the same path under --split_eval
        values = lstm_audio.evaluate(model, args, [(x, x_sl)], Tracker())
    assert values["bpd"] == tracker.values["test"]["bpd"]


def test_frozen_lstm_golden():
    """``tests/parity/goldens/lstm.npz``: the torch reference's loss and per-example
    log-probability, at ``tests/parity/test_goldens.py:66-71``'s tolerances."""
    data = np.load(GOLDENS / "lstm.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    model = LSTMAudio(**meta["kwargs"])
    weights.load_jax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p|")})
    with torch.no_grad():
        loss, mets, _ = model(torch.from_numpy(data["x"]), torch.from_numpy(data["x_sl"]))
    np.testing.assert_allclose(float(loss), float(data["g|loss"]), rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(mets["log_prob"].numpy(), data["g|log_prob"], rtol=2e-4, atol=2e-3)


@pytest.fixture(scope="module")
def golden_trajectory():
    """``train_step_lstm.npz`` replayed through the port's train step in float64."""
    data = np.load(GOLDENS / "train_step_lstm.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    params = {k[2:]: data[k] for k in data.files if k.startswith("p|")}
    model = LSTMAudio(**meta["model_kwargs"]).double()
    weights.load_jax_params(model, params)
    tx = get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator().manual_seed(0))
    step = make_train_step(common.loss_fn)
    losses = []
    for x in data["x"]:
        state, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(data["x_sl"])), {})
        losses.append(float(mets["loss"]))
    return data, meta, params, losses, weights.flatten(weights.export_jax_params(model))


def test_train_step_replays_the_lstm_golden_in_float64(golden_trajectory):
    """The torch reference's f64 trajectory of 4 Adam steps (lr 3e-4): losses at rtol 1e-6
    (``PARITY.md:147-159``)."""
    data, _, _, losses, _ = golden_trajectory
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-6, atol=1e-9)


def test_train_step_parameters_match_jax_in_float64(golden_trajectory):
    """The parameters after the golden's 4 steps against the JAX package's optax chain on the
    same batches, both in float64: rtol 1e-5 (``PARITY.md:147-159``)."""
    data, meta, params, _, final = golden_trajectory
    jmodel = JaxLSTMAudio(**meta["model_kwargs"])
    with jax.enable_x64(True):
        tx = jax_get_optimizer("Adam", 3e-4)
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(params))
        opt_state = tx.init(jparams)

        @jax.jit
        def step(p, opt, x, x_sl):
            loss_of = lambda p_: jmodel.apply({"params": p_}, x, x_sl, rngs={"sample": jax.random.PRNGKey(0)})[0]
            grads = jax.grad(loss_of)(p)
            updates, opt = tx.update(grads, opt, p)
            return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), opt

        for x in data["x"]:
            jparams, opt_state = step(jparams, opt_state, jnp.asarray(x), jnp.asarray(data["x_sl"].astype(np.int32)))
        jfinal = weights.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    for name, value in final.items():
        np.testing.assert_allclose(value, jfinal[name], rtol=1e-5, atol=1e-9, err_msg=name)


def test_generate_at_the_mode_matches_jax(jax_side):
    """``generate(use_mode=True)`` from the same prime stack, 5 stacks: the JAX rollout's
    frames at atol 1e-5."""
    prime, jgen = jax_side["generate"]
    model, _ = _port_model()
    (x, x_sl), _ = model.generate(n_samples=2, max_timesteps=5, use_mode=True, x=torch.from_numpy(prime))
    assert x.shape == (2, 40) and x_sl.tolist() == [40, 40]
    np.testing.assert_allclose(x.numpy(), jgen, atol=1e-5, rtol=1e-5)


def test_mode_rollout_matches_the_forwards_mode():
    """The oracle of ``tests/models/test_lstm_audio.py:179``: each generated stack (at the mode)
    is the forward's DMoL mode at the same position when the generated prefix is fed back."""
    S = SMALL["stack_size"]
    model, _ = _port_model()
    prime = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, S)).astype(np.float32))
    (gen, _), _ = model.generate(n_samples=1, max_timesteps=4, use_mode=True, x=prime)
    seq = torch.cat([prime, gen, torch.zeros(1, S)], dim=1)  # a dummy target stack after the last
    with torch.no_grad():
        _, _, out = model(seq, torch.tensor([seq.shape[1]]))
    np.testing.assert_allclose(gen.numpy(), out.reconstruction_mode[:, : 4 * S, 0].numpy(), atol=1e-5, rtol=1e-5)


def test_generated_samples_are_the_forwards_samples_from_the_same_uniforms():
    """A generation from supplied uniforms, fed back through the forward, is drawn again by
    the forward's sampler from the same uniforms: the rollout's state, decoder and sampler
    line up stack for stack."""
    S, M, steps = SMALL["stack_size"], SMALL["num_mix"], 4
    model, _ = _port_model()
    rng = np.random.default_rng(6)
    u_cat, u_log = (torch.from_numpy(rng.uniform(size=(steps * S, 2, n)).astype(np.float32)) for n in (M, 1))
    (gen, _), _ = model.generate(n_samples=2, max_timesteps=steps, uniforms=(u_cat, u_log))
    assert gen.abs().max() <= 1
    seq = torch.cat([torch.zeros(2, S), gen], dim=1)  # the zero prime the rollout started from
    with torch.no_grad():
        _, _, out = model(seq, torch.full((2,), seq.shape[1]))
        again = model.likelihood.rsample(None, model.likelihood(model.decoder(out.z).reshape(2, -1, 3 * M)),
                                         uniforms=(u_cat.transpose(0, 1), u_log.transpose(0, 1)))
    np.testing.assert_allclose(again[..., 0].numpy(), gen.numpy(), atol=1e-6)


def test_generation_hook_writes_two_wav_files(tmp_path):
    """Every ``--generate_every`` epochs: 2 sequences of ``--generate_frames // stack_size``
    stacks, mu-law decoded, as ``audio/epoch{epoch:04d}_generated_{i}.wav``."""
    args = lstm_audio.build_args(
        "--stack_size 8 --hidden_size 16 --num_mix 3 --num_bits 8 --generate_every 2 --generate_frames 40".split())
    model = lstm_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    hook = lstm_audio.make_generation_hook(model, args)
    assert hook(3, tmp_path) == []
    paths = hook(4, tmp_path, generator=torch.Generator().manual_seed(0))
    assert [p.relative_to(tmp_path).as_posix() for p in paths] == [
        "audio/epoch0004_generated_0.wav", "audio/epoch0004_generated_1.wav"]
    (expected, _), _ = model.generate(2, 5, generator=torch.Generator().manual_seed(0))
    for path, samples in zip(paths, MuLawDecode(bits=8)(expected.numpy())):
        with wave.open(str(path)) as f:
            assert (f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()) == (1, 2, 16000, 40)
            pcm = np.frombuffer(f.readframes(40), "<i2")
        np.testing.assert_array_equal(pcm, (np.clip(samples, -1, 1) * 32767.0).astype("<i2"))
    off = lstm_audio.build_args("--stack_size 8 --hidden_size 16 --generate_every 1 --generate_frames 0".split())
    assert lstm_audio.make_generation_hook(model, off)(4, tmp_path) == []


def test_benchmark_lstm_specs_parse_and_build():
    """Every LSTM run spec of ``experiments/benchmarks.txt`` parses (unused flags warn) and
    builds the JAX driver's model: H = 256, one layer, DMoL over 2^16 bins, f32."""
    lines = [line for line in (REPO / "experiments" / "benchmarks.txt").read_text().splitlines()
             if line.startswith("python experiments/experiment_lstm_audio.py")]
    assert len(lines) == 10
    for line in lines:
        with pytest.warns(UserWarning, match="--dataset"):
            args = lstm_audio.build_args(shlex.split(line)[2:])
        assert (args.hidden_size, args.num_layers, args.num_bits, args.num_mix, args.bf16) == (256, 1, 16, 10, False)
        assert args.stack_size in (1, 64, 256) and args.likelihood == "DMoL"
    model = lstm_audio.build_model(args, device="cpu")
    assert model.lstm.w_hh_0.shape == (256, 1024) and model.likelihood.num_bins == 2**16


def test_build_model_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = lstm_audio.build_args("--stack_size 8 --hidden_size 16".split())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lstm_audio.build_model(args)
    assert next(lstm_audio.build_model(args, device="cpu").parameters()).device.type == "cpu"


def test_driver_trains_on_the_cpu():
    """The shared ``train`` loop with the LSTM: 2 steps on 4 utterances, loss/ll/bpd
    under the ``train`` source, parameters moved."""
    args = lstm_audio.build_args("--stack_size 8 --hidden_size 16 --num_mix 3 --epochs 1 --seed 0".split())
    model = lstm_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    before = model.lstm.w_hh_0.detach().clone()
    rng = np.random.default_rng(0)
    utterances = [(i, rng.uniform(-0.5, 0.5, n).astype(np.float32)) for i, n in enumerate((90, 130, 64, 200))]
    tracker = Tracker()
    state = common.train(model, args, [utterances[:2], utterances[2:]], tracker, device="cpu")
    assert state.step == 2 and np.isfinite(tracker.values["train"]["bpd"])
    assert not torch.equal(model.lstm.w_hh_0.detach(), before)
