"""The CTC probe's train loop and the optimizer's non-finite skip on the CPU: three Adam steps through
``asr_ctc.train`` in f64 (the probe's clips, a binding norm clip, dropout 0, ``--accum_steps 2`` with a
padded row, so the microbatches are weighted by their label counts) against the JAX package's train
step and optax chain on the same batches (losses at rtol 1e-6, final parameters at 1e-5), the test pass
through ``asr_ctc.evaluate``, the driver's flags and refusals; and ``ClippedOptimizer``'s device-side
skip of non-finite updates against ``optax.apply_if_finite``, with the consecutive-error limit cut to 2 so
the forced update runs too. Inputs and weights come from numpy seeds; the JAX step compiles once, at
XLA's CPU optimization level 0."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blvm_tpu.models.lstm_asr import SimpleLSTMASR as JaxSimpleLSTMASR
from blvm_tpu.parallel.train_step import make_train_step as jax_make_train_step
from blvm_tpu.training.optim import get_optimizer as jax_get_optimizer
from blvm_tpu.training.train_state import TrainState as JaxTrainState
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import asr_ctc
from blvm_tpu_torch.training import optim
from blvm_tpu_torch.training.optim import get_optimizer

# experiments/phoneme.txt:8 cut to size: 2 layers of H = 16 over 8 representation features
FLAGS = ("--hidden_size 16 --num_layers 2 --bidirectional True --dropout_prob 0.00 --epochs 1 --data_type rep.npy "
         "--accum_steps 2 --max_grad_norm 0.5 --metric_fetch_lag 2 --seed 0")
D = 8
LENGTHS = ((24, 19, 13), (17, 22, 14), (24, 8, 19))  # three steps of three utterances; a padded fourth row


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the twins' per-step products are tiny, and torch's thread pool costs
    more than they do (several times the run on a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StepLog(Tracker):
    """A tracker that also keeps each update's values, in order."""

    def __init__(self):
        super().__init__()
        self.step_values = []

    def update(self, metrics, source):
        super().update(metrics, source)
        self.step_values.append({m.name: m.value for m in metrics})


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    args = asr_ctc.build_args(FLAGS.split())
    token_map = asr_ctc.build_token_map(args)
    phones = [p for p in token_map.tokens[1:]]
    batches = []
    for lengths in LENGTHS:
        batch = []
        for n in lengths:
            text = "".join(f"0 1 {p}\n" for p in rng.choice(phones, n // 4))
            batch.append(asr_ctc.encode_example(rng.standard_normal((n, D)), text, args, token_map))
        batches.append(batch)
    return args, token_map, batches


def _port_model(args, token_map):
    model = asr_ctc.build_model(args, input_size=D, token_map=token_map, device="cpu")
    params = weights.random_jax_params(model, seed=11)
    weights.load_jax_params(model, params)
    return model.double(), params


@pytest.fixture(scope="module")
def jax_trajectory():
    """The JAX package's train step (``accum=2``, label-weighted) and optax chain (Adam at the first epoch's
    learning rate, the value and norm clips) over the same three batches in f64: per-step losses and the
    final parameters."""
    args, token_map, batches = _batches()
    _, params = _port_model(args, token_map)
    jmodel = JaxSimpleLSTMASR(vocab=tuple(token_map.tokens), input_size=D, hidden_size=16, num_layers=2,
                              bidirectional=True, dropout_prob=0.0)

    def loss_fn(p, rng, batch, scalars):
        loss, mets, outputs = jmodel.apply({"params": p}, batch["x"], batch["x_sl"], batch["y"], batch["y_sl"],
                                           deterministic=False, rngs={"dropout": rng})
        return loss, (mets, outputs)

    one_device = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    raw_step = jax_make_train_step(loss_fn, mesh=one_device, jit=False, accum=2,
                                   loss_weight=lambda mb, mets: mb["y_sl"].sum())
    with jax.enable_x64(True):
        tx = jax_get_optimizer("Adam", args.lr, clip_grad_norm=args.max_grad_norm, clip_grad_value=args.max_grad_value)
        state = JaxTrainState.create(apply_fn=jmodel.apply, rng=jax.random.PRNGKey(0), tx=tx,
                                     params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                                   weights.unflatten(params)))
        jbatches = []
        for examples in batches:
            b = asr_ctc.make_batch(examples, args)
            jbatches.append(dict(x=jnp.asarray(b["x"], jnp.float64), x_sl=jnp.asarray(b["x_sl"]),
                                 y=jnp.asarray(b["y"]), y_sl=jnp.asarray(b["y_sl"])))
        step = jax.jit(raw_step).lower(state, jbatches[0], {}).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        losses = []
        for b in jbatches:
            state, mets = step(state, b, {})
            losses.append(float(mets["loss"]))
        final = weights.flatten(jax.tree_util.tree_map(np.asarray, state.params))
    return losses, final


def test_asr_train_matches_the_jax_train_step_in_float64(jax_trajectory):
    args, token_map, batches = _batches()
    assert all(asr_ctc.make_batch(b, args)["x"].shape[0] == 4 for b in batches)  # three rows and a padded one
    model, _ = _port_model(args, token_map)
    log = StepLog()
    state = asr_ctc.train(model, args, batches, log, device="cpu")
    losses, final = jax_trajectory
    assert state.step == 3 and len(log.step_values) == 3
    np.testing.assert_allclose([s["loss"] for s in log.step_values], losses, rtol=1e-6)
    assert all(0.0 <= s["cer"] and 0.0 <= s["wer"] for s in log.step_values)
    got = weights.flatten(weights.export_jax_params(model))
    assert set(got) == set(final)
    for name in got:
        np.testing.assert_allclose(got[name], final[name], rtol=1e-5, atol=1e-7, err_msg=name)

    result = asr_ctc.evaluate(model.float(), args, batches[:1], Tracker(), source="valid")
    assert {"loss", "wer", "cer"} <= set(result) and len(result["hyps"]) == len(result["refs"]) == 3
    assert result["refs"][0] == " ".join(token_map.decode(batches[0][0][1]))


def test_asr_driver_flags_and_refusals(monkeypatch):
    args = asr_ctc.build_args("--hidden_size 256 --num_layers 3 --bidirectional True --dropout_prob 0.30 --epochs 30 "
                              "--data_type spectrogram".split())
    assert (args.batch_len, args.lr, args.max_grad_norm, args.max_grad_value, args.n_mels, args.hop_length) == (
        120, 3e-4, 3000.0, 1000.0, 80, 64)
    assert args.lr_scheduler == "MultiStepLR" and args.lr_scheduler_kwargs["milestones"] == [100, 200, 300]
    model = asr_ctc.build_model(args, input_size=80, device="cpu")
    assert len(model.vocab) == 65 and model.lstm.output_size == 512 and model.lstm.fwd_1.w_ih_0.shape == (512, 1024)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        asr_ctc.build_args(["--num_seeds", "2"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        asr_ctc.build_args(["--save_checkpoints", "true"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asr_ctc.build_model(args, input_size=80)


def test_weights_round_trip_the_probe():
    args, token_map, _ = _batches()
    model, params = _port_model(args, token_map)
    bound = 1 / np.sqrt(16)
    assert all(np.abs(v).max() <= bound for k, v in params.items() if k.startswith("lstm/"))
    assert np.abs(params["output/kernel"]).max() <= 1 / np.sqrt(32)
    exported = weights.flatten(weights.export_jax_params(model))
    assert set(exported) == set(params) and all(np.array_equal(exported[k], params[k]) for k in params)


def test_nonfinite_skip_on_the_device_matches_optax_apply_if_finite(monkeypatch):
    """A NaN or an inf in a gradient leaves the parameters, Adam's moments and its step count as they were,
    decided on the device (the counters are tensors, nothing is read back inside ``step``); after more than
    the limit of consecutive non-finite steps the update is taken, as optax takes it. f64 on both sides."""
    monkeypatch.setattr(optim, "MAX_CONSECUTIVE_ERRORS", 2)
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s) for k, s in shapes.items()}
    pattern = ["ok", "nan", "ok", "inf", "nan", "nan", "ok"]
    grads = []
    for kind in pattern:
        g = {k: rng.normal(size=s) * 0.4 for k, s in shapes.items()}
        if kind != "ok":
            g["a"][1, 2] = np.nan if kind == "nan" else np.inf
        grads.append(g)
    with jax.enable_x64(True):
        tx = optax.apply_if_finite(jax_get_optimizer("Adam", 1e-2, clip_grad_norm=1.0), 2)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jopt, update = tx.init(jp), jax.jit(tx.update)
        ref = []
        for g in grads:
            updates, jopt = update(jax.tree_util.tree_map(jnp.asarray, g), jopt, jp)
            jp = optax.apply_updates(jp, updates)
            ref.append((jax.tree_util.tree_map(np.asarray, jp), int(jopt.notfinite_count), int(jopt.total_notfinite)))

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    chain = get_optimizer("Adam", 1e-2, clip_grad_norm=1.0, skip_nonfinite_updates=True)(tparams.values())
    applied = []
    for g, (jparams, count, total) in zip(grads, ref):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        applied.append(chain.step())
        assert isinstance(applied[-1], torch.Tensor) and applied[-1].dtype == torch.bool
        assert (int(chain.notfinite_count), int(chain.total_notfinite)) == (count, total)
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(), jparams[k], rtol=1e-9, atol=1e-12, err_msg=k)
    assert [bool(a) for a in applied] == [True, False, True, False, False, True, True]
    assert int(chain.optimizer.state[tparams["a"]]["step"]) == 4  # the forced update counts, the skipped do not
