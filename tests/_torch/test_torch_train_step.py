"""The port's training step, optimizer chain, schedules and training loop against
the JAX package and the frozen train-step golden, on the CPU."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blvm_tpu.data.transforms import RandomSegment as JaxRandomSegment
from blvm_tpu.models import WaveNet as JaxWaveNet
from blvm_tpu.parallel.train_step import make_train_step as jax_make_train_step
from blvm_tpu.training.optim import get_lr_schedule as jax_get_lr_schedule
from blvm_tpu.training.optim import get_optimizer as jax_get_optimizer
from blvm_tpu.training.train_state import TrainState as JaxTrainState
from blvm_tpu_torch import weights
from blvm_tpu_torch.data.transforms import RandomSegment
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, wavenet_audio
from blvm_tpu_torch.models import WaveNet
from blvm_tpu_torch.training.optim import get_lr_schedule, get_optimizer
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step

GOLDEN = Path(__file__).resolve().parent.parent / "parity" / "goldens" / "train_step_wavenet.npz"
SMALL = dict(n_layers=3, n_stacks=2, res_channels=8, num_mix=3, num_bins=256)


def _port_state(model, tx):
    return TrainState.create(model=model, tx=tx, generator=torch.Generator().manual_seed(0))


def test_train_step_replays_the_wavenet_golden_in_float64():
    """``tests/parity/goldens/train_step_wavenet.npz``: the torch reference's f64
    trajectory of 4 Adam steps (lr 3e-4, no clipping), replayed through the port's
    train step at the golden's own tolerance (tests/parity/test_parity_train_step.py:334)."""
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    model = WaveNet(**meta["model_kwargs"]).double()
    weights.load_jax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p|")})
    tx = get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
    state, step = _port_state(model, tx), make_train_step(wavenet_audio.loss_fn)
    losses = []
    for x in data["x"]:
        state, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(data["x_sl"])), {})
        losses.append(float(mets["loss"]))
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-6, atol=1e-9)
    assert state.step == len(data["x"])


CASES = {
    "clip": dict(opt=dict(clip_grad_value=0.5, clip_grad_norm=1.0), step=dict(log_norms=True)),
    "clip_binding": dict(opt=dict(clip_grad_value=0.02, clip_grad_norm=0.3), step=dict(log_norms=True)),
    "accum2": dict(opt={}, step=dict(accum=2, loss_weight=lambda mb, mets: mb["x_sl"].sum())),
    "log_norms": dict(opt={}, step=dict(log_norms=True)),
    "nonfinite": dict(opt=dict(skip_nonfinite_updates=True), step={}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax_make_train_step(case):
    """Three steps of the port's train step against the JAX package's
    ``make_train_step`` from the same weights (drawn in f32 by numpy) on the same
    ragged batches. Both run in float64, so only summation order differs: the
    losses, norms and parameters agree to rtol 1e-9 / atol 1e-12 (parameters: a
    3e-10 atol floor, ~1e-6 of one Adam step of lr 3e-4). "nonfinite" puts a NaN
    in the second batch: both skip that update, parameters and Adam state alike."""
    cfg = CASES[case]
    rng = np.random.default_rng(11)
    model = WaveNet(**SMALL)
    params = weights.random_jax_params(model, 2)
    model = model.double()
    weights.load_jax_params(model, params)
    lengths = [70, 52, 61, 40]
    batches = []
    for i in range(3):
        x = rng.uniform(-1, 1, (4, 70))
        for row, n in enumerate(lengths):
            x[row, n:] = 0.0
        if case == "nonfinite" and i == 1:
            x[2, 10] = np.nan
        batches.append((x, np.asarray(lengths, np.int32)))

    jmodel = JaxWaveNet(**SMALL)

    def jax_loss(p, rng_, batch, scalars):
        loss, mets, outputs = jmodel.apply({"params": p}, batch["x"], batch["x_sl"], rngs={"sample": rng_})
        return loss, (mets, outputs)

    with jax.enable_x64(True):
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(params))
        jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=jparams, rng=jax.random.PRNGKey(0),
                                      tx=jax_get_optimizer("Adam", 3e-4, **cfg["opt"]))
        one_device = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
        # placed as the step returns it, so that the step compiles once, not again at step 2
        jstate = jax.device_put(jstate, jax.sharding.NamedSharding(one_device, jax.sharding.PartitionSpec()))
        jstep = jax_make_train_step(jax_loss, mesh=one_device, donate=False, **cfg["step"])
        jmets = []
        for x, x_sl in batches:
            jstate, mets = jstep(jstate, dict(x=jnp.asarray(x), x_sl=jnp.asarray(x_sl)), {})
            jmets.append(jax.tree_util.tree_map(np.asarray, mets))
        jfinal = weights.flatten(jax.tree_util.tree_map(np.asarray, jstate.params))

    state = _port_state(model, get_optimizer("Adam", 3e-4, **cfg["opt"]))
    step = make_train_step(wavenet_audio.loss_fn, **cfg["step"])
    for (x, x_sl), jm in zip(batches, jmets):
        state, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(x_sl)), {})
        assert mets.keys() == jm.keys()
        for name in mets:
            np.testing.assert_allclose(mets[name].numpy(), jm[name], rtol=1e-9, atol=1e-12, err_msg=name)
    if case == "clip_binding":  # both clips bind on the first step
        assert jmets[0]["grad_norm"] > 0.3
        assert max(np.abs(p.grad.numpy()).max() for p in model.parameters()) <= 0.02
    if case == "nonfinite":
        assert np.isnan(jmets[1]["loss"]) and state.optimizer.total_notfinite == 1
    final = {name.replace(".", "/"): p.detach().numpy() for name, p in model.named_parameters()}
    for name in final:
        np.testing.assert_allclose(final[name], jfinal[name], rtol=1e-9, atol=3e-10, err_msg=name)


@pytest.mark.parametrize(
    "opt",
    [
        dict(),
        dict(clip_grad_value=0.05),
        dict(clip_grad_norm=100.0),  # below the threshold: untouched
        dict(clip_grad_norm=0.5),  # above: scaled to the threshold
        dict(clip_grad_value=0.3, clip_grad_norm=0.5),
        dict(skip_nonfinite_updates=True),
    ],
    ids=["adam", "clip_value", "norm_below", "norm_above", "value_then_norm", "if_finite"],
)
def test_optimizer_chain_matches_optax(opt):
    """Four steps of the chain on random gradients (a NaN in step 3's under
    ``if_finite``) against optax, in float64 on both sides (rtol 1e-9). In f32
    the two differ by design: optax rounds Adam's bias corrections 1 - b^t in
    f32, where 1 - 0.999 cancels to ~6e-5 relative; torch takes them in double."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s) * 0.4 for k, s in shapes.items()} for _ in range(4)]
    if opt.get("skip_nonfinite_updates"):
        grads[2]["b"][3] = np.nan

    with jax.enable_x64(True):
        tx = jax_get_optimizer("Adam", 1e-2, **opt)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jopt, update = tx.init(jp), jax.jit(tx.update)
        for g in grads:
            updates, jopt = update(jax.tree_util.tree_map(jnp.asarray, g), jopt, jp)
            jp = optax.apply_updates(jp, updates)
        jp = jax.tree_util.tree_map(np.asarray, jp)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    chain = get_optimizer("Adam", 1e-2, **opt)(tparams.values())
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        chain.step()
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(), jp[k], rtol=1e-9, atol=1e-12, err_msg=k)


def test_non_finite_step_leaves_adam_state_untouched():
    p = torch.nn.Parameter(torch.ones(3))
    chain = get_optimizer("Adam", 0.1, skip_nonfinite_updates=True)([p])
    p.grad = torch.tensor([1.0, float("inf"), 0.5])
    assert not bool(chain.step())  # the decision is a device tensor: read here, never inside the step
    state = chain.optimizer.state[p]
    assert torch.equal(p.detach(), torch.ones(3)) and int(state["step"]) == 0
    assert not state["exp_avg"].any() and not state["exp_avg_sq"].any()
    assert (int(chain.notfinite_count), int(chain.total_notfinite)) == (1, 1)
    p.grad = torch.tensor([1.0, 1.0, 0.5])
    assert bool(chain.step()) and int(chain.optimizer.state[p]["step"]) == 1
    assert (int(chain.notfinite_count), int(chain.total_notfinite)) == (0, 1)


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("ExponentialLR", dict(gamma=0.9)),
        ("MultiStepLR", dict(milestones=[2, 5], gamma=0.5)),
        ("StepLR", dict(step_size=3, gamma=0.7)),
        ("CosineAnnealingLR", dict(T_max=8, eta_min=1e-5)),
        ("MultiplicativeLR", dict(lr_lambda=0.95)),
    ],
)
def test_epoch_schedules_match_jax(name, kwargs):
    ours, theirs = get_lr_schedule(name, 3e-4, **kwargs), jax_get_lr_schedule(name, 3e-4, **kwargs)
    for epoch in range(1, 13):
        assert ours.lr_at_epoch(epoch) == pytest.approx(theirs.lr_at_epoch(epoch), rel=1e-12)


def test_per_step_optax_schedules_are_refused_by_name():
    with pytest.raises(NotImplementedError, match="cosine_decay_schedule"):
        get_lr_schedule("cosine_decay_schedule", 3e-4, decay_steps=10)
    assert get_lr_schedule(None, 3e-4) == 3e-4


def test_random_segment_crops_like_jax():
    """The ctx-hashed crop is a pure function of (seed, epoch, example id), the same in both packages."""
    x = np.arange(1000)
    ours, theirs = RandomSegment(100, seed=7), JaxRandomSegment(100, seed=7)
    for epoch in (0, 1, 2):
        for example_id in (0, 1, 17):
            ctx = dict(example_id=example_id, epoch=epoch)
            np.testing.assert_array_equal(ours(x, ctx=ctx), theirs(x, ctx=ctx))
    assert len(ours(x[:50])) == 50  # shorter than the segment: the whole example


def _train_args(*extra):
    argv = ("--likelihood DMoL --n_stacks 2 --n_layers 3 --res_channels 8 --num_bits 8 --num_mix 3 "
            "--random_segment_size 60 --seed 3 --epochs 2 --max_grad_norm 5.0").split()
    return wavenet_audio.build_args([*argv, *extra])


def test_driver_trains_on_the_cpu_when_asked():
    """``train``: crops, mu-law, the train step and the tracker's ``train`` source;
    the parameters move and the values are finite. Its flags parse with the JAX
    driver's names and defaults."""
    args = _train_args("--lr_scheduler", "StepLR", "--lr_scheduler_kwargs", '{"step_size": 1, "gamma": 0.5}')
    assert (args.lr, args.optimizer, args.accum_steps, args.max_grad_value) == (3e-4, "Adam", 1, float("inf"))
    model = wavenet_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, args.seed))
    before = [p.detach().clone() for p in model.parameters()]
    rng = np.random.default_rng(0)
    examples = [(i, rng.uniform(-0.5, 0.5, n)) for i, n in enumerate((150, 97, 121, 80))]
    tracker = Tracker()
    state = wavenet_audio.train(model, args, [examples[:2], examples[2:]], tracker, device="cpu")
    assert state.step == 4 and tracker.steps["train"] == 4
    assert state.optimizer.learning_rate == pytest.approx(3e-4 * 0.5)  # epoch 2 of StepLR(1, 0.5)
    for name in ("loss", "ll", "bpd"):
        assert np.isfinite(tracker.values["train"][name])
    assert any(not torch.equal(a, b.detach()) for a, b in zip(before, model.parameters()))


def test_accumulated_step_equals_the_full_batch_step():
    """``accum=2`` with frames weights gives the update of one full-batch step,
    also with a microbatch of padding rows only (weight 0: masked, no NaN).
    float64: rtol 1e-9."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (4, 60))
    x_sl = np.asarray([60, 45, 0, 0], np.int32)
    x[1, 45:] = x[2:] = 0.0
    results = []
    for accum in (1, 2):
        model = WaveNet(**SMALL).double()
        weights.load_jax_params(model, weights.random_jax_params(model, 5))
        state = _port_state(model, get_optimizer("Adam", 3e-4))
        step = make_train_step(wavenet_audio.loss_fn, accum=accum, loss_weight=lambda mb, mets: mb["x_sl"].sum())
        _, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(x_sl)), {})
        assert np.isfinite(float(mets["loss"])) and mets["log_prob"].shape == (4,)
        results.append([p.detach().numpy().copy() for p in model.parameters()] + [float(mets["loss"])])
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_train_step_refuses_a_bad_accumulation():
    """As the JAX step (tests/parallel/test_accum.py): accum < 1, or rows that do not divide by it."""
    with pytest.raises(ValueError, match="accum must be >= 1"):
        make_train_step(wavenet_audio.loss_fn, accum=0)
    model = WaveNet(**SMALL)
    step = make_train_step(wavenet_audio.loss_fn, accum=2)
    batch = dict(x=torch.zeros(3, 40), x_sl=torch.full((3,), 40))
    with pytest.raises(ValueError, match="not divisible by accum=2"):
        step(_port_state(model, get_optimizer("Adam", 3e-4)), batch, {})


def test_a_skipped_update_still_counts_the_step():
    """The step counter counts calls, as the JAX state's does under ``apply_if_finite``."""
    p = torch.nn.Parameter(torch.ones(2))
    state = TrainState(model=torch.nn.Module(), optimizer=get_optimizer("Adam", 0.1, skip_nonfinite_updates=True)([p]),
                       generator=torch.Generator())
    p.grad = torch.tensor([float("nan"), 1.0])
    assert state.apply_gradients().step == 1 and torch.equal(p.detach(), torch.ones(2))


def test_driver_flags_build_the_chain():
    """``build_tx_and_lr`` as ``experiments/common.py:build_tx_and_lr``: an infinite
    clip flag means no clip; the default scheduler is the constant ExponentialLR(1)."""
    params = [torch.nn.Parameter(torch.zeros(2))]
    tx, epoch_lr = wavenet_audio.build_tx_and_lr(_train_args("--max_grad_norm", "inf"))
    chain = tx(params)
    assert (chain.clip_grad_norm, chain.clip_grad_value, chain.learning_rate) == (None, None, 3e-4)
    assert [epoch_lr.lr_at_epoch(e) for e in (1, 5)] == [3e-4, 3e-4]
    args = _train_args("--max_grad_value", "0.5", "--lr", "1e-3", "--optimizer_kwargs", '{"betas": [0.8, 0.9]}')
    chain = wavenet_audio.build_tx_and_lr(args)[0](params)
    assert (chain.clip_grad_norm, chain.clip_grad_value, chain.learning_rate) == (5.0, 0.5, 1e-3)
    assert tuple(chain.optimizer.param_groups[0]["betas"]) == (0.8, 0.9)
    with pytest.raises(NotImplementedError, match="'SGD'"):
        wavenet_audio.build_tx_and_lr(_train_args("--optimizer", "SGD"))


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """``build_model`` and ``train`` without a device mean the card: where there
    is none they raise, never building or training on the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _train_args()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wavenet_audio.build_model(args)
    model = wavenet_audio.build_model(args, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wavenet_audio.train(model, args, [], Tracker())


def test_train_refuses_a_model_on_another_device():
    args = _train_args()
    model = wavenet_audio.build_model(args, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        wavenet_audio.train(model, args, [], Tracker(), device="meta")


def test_metrics_read_late_give_the_values_of_lag_zero():
    """``--metric_fetch_lag`` (default 8, as JAX's): ``train`` and the whole-batch ``evaluate`` queue each step's
    metrics and read them that many steps late, flushing at the end of every epoch and of the pass, so the tracker
    holds the values of lag 0 exactly, with every step counted; ``DeferredMetrics`` hands them over in order."""
    assert wavenet_audio.build_args([]).metric_fetch_lag == 8
    rng = np.random.default_rng(1)
    examples = [(i, rng.uniform(-0.5, 0.5, n)) for i, n in enumerate(rng.integers(70, 160, 10))]
    batches = [examples[i:i + 2] for i in range(0, 10, 2)]
    eval_batches = [wavenet_audio.make_batch([w for _, w in examples[i:i + 3]], _train_args()) for i in range(0, 9, 3)]
    results = []
    for lag in (0, 3, 8):
        args = _train_args("--metric_fetch_lag", str(lag))
        model = wavenet_audio.build_model(args, device="cpu")
        weights.load_jax_params(model, weights.random_jax_params(model, args.seed))
        tracker, eval_tracker = Tracker(), Tracker()
        wavenet_audio.train(model, args, batches, tracker, device="cpu")
        args.split_eval = False  # the whole-batch pass
        values = wavenet_audio.evaluate(model, args, eval_batches, eval_tracker)
        results.append((tracker.values, tracker.steps["train"], values, eval_tracker.steps["test"]))
    assert results[0][1] == 10 and results[0][3] == 3
    assert results[0] == results[1] == results[2]

    consumed = []
    deferred = common.DeferredMetrics(consumed.append, lag=3)
    for step in range(5):
        deferred.push({"step": torch.tensor(step)})
        assert len(consumed) == max(0, step + 1 - 3)
    deferred.flush()
    assert [int(m["step"]) for m in consumed] == list(range(5))
