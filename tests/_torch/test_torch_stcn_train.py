"""STCN's training half on the CPU: the frozen f64 trajectory ``train_step_stcn.npz`` replayed through the
port's train step and held to the JAX package's optax chain; the whole model's gradient against
``jax.grad`` of the JAX ``STCN`` (the golden's configuration, and four frames a stack); gradient
accumulation (equal lengths: the full-batch update exactly; unequal: the microbatches weighted by their
frames as JAX's ``make_train_step`` weights them); and the driver's ``train`` with its annealers. Both
packages' Gaussian latent samples are at their mean, as the golden's are
(``patch_modules: ["blvm_tpu.models.stcn.stcn"]``). On the CPU K1's wrapper is its plain twin, so these
gradients are the ones K1-bwd is held to on the card. Inputs come from numpy seeds; each JAX reference
compiles once, in a module-scoped fixture."""

import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.models.stcn.stcn as jax_stcn
from blvm_tpu.models import STCN as JaxSTCN
from blvm_tpu.training.annealers import CosineAnnealer as JaxCosineAnnealer
from blvm_tpu.training.optim import get_optimizer as jax_get_optimizer
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, stcn_audio
from blvm_tpu_torch.models import STCN
from blvm_tpu_torch.models import stcn as port_stcn
from blvm_tpu_torch.training.optim import get_optimizer
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step

GOLDEN = Path(__file__).resolve().parent.parent / "parity" / "goldens" / "train_step_stcn.npz"
# name: the model's keyword arguments beyond the golden's (2 layers a stack, latents (8, 4), 16 channels)
GRAD_CASES = {"golden": {}, "stacked_4": dict(n_stack_frames=4)}
ACCUM_LENGTHS = {"equal": (64, 64, 64, 64), "unequal": (64, 43, 64, 20)}


def _golden():
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    return data, meta, {k[2:]: data[k] for k in data.files if k.startswith("p|")}


def _zero_noise():
    """The port's latent noise at zero: z at the posterior mean, as the golden's JAX side."""
    return mock.patch.object(port_stcn, "gaussian_noise",
                             lambda g, shape, like: torch.zeros(shape, dtype=like.dtype, device=like.device))


def _jax_at_the_mean():
    return mock.patch.object(jax_stcn, "rsample_gaussian", lambda key, mu, sd: mu)


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's CPU backend optimization level 0: the same program,
    compiled several times faster; only the order of some sums may differ, well inside the tolerances."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def _model(meta, params=None, seed=2, **kwargs):
    """The port's model in float64 at the golden's configuration and the JAX tree it holds."""
    model = STCN(**meta["model_kwargs"], **kwargs, device="cpu")
    params = weights.random_jax_params(model, seed) if params is None else params
    model = model.double()
    weights.load_jax_params(model, params)
    return model, params


def _batch(lengths, T=64, seed=7):
    x = np.random.default_rng(seed).uniform(-1, 1, (len(lengths), T))
    x_sl = np.asarray(lengths, np.int32)
    for row, n in enumerate(x_sl):
        x[row, n:] = 0.0
    return x, x_sl


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(tree))


@pytest.fixture(scope="module")
def jax_side():
    """In float64, the JAX forward at the mean, value and gradient by every parameter, compiled once a
    configuration for a (2, 64) batch; and the JAX package's optax chain (its clips) stepped with the
    golden configuration's gradients over the golden's 4 batches. Returns ``{case: (params,
    value_and_grad(x, x_sl))}`` and the chain's final tree."""
    data, meta, golden_params = _golden()
    out = {}
    with jax.enable_x64(True), _jax_at_the_mean():
        for name, kwargs in GRAD_CASES.items():
            _, params = _model(meta, golden_params if name == "golden" else None, **kwargs)
            jmodel = JaxSTCN(**meta["model_kwargs"], **kwargs)

            def loss_of(p, x, x_sl, m=jmodel):
                return m.apply({"params": p}, x, x_sl, rngs={"sample": jax.random.PRNGKey(0)}, **meta["fwd_kwargs"])[0]

            x, x_sl = _batch((64, 43))
            vg = _compiled(jax.value_and_grad(loss_of), _f64(params), jnp.asarray(x), jnp.asarray(x_sl))

            def value_and_grad(x_, sl_, vg=vg, p=_f64(params)):
                with jax.enable_x64(True):
                    return jax.tree_util.tree_map(np.asarray, vg(p, jnp.asarray(x_), jnp.asarray(sl_)))

            out[name] = (params, value_and_grad, vg)

        tx = jax_get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
        jparams = _f64(golden_params)
        opt_state = tx.init(jparams)
        update = jax.jit(tx.update)
        vg = out["golden"][2]
        for x in data["x"]:
            _, grads = vg(jparams, jnp.asarray(x), jnp.asarray(data["x_sl"].astype(np.int32)))
            updates, opt_state = update(grads, opt_state, jparams)
            jparams = jax.tree_util.tree_map(lambda a, u: a + u, jparams, updates)
        final = weights.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    return {name: v[:2] for name, v in out.items()}, final


@pytest.fixture(scope="module")
def golden_trajectory():
    """``train_step_stcn.npz`` replayed through the port's train step in float64: the latent noise at zero,
    its beta 0.9 and free nats 0.5 handed over as the step's scalars, its clips."""
    data, meta, params = _golden()
    model, _ = _model(meta, params)
    tx = get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator().manual_seed(0))
    step = make_train_step(common.loss_fn)
    losses = []
    with _zero_noise():
        for x in data["x"]:
            state, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(data["x_sl"])),
                               meta["fwd_kwargs"])
            losses.append(float(mets["loss"]))
    return data, meta, losses, weights.flatten(weights.export_jax_params(model))


def test_train_step_replays_the_stcn_golden_in_float64(golden_trajectory):
    """The torch reference's f64 trajectory of 4 clipped Adam steps (lr 3e-4, beta 0.9, free nats 0.5):
    losses at rtol 1e-6 (``PARITY.md:147-159``)."""
    data, meta, losses, _ = golden_trajectory
    assert meta["fwd_kwargs"] == dict(beta=0.9, free_nats=0.5)
    assert meta["patch_modules"] == ["blvm_tpu.models.stcn.stcn"]
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-6, atol=1e-9)


def test_stcn_train_step_parameters_match_jax_in_float64(golden_trajectory, jax_side):
    """The parameters after the golden's 4 steps against the JAX package's optax chain (the same clips)
    on the same batches, the JAX latent sample at its mean, both in float64: rtol 1e-5
    (``PARITY.md:147-159``)."""
    _, _, _, final = golden_trajectory
    jfinal = jax_side[1]
    assert final.keys() == jfinal.keys()
    for name, value in final.items():
        np.testing.assert_allclose(value, jfinal[name], rtol=1e-5, atol=1e-9, err_msg=name)


def _port_grads(model, x, x_sl, scalars):
    model.zero_grad(set_to_none=True)
    with _zero_noise():
        loss, _, _ = model(torch.from_numpy(x), torch.from_numpy(x_sl), **scalars)
    loss.backward()
    return loss.item(), {name.replace(".", "/"): p.grad.numpy().copy() for name, p in model.named_parameters()}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_stcn_gradients_match_jax_in_float64(case, jax_side):
    """The whole STCN's loss and the gradient of every parameter (through the skip-free and skip blocks
    of both stacks, the heads, the precision-weighted posterior, the KL with free nats and the DMoL
    loss) against ``jax.grad`` of the JAX model, float64, z at the mean alike: loss at rtol 1e-9,
    gradients at rtol 1e-7 (with as much of each tensor's largest value as absolute slack: the DMoL
    ladder's sums in another order). ``stacked_4`` runs the stacked input (the ``:27``-style path)."""
    _, meta, _ = _golden()
    params, vg = jax_side[0][case]
    model, _ = _model(meta, params, **GRAD_CASES[case])
    x, x_sl = _batch((64, 43))
    value, grads = _port_grads(model, x, x_sl, meta["fwd_kwargs"])
    jvalue, jgrads = vg(x, x_sl)
    jgrads = weights.flatten(jgrads)
    np.testing.assert_allclose(value, float(jvalue), rtol=1e-9)
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-7, atol=1e-7 * np.abs(jgrads[name]).max(), err_msg=name)
    # the dead encoder blocks' skip columns: no gradient, as JAX's column slice gives them none
    assert not np.any(grads["res_stack/Conv1dResidualGLU_0/rs_kernel"][..., 16:])


def _accumulated_step(lengths, accum):
    """One step of the port's train step (Adam, no clips) over 4 rows at ``lengths``, ``accum``
    microbatches weighted by their frames. Returns the loss, the gradient it applied and the
    parameters after it."""
    _, meta, params = _golden()
    model, _ = _model(meta, params)
    state = TrainState.create(model=model, tx=get_optimizer("Adam", 3e-4), generator=torch.Generator().manual_seed(0))
    step = make_train_step(common.loss_fn, accum=accum, loss_weight=lambda mb, mets: mb["x_sl"].sum())
    x, x_sl = _batch(lengths)
    with _zero_noise():
        _, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(x_sl)), meta["fwd_kwargs"])
    named = dict(model.named_parameters())
    return (float(mets["loss"]), {n.replace(".", "/"): p.grad.numpy().copy() for n, p in named.items()},
            {n.replace(".", "/"): p.detach().numpy().copy() for n, p in named.items()})


def test_accumulated_stcn_step_equals_the_full_batch_step():
    """``accum=2`` on 4 rows of equal length gives the update of one full-batch step: the loss is
    total nats over total frames, so the frames-weighted mean of the two microbatches' gradients is the
    full batch's (``blvm_tpu/parallel/train_step.py:95-104``). float64: rtol 1e-9."""
    whole = _accumulated_step(ACCUM_LENGTHS["equal"], 1)
    accumulated = _accumulated_step(ACCUM_LENGTHS["equal"], 2)
    np.testing.assert_allclose(accumulated[0], whole[0], rtol=1e-9)
    for part_a, part_w in zip(accumulated[1:], whole[1:]):
        for name, value in part_w.items():
            np.testing.assert_allclose(part_a[name], value, rtol=1e-9, atol=1e-12 * np.abs(value).max(), err_msg=name)


def test_accumulated_stcn_step_weights_microbatches_by_frames(jax_side):
    """``accum=2`` on rows of unequal length: the gradient applied is JAX's weighting,
    ``sum_i w_i g_i / sum_i w_i`` with ``w_i`` each microbatch's frames (107 and 84), of ``jax.grad`` on
    each microbatch; the loss the same weighting of the microbatches' losses. float64: rtol 1e-7."""
    loss, grads, _ = _accumulated_step(ACCUM_LENGTHS["unequal"], 2)
    x, x_sl = _batch(ACCUM_LENGTHS["unequal"])
    _, vg = jax_side[0]["golden"]
    parts = [vg(x[i : i + 2], x_sl[i : i + 2]) for i in (0, 2)]
    w = [float(x_sl[i : i + 2].sum()) for i in (0, 2)]
    assert w == [107.0, 84.0]
    np.testing.assert_allclose(loss, sum(wi * float(v) for wi, (v, _) in zip(w, parts)) / sum(w), rtol=1e-7)
    jgrads = [weights.flatten(g) for _, g in parts]
    for name, g in grads.items():
        ref = sum(wi * jg[name] for wi, jg in zip(w, jgrads)) / sum(w)
        np.testing.assert_allclose(g, ref, rtol=1e-7, atol=1e-7 * np.abs(ref).max(), err_msg=name)


class _StepLog(Tracker):
    """A tracker that also keeps each update's metric values."""

    def __init__(self):
        super().__init__()
        self.per_step = []

    def update(self, metrics, source):
        super().update(metrics, source)
        self.per_step.append((source, {m.name: m.value for m in metrics}))


def _train_args(*extra):
    return stcn_audio.build_args(("--num_layers 2 --latent_size 8 4 --hidden_size 16 --epochs 1 --batch_size 4 "
                                  "--beta_anneal_steps 0 --free_nats_steps 4 --free_nats_start_value 2 --accum_steps 2 "
                                  "--random_segment_size 64 --max_grad_norm 1.0 --max_grad_value 0.1 --seed 0").split()
                                 + list(extra))


def test_driver_train_steps_the_annealers():
    """``stcn_audio.train`` with the flags of ``benchmarks.txt:26`` at a small width: beta and free nats
    stepped once a train step (not once a microbatch), handed to both microbatches' forwards as float32
    scalars and logged under ``train`` as JAX's ``CosineAnnealer`` gives them; at
    ``--beta_anneal_steps 0`` beta is 1 from the first step (``experiments/experiment_stcn_audio.py:69-77``)."""
    args = _train_args()
    model = stcn_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    calls, forward = [], model.forward

    def recorded(*a, **kwargs):
        calls.append(kwargs)
        return forward(*a, **kwargs)

    model.forward = recorded
    rng = np.random.default_rng(1)
    utterances = [(i, rng.uniform(-0.5, 0.5, n).astype(np.float32)) for i, n in enumerate((90, 64, 120, 75) * 3)]
    log = _StepLog()
    state = stcn_audio.train(model, args, [utterances[i : i + 4] for i in (0, 4, 8)], log, device="cpu")
    beta = JaxCosineAnnealer(anneal_steps=0, start_value=0.0, end_value=1.0)
    free_nats = JaxCosineAnnealer(anneal_steps=2, constant_steps=2, start_value=2.0, end_value=0.0)
    expected = [(np.float32(beta.step()), np.float32(free_nats.step())) for _ in range(3)]
    assert state.step == 3 and len(calls) == 6 and [s for s, _ in log.per_step] == ["train"] * 3
    assert [b for b, _ in expected] == [1.0, 1.0, 1.0] and expected[0][1] == 2.0
    for i, (_, values) in enumerate(log.per_step):
        b, f = expected[i]
        for call in calls[2 * i : 2 * i + 2]:
            assert call["beta"].dtype == torch.float32 and float(call["beta"]) == b and float(call["free_nats"]) == f
        assert values["beta"] == b and values["free_nats"] == f and np.isfinite(values["loss"])
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_driver_train_runs_on_the_card_unless_asked(monkeypatch):
    """``stcn_audio.train`` without a device means the card: where there is none it raises, never
    training on the CPU silently."""
    args = _train_args()
    model = stcn_audio.build_model(args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stcn_audio.train(model, args, [[(0, np.zeros(80, np.float32))] * 4], Tracker())
