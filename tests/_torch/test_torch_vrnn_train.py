"""The VRNN's training half on the CPU: the orthogonal ``w_hh`` of ``random_jax_params``,
``VRNNCellFunction`` (the plain save-forward and K8-bwd's twin, ``vrnn_cell_backward_plain``)
against autograd of K8's twin and against ``jax.grad`` of the JAX cell's scan, the frozen
f64 trajectory ``train_step_vrnn.npz`` replayed through the port's train step and held to
the JAX package's optax chain, and the driver's ``train`` with its annealers. Inputs and
weights come from numpy seeds; each JAX reference compiles once, in a module-scoped fixture."""

import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.models.vrnn as jax_vrnn
from blvm_tpu.models import VRNNAudio as JaxVRNNAudio
from blvm_tpu.models.vrnn import VRNNCell as JaxVRNNCell
from blvm_tpu.training.annealers import CosineAnnealer as JaxCosineAnnealer
from blvm_tpu.training.optim import get_optimizer as jax_get_optimizer
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, lstm_audio, vrnn_audio, wavenet_audio
from blvm_tpu_torch.models import VRNNAudio
from blvm_tpu_torch.models import vrnn as port_vrnn
from blvm_tpu_torch.models.vrnn import VRNNCell
from blvm_tpu_torch.modules.recurrent import GRUCell
from blvm_tpu_torch.ops import vrnn as vrnn_ops
from blvm_tpu_torch.training.optim import get_optimizer
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step

GOLDENS = Path(__file__).resolve().parent.parent / "parity" / "goldens"
B, T, X, H, Z, R = 3, 8, 16, 16, 4, 32
# name: (residual_posterior, condition_h_on_x); every case starts from a given h0
GRAD_CASES = {
    "residual": (True, True),
    "plain_posterior": (False, True),
    "h_not_on_x": (True, False),
    "h_not_on_x_plain_posterior": (False, False),
}
# f64: the same math in another order (the Function's hand-written backward against autograd, the
# port against XLA); f32: the products' summation order over 8 steps of a chain that does not amplify it
TOLERANCES = {torch.float64: 1e-9, torch.float32: 1e-5}


def test_random_params_draw_the_vrnn_gru_w_hh_orthogonal():
    """The VRNN's ``GRUCell(orthogonal_hh=True)``: ``W W^T = I`` as flax's ``orthogonal()``
    draws it (``blvm_tpu/models/vrnn.py:63``); a ``GRUCell`` without the flag (SRNN's,
    ``blvm_tpu/models/srnn.py:66``) keeps the recurrent rule U(-1/sqrt(H), 1/sqrt(H))."""
    cell = VRNNCell(X, H, Z, R)
    w_hh = weights.random_jax_params(cell, seed=0)["gru/w_hh"].astype(np.float64)
    assert w_hh.shape == (R, 3 * R)
    np.testing.assert_allclose(w_hh @ w_hh.T, np.eye(R), atol=1e-5)
    plain = weights.random_jax_params(GRUCell(X, R, orthogonal_hh=False), seed=0)["w_hh"]
    assert 0.8 / np.sqrt(R) < np.abs(plain).max() <= 1 / np.sqrt(R)
    assert np.abs(plain @ plain.T - np.eye(R)).max() > 0.1


def _cell(residual, cond):
    cell = VRNNCell(X, H, Z, R, condition_h_on_x=cond, residual_posterior=residual)
    params = weights.random_jax_params(cell, seed=11 + cond)
    weights.load_jax_params(cell, params)
    return cell, params


def _grad_inputs(seed=12):
    """``x``, ``h0``, ``eps`` and the gradients of the seven outputs, numpy float64."""
    rng = np.random.default_rng(seed)
    x, h0, eps = rng.normal(size=(B, T, X)), rng.normal(scale=0.5, size=(B, R)), rng.normal(size=(B, T, Z))
    g_out = [rng.normal(size=(B, T, n)) for n in (R, Z, H, Z, Z, Z, Z)]
    return x, h0, eps, g_out


def _names(cell):
    """The flax names of ``cell.cell_weights()``, in their order."""
    by_id = {id(p): name.replace(".", "/") for name, p in cell.named_parameters()}
    return [by_id[id(w)] for w in cell.cell_weights()]


@pytest.fixture(scope="module")
def jax_cell_grads():
    """``jax.grad`` of ``sum(outputs * g_out)`` over the JAX cell's pieces scanned over T' (as
    ``__call__`` chains them, the noise given) by the parameters, ``x`` and ``h0``, float64 and
    float32: one compile per ``condition_h_on_x`` and dtype, the residual flag passed as data."""
    x, h0, eps, g_out = _grad_inputs()
    out = {}
    with jax.enable_x64(True):
        for dtype in (jnp.float64, jnp.float32):
            for cond in (True, False):
                _, params = _cell(True, cond)
                jcell = JaxVRNNCell(x_dim=X, h_dim=H, z_dim=Z, r_dim=R, condition_h_on_x=cond)

                def loss(p, x_, h_, residual, e_, gs):
                    def piece(method, *a):
                        return jcell.apply({"params": p}, *a, method=method)

                    def step(h, inputs):
                        x_t, e_t = inputs
                        p_mu, p_sd = piece(JaxVRNNCell.prior_params, h)
                        q_mu, q_sd = piece(JaxVRNNCell.posterior_params, h, x_t)
                        q_mu = jnp.where(residual, q_mu + p_mu, q_mu)
                        z = q_mu + q_sd * e_t
                        phi = piece(JaxVRNNCell.phi_z_features, z)
                        h = piece(JaxVRNNCell.gru_step, jnp.concatenate([x_t, phi], -1) if cond else phi, h)
                        return h, (h, z, phi, q_mu, q_sd, p_mu, p_sd)

                    _, outs = jax.lax.scan(step, h_, (jnp.swapaxes(x_, 0, 1), jnp.swapaxes(e_, 0, 1)))
                    return sum((jnp.swapaxes(o, 0, 1) * g).sum() for o, g in zip(outs, gs))

                grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
                tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), weights.unflatten(params))
                cast = [jnp.asarray(a, dtype) for a in (x, h0, eps)]
                gs = [jnp.asarray(g, dtype) for g in g_out]
                for name, (residual, c) in GRAD_CASES.items():
                    if c == cond:
                        gp, gx, gh0 = grad(tree, cast[0], cast[1], residual, cast[2], gs)
                        out[name, np.dtype(dtype).name] = (weights.flatten(jax.tree_util.tree_map(np.asarray, gp)),
                                                           np.asarray(gx), np.asarray(gh0))
    return out


def _port_grads(fn, cell, dtype, residual, cond):
    x, h0, eps, g_out = _grad_inputs()
    w = [p.detach().to(dtype).requires_grad_(True) for p in cell.cell_weights()]
    xt, h0t = (torch.tensor(a, dtype=dtype, requires_grad=True) for a in (x, h0))
    outs = fn(w, xt, h0t, torch.tensor(eps, dtype=dtype), inference=True, residual_posterior=residual,
              condition_h_on_x=cond, sd_beta=cell.prior_head.beta, sd_epsilon=cell.prior_head.epsilon)
    loss = sum((o * torch.tensor(g, dtype=dtype)).sum() for o, g in zip(outs, g_out))
    return torch.autograd.grad(loss, [*w, xt, h0t])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_cell_function_gradients_match_autograd_and_jax(jax_cell_grads, case, dtype):
    """``vrnn_cell`` with gradients runs ``VRNNCellFunction`` (on CPU tensors the plain
    save-forward and ``vrnn_cell_backward_plain``, then the weight-gradient products): every
    gradient (the 28 weights, ``x`` through both hoisted products, ``h0``) against autograd of
    K8's twin and against ``jax.grad`` of the JAX cell's scan, f64 at rtol 1e-9 and f32 at rtol
    1e-5 (with as much again of each tensor's largest value as absolute slack)."""
    residual, cond = GRAD_CASES[case]
    cell, _ = _cell(residual, cond)
    got = _port_grads(vrnn_ops.vrnn_cell, cell, dtype, residual, cond)
    twin = _port_grads(vrnn_ops.vrnn_cell_plain, cell, dtype, residual, cond)
    gp, gx, gh0 = jax_cell_grads[case, "float64" if dtype == torch.float64 else "float32"]
    ref = [gp[name] for name in _names(cell)] + [gx, gh0]
    labels = _names(cell) + ["x", "h0"]
    rtol = TOLERANCES[dtype]
    for label, a, b, r in zip(labels, got, twin, ref):
        a = a.double().numpy()
        scale = rtol * np.abs(r).max()
        np.testing.assert_allclose(a, b.double().numpy(), rtol=rtol, atol=scale, err_msg=f"{label} vs autograd")
        np.testing.assert_allclose(a, r, rtol=rtol, atol=scale, err_msg=f"{label} vs jax.grad")


def test_backward_twin_writes_the_kernels_layout():
    """``vrnn_cell_backward_plain``'s contract, the one K8-bwd keeps: ``dpre`` (B, T', 6R + 10H
    + 4Z) in ``grad_fields``' order with ``gi`` the gradient of ``xg`` and ``q0`` that of
    ``xpost``, and dh0; ``vrnn_cell_save`` fills every field of ``save_fields``."""
    cell, _ = _cell(True, True)
    x, h0, eps, g_out = (torch.tensor(a, dtype=torch.float64) if not isinstance(a, list)
                         else [torch.tensor(g, dtype=torch.float64) for g in a] for a in _grad_inputs(5))
    kw = [w.detach().double() for w in cell.cell_weights()]
    xpost, xg, kernel_weights = vrnn_ops.hoist(kw, x, True, True)
    xpost.requires_grad_(True)
    xg.requires_grad_(True)
    args = dict(residual_posterior=True, sd_beta=cell.prior_head.beta)
    outs, saved = vrnn_ops.vrnn_cell_save(kernel_weights, xpost, xg, h0, eps, sd_epsilon=1e-6, **args)
    assert saved.shape == (B, T, 9 * H + 2 * Z + 4 * R)
    dpre, dh0 = vrnn_ops.vrnn_cell_backward(kernel_weights, h0, eps, outs.h, outs.phi_z, saved, g_out, **args)
    assert dpre.shape == (B, T, 6 * R + 10 * H + 4 * Z) and dh0.shape == (B, R)
    fields = vrnn_ops.grad_fields(R, H, Z)
    assert list(fields) == ["gi", "gh", "phi3", "phi2", "phi1", "phi0", "head_p", "head_q", "p2", "q2", "p1", "q1",
                            "p0", "q0"]
    ref_outs, _ = vrnn_ops.vrnn_chain_plain(kernel_weights, xpost, xg, h0, eps, inference=True, sd_epsilon=1e-6,
                                            residual_posterior=True, sd_beta=cell.prior_head.beta)
    d_xpost, d_xg = torch.autograd.grad(sum((o * g).sum() for o, g in zip(ref_outs, g_out)), [xpost, xg])
    offset, width = fields["gi"]
    torch.testing.assert_close(dpre[..., offset:offset + width], d_xg, rtol=1e-9, atol=1e-12)
    offset, width = fields["q0"]
    torch.testing.assert_close(dpre[..., offset:offset + width], d_xpost, rtol=1e-9, atol=1e-12)
    assert torch.equal(outs.h, ref_outs.h)


@pytest.fixture(scope="module")
def golden_trajectory():
    """``train_step_vrnn.npz`` replayed through the port's train step in float64, the latent
    noise at zero (the golden's mean-sample patch, ``tests/parity/test_parity_train_step.py:20-21``),
    its beta 0.8 and free nats 1.0 handed over as the step's scalars, its clips."""
    data = np.load(GOLDENS / "train_step_vrnn.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    params = {k[2:]: data[k] for k in data.files if k.startswith("p|")}
    model = VRNNAudio(**meta["model_kwargs"]).double()
    weights.load_jax_params(model, params)
    tx = get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator().manual_seed(0))
    step = make_train_step(common.loss_fn)
    losses = []
    with mock.patch.object(port_vrnn, "gaussian_noise", lambda g, shape, like: torch.zeros(shape, dtype=like.dtype)):
        for x in data["x"]:
            state, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(data["x_sl"])),
                               meta["fwd_kwargs"])
            losses.append(float(mets["loss"]))
    return data, meta, params, losses, weights.flatten(weights.export_jax_params(model))


def test_train_step_replays_the_vrnn_golden_in_float64(golden_trajectory):
    """The torch reference's f64 trajectory of 4 clipped Adam steps (lr 3e-4, beta 0.8, free
    nats 1.0): losses at rtol 1e-6 (``PARITY.md:147-159``)."""
    data, meta, _, losses, _ = golden_trajectory
    assert meta["fwd_kwargs"] == dict(beta=0.8, free_nats=1.0)
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-6, atol=1e-9)


def test_vrnn_train_step_parameters_match_jax_in_float64(golden_trajectory):
    """The parameters after the golden's 4 steps against the JAX package's optax chain (the
    same clips) on the same batches, the JAX latent sample at its mean, both in float64: rtol
    1e-5 (``PARITY.md:147-159``)."""
    data, meta, params, _, final = golden_trajectory
    jmodel = JaxVRNNAudio(**meta["model_kwargs"])
    with jax.enable_x64(True), mock.patch.object(jax_vrnn, "rsample_gaussian", lambda key, mu, sd: mu):
        tx = jax_get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(params))
        opt_state = tx.init(jparams)

        @jax.jit
        def step(p, opt, x, x_sl):
            loss_of = lambda p_: jmodel.apply({"params": p_}, x, x_sl, rngs={"sample": jax.random.PRNGKey(0)},
                                              **meta["fwd_kwargs"])[0]
            grads = jax.grad(loss_of)(p)
            updates, opt = tx.update(grads, opt, p)
            return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), opt

        for x in data["x"]:
            jparams, opt_state = step(jparams, opt_state, jnp.asarray(x), jnp.asarray(data["x_sl"].astype(np.int32)))
        jfinal = weights.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    for name, value in final.items():
        np.testing.assert_allclose(value, jfinal[name], rtol=1e-5, atol=1e-9, err_msg=name)


class _StepLog(Tracker):
    """A tracker that also keeps each update's metric values."""

    def __init__(self):
        super().__init__()
        self.per_step = []

    def update(self, metrics, source):
        super().update(metrics, source)
        self.per_step.append((source, {m.name: m.value for m in metrics}))


def _forward_kwargs(model):
    """Wrap ``model.forward`` to record the keyword arguments of each call."""
    calls, forward = [], model.forward

    def recorded(*args, **kwargs):
        calls.append(kwargs)
        return forward(*args, **kwargs)

    model.forward = recorded
    return calls


def test_driver_train_steps_the_annealers():
    """``vrnn_audio.train``: beta and free nats stepped once a train step, handed to the forward
    as float32 scalars, and logged under ``train`` step for step as JAX's ``CosineAnnealer``
    gives them (``experiments/common.py:240-249, 750``; ``experiment_vrnn_audio.py:90-109``)."""
    args = vrnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL --epochs 1 "
                                 "--beta_anneal_steps 3 --free_nats_steps 4 --free_nats_start_value 2 --seed 0".split())
    model = vrnn_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    calls = _forward_kwargs(model)
    rng = np.random.default_rng(1)
    utterances = [(i, rng.uniform(-0.5, 0.5, n).astype(np.float32)) for i, n in enumerate((40, 64, 24, 56, 48))]
    log = _StepLog()
    state = vrnn_audio.train(model, args, [utterances[i:i + 1] for i in range(5)], log, device="cpu")
    beta = JaxCosineAnnealer(anneal_steps=3, start_value=0.0, end_value=1.0)
    free_nats = JaxCosineAnnealer(anneal_steps=2, constant_steps=2, start_value=2.0, end_value=0.0)
    expected = [(np.float32(beta.step()), np.float32(free_nats.step())) for _ in range(5)]
    assert state.step == 5 and len(calls) == 5 and [s for s, _ in log.per_step] == ["train"] * 5
    assert expected[0] == (0.0, 2.0) and expected[-1] == (1.0, 0.0)
    for call, (_, values), (b, f) in zip(calls, log.per_step, expected):
        assert call["beta"].dtype == torch.float32 and float(call["beta"]) == b and float(call["free_nats"]) == f
        assert values["beta"] == b and values["free_nats"] == f and np.isfinite(values["loss"])
    assert log.values["train"]["beta"] == 1.0


@pytest.mark.parametrize("family", ["wavenet", "lstm"])
def test_driver_train_without_annealers_hands_the_forward_no_scalars(family):
    """WaveNet's and LSTMAudio's ``train`` (``common.train`` without annealers): the forward gets
    the generator and no scalars, as before the annealers were wired in."""
    if family == "wavenet":
        args = wavenet_audio.build_args("--likelihood DMoL --n_stacks 1 --n_layers 2 --res_channels 8 --num_bits 8 "
                                        "--num_mix 3 --epochs 1 --seed 0".split())
        model = wavenet_audio.build_model(args, device="cpu")
    else:
        args = lstm_audio.build_args("--stack_size 8 --hidden_size 16 --num_mix 3 --epochs 1 --seed 0".split())
        model = lstm_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    calls = _forward_kwargs(model)
    utterance = np.random.default_rng(2).uniform(-0.5, 0.5, 64).astype(np.float32)
    common.train(model, args, [[(0, utterance)]], Tracker(), device="cpu")
    assert len(calls) == 1 and set(calls[0]) == {"generator"}


def test_free_nats_gradient_splits_ties_as_jax_does():
    """The gradient of ``max(kld, free_nats / Z)`` (``discount_free_nats``, as the ELBO takes it)
    against ``jax.grad`` of the JAX function, with elements below, above and exactly at the
    budget: both give 1 above, 0 below and 0.5 at a tie, as float32 and with the budget a
    float32 scalar as the train step hands it over."""
    from blvm_tpu.ops.variational import discount_free_nats as jax_discount
    from blvm_tpu_torch.ops.variational import discount_free_nats

    kld = np.asarray([[[0.1, 0.25, 0.4, 0.25]], [[0.25, 0.0, 1.0, 0.2]]], np.float32)  # budget 1.0 / 4 = 0.25
    w = np.random.default_rng(3).normal(size=kld.shape).astype(np.float32)
    ref = np.asarray(jax.grad(lambda k: (jax_discount(k, np.float32(1.0), shared_dims=-1) * w).sum())(kld))
    for free_nats in (1.0, torch.tensor(1.0, dtype=torch.float32)):
        k = torch.tensor(kld, requires_grad=True)
        (discount_free_nats(k, free_nats, shared_dims=-1) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(k.grad.numpy(), ref)
    np.testing.assert_array_equal(ref / w, np.where(kld > 0.25, 1.0, np.where(kld == 0.25, 0.5, 0.0)))
