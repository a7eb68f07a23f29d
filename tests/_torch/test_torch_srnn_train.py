"""The SRNN's training half on the CPU: ``GRURecurrenceFunction`` (the plain save-forward and
K7-bwd's twin, ``gru_recurrence_backward_plain``) and ``SRNNChainFunction`` (K9's save twin and
``srnn_chain_backward_plain``) against autograd of their forward twins and against ``jax.grad``
of the JAX ``GRU`` and of the JAX ``_SRNNStep`` scanned over T' steps, in float64; the backward
twins' layouts, the ones K7-bwd and K9-bwd keep; the whole ``SRNNAudio`` gradient against
``jax.grad`` of the JAX model with the latent noise supplied; the frozen f64 trajectory
``train_step_srnn.npz`` replayed through the port's train step and held to the JAX package's
optax chain; and the driver's ``train`` with its annealers. Inputs and weights come from numpy
seeds; each JAX reference compiles once, in a module-scoped fixture."""

import contextlib
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.models.srnn as jax_srnn
from blvm_tpu.models import SRNNAudio as JaxSRNNAudio
from blvm_tpu.models.srnn import _SRNNStep as JaxSRNNStep
from blvm_tpu.modules.recurrent import GRU as JaxGRU
from blvm_tpu.training.annealers import CosineAnnealer as JaxCosineAnnealer
from blvm_tpu.training.optim import get_optimizer as jax_get_optimizer
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import common, srnn_audio
from blvm_tpu_torch.models import SRNNAudio
from blvm_tpu_torch.models import srnn as port_srnn
from blvm_tpu_torch.models.srnn import _SRNNStep
from blvm_tpu_torch.modules.recurrent import GRU
from blvm_tpu_torch.ops import recurrent as recurrent_ops
from blvm_tpu_torch.ops import srnn as srnn_ops
from blvm_tpu_torch.training.optim import get_optimizer
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step

GOLDENS = Path(__file__).resolve().parent.parent / "parity" / "goldens"
B, T, D, R, H, Z = 4, 10, 8, 32, 16, 4  # the golden's widths: r_dim 32, hidden 16, latent 4
LENGTHS = np.asarray([10, 7, 3, 0])  # a zero-length row among them
# f64: the same math in another order (the Functions' hand-written backwards against autograd, the port
# against XLA), over 10 steps of chains that do not amplify it
RTOL = 1e-9
# name: (mask, a given initial state); every case with a gradient of h_n
GRU_CASES = {
    "ragged_with_a_zero_length_row": ("ragged", False),
    "flipped_mask_given_state": ("flipped", True),
    "no_mask_given_state": ("none", True),
}
# name: (residual_posterior, fresh init: zero biases, d_0 = 0 and z0 = 0, so the prior's pre-activations
# at the first step are exactly 0, where jax.nn.leaky_relu's gradient is 1 and F.leaky_relu's 0.01)
CHAIN_CASES = {
    "residual": (True, False),
    "plain_posterior": (False, False),
    "fresh_init_zero_biases_and_states": (True, True),
}


def _mask(kind):
    mask = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float64)
    return {"ragged": mask, "flipped": mask[:, ::-1].copy(), "none": np.ones_like(mask)}[kind]


def _gru_inputs(seed=0):
    """x, h0 and the gradients of out and h_n, numpy float64."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, D)), rng.normal(scale=0.5, size=(B, R)), rng.normal(size=(B, T, R)),
            rng.normal(size=(B, R)))


@pytest.fixture(scope="module")
def jax_gru_grads():
    """``jax.grad`` of ``sum(out g_out) + sum(h_n g_n)`` through the JAX ``GRU`` by its parameters,
    x and h0 for every GRU case, float64, one compile (the mask passed as data, ones for none)."""
    params = weights.random_jax_params(GRU(D, R), seed=1)
    x, h0, g_out, g_n = _gru_inputs()
    out = {}
    with jax.enable_x64(True):
        def loss(p, x_, m_, h_):
            o, h_n = JaxGRU(hidden_size=R).apply({"params": p}, x_, mask=m_, initial_state=h_)
            return (o * g_out).sum() + (h_n * g_n).sum()

        grad = jax.jit(jax.grad(loss, argnums=(0, 1, 3)))
        tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(params))
        for name, (kind, given) in GRU_CASES.items():
            gp, gx, gh = grad(tree, x, _mask(kind), h0 if given else np.zeros_like(h0))
            out[name] = (weights.flatten(jax.tree_util.tree_map(np.asarray, gp)), np.asarray(gx), np.asarray(gh))
    return params, out


def _port_gru_grads(model, kind, given, plain):
    x, h0, g_out, g_n = (torch.tensor(a) for a in _gru_inputs())
    x.requires_grad_(True)
    h0 = (h0 if given else torch.zeros_like(h0)).requires_grad_(True)
    mask = None if kind == "none" else torch.tensor(_mask(kind))
    with mock.patch.object(recurrent_ops, "gru_recurrence", recurrent_ops.gru_recurrence_plain) if plain \
            else contextlib.nullcontext():
        out, h_n = model(x, mask=mask, initial_state=h0)
    leaves = [*model.parameters(), x, h0]
    return torch.autograd.grad((out * g_out).sum() + (h_n * g_n).sum(), leaves)


@pytest.mark.parametrize("case", list(GRU_CASES))
def test_gru_function_gradients_match_autograd_and_jax(jax_gru_grads, case):
    """The port's ``GRU`` with gradients runs ``GRURecurrenceFunction`` on the CPU (the save twin,
    ``gru_recurrence_backward_plain``, ``gru_weight_grads``): the gradients of ``w_ih``, ``b_ih``,
    ``w_hh``, ``b_hh``, x and h0 against autograd of K7's twin and ``jax.grad`` of the JAX ``GRU``,
    f64 at rtol 1e-9 (with as much of each tensor's largest value as absolute slack); under the
    masks the zero-length row's state passes through unchanged: its d h0 is its d h_n."""
    params, ref = jax_gru_grads
    kind, given = GRU_CASES[case]
    model = weights.load_jax_params(GRU(D, R), params).double()
    got = _port_gru_grads(model, kind, given, plain=False)
    twin = _port_gru_grads(model, kind, given, plain=True)
    gp, gx, gh0 = ref[case]
    labels = [name for name, _ in model.named_parameters()] + ["x", "h0"]
    for label, a, b, r in zip(labels, got, twin, [gp[n] for n in labels[:-2]] + [gx, gh0]):
        scale = RTOL * np.abs(r).max()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=scale, err_msg=f"{label} vs autograd")
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=scale, err_msg=f"{label} vs jax.grad")
    if kind != "none":
        np.testing.assert_array_equal(got[-1][3].numpy(), _gru_inputs()[3][3])


def _step(residual, fresh):
    step = _SRNNStep(H, Z, R, residual_posterior=residual)
    params = weights.random_jax_params(step, seed=3 + residual)
    if fresh:  # flax's Dense init: zero biases
        params = {k: np.zeros_like(v) if k.endswith("bias") else v for k, v in params.items()}
    weights.load_jax_params(step, params)
    return step.double(), params


def _chain_inputs(fresh, seed=4):
    """d, a, z0, the noise and the gradients of the five outputs, numpy float64; fresh: d_0 = 0 (the
    shifted d GRU's first step is its zero initial state) and z0 = 0."""
    rng = np.random.default_rng(seed)
    d, a = rng.normal(scale=0.5, size=(B, T, R)), rng.normal(scale=0.5, size=(B, T, R))
    z0 = rng.normal(scale=0.5, size=(B, Z))
    if fresh:
        d[:, 0], z0[:] = 0.0, 0.0
    return d, a, z0, rng.normal(size=(B, T, Z)), [rng.normal(size=(B, T, Z)) for _ in range(5)]


OUTPUTS = ("z", "enc_mu", "enc_sd", "prior_mu", "prior_sd")


@pytest.fixture(scope="module")
def jax_chain_grads():
    """``jax.grad`` of ``sum(outputs * g_out)`` through the JAX ``_SRNNStep`` scanned over T' steps
    (its ``rsample_gaussian`` made ``mu + sd e_t``, ``e_t`` the noise of the step being traced) by the
    step's parameters, d, a and z0, float64: one compile per residual setting."""
    out = {}
    holder = {}
    with jax.enable_x64(True), mock.patch.object(jax_srnn, "rsample_gaussian",
                                                 lambda key, mu, sd: mu + sd * holder["eps"]):
        for residual in (True, False):
            jstep = JaxSRNNStep(h_dim=H, z_dim=Z, r_dim=R, use_phi_z=False, gated_stochastic_transfer=False,
                                residual_posterior=residual)

            def loss(p, d_, a_, z_, e_, gs, jstep=jstep):
                def body(carry, inputs):
                    d_t, a_t, e_t = inputs
                    holder["eps"] = e_t
                    carry, outs = jstep.apply({"params": p}, carry, (d_t, a_t), rngs={"sample": jax.random.PRNGKey(0)})
                    return carry, tuple(outs[k] for k in OUTPUTS)

                _, outs = jax.lax.scan(body, (z_,), tuple(jnp.swapaxes(v, 0, 1) for v in (d_, a_, e_)))
                return sum((jnp.swapaxes(o, 0, 1) * g).sum() for o, g in zip(outs, gs))

            grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))
            for name, (res, fresh) in CHAIN_CASES.items():
                if res != residual:
                    continue
                _, params = _step(res, fresh)
                d, a, z0, eps, g_out = _chain_inputs(fresh)
                tree = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), weights.unflatten(params))
                gp, gd, ga, gz = grad(tree, d, a, z0, eps, g_out)
                out[name] = (weights.flatten(jax.tree_util.tree_map(np.asarray, gp)), *map(np.asarray, (gd, ga, gz)))
    return out


def _port_chain_grads(step, fresh, plain):
    d, a, z0, eps, g_out = _chain_inputs(fresh)
    d, a, z0 = (torch.tensor(v, requires_grad=True) for v in (d, a, z0))
    with mock.patch.object(srnn_ops, "srnn_chain", srnn_ops.srnn_chain_plain) if plain else contextlib.nullcontext():
        outs, _, _ = step.run(d, a, z0, torch.tensor(eps))
    loss = sum((getattr(outs, k) * torch.tensor(g)).sum() for k, g in zip(OUTPUTS, g_out))
    names = [name for name, _ in step.named_parameters()]
    return names, torch.autograd.grad(loss, [*step.parameters(), d, a, z0])


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_function_gradients_match_autograd_and_jax(jax_chain_grads, case):
    """``_SRNNStep.run`` with gradients runs the hoisted products and ``SRNNChainFunction`` on the CPU
    (K9's save twin, ``srnn_chain_backward_plain``, ``chain_weight_grads``): the gradients of the 16
    chain parameters, d, a and z0 against autograd of K9's twin and ``jax.grad`` of the JAX step's
    scan, f64 at rtol 1e-9; at a fresh init (zero biases, d_0 = 0, z0 = 0) the prior's pre-activations
    at the first step are exactly 0 and both follow jax.nn.leaky_relu's gradient there (1, not 0.01)."""
    residual, fresh = CHAIN_CASES[case]
    step, _ = _step(residual, fresh)
    names, got = _port_chain_grads(step, fresh, plain=False)
    _, twin = _port_chain_grads(step, fresh, plain=True)
    gp, gd, ga, gz = jax_chain_grads[case]
    labels = names + ["d", "a", "z0"]
    refs = [gp[n.replace(".", "/")] for n in names] + [gd, ga, gz]
    for label, x, y, r in zip(labels, got, twin, refs):
        scale = RTOL * np.abs(r).max()
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL, atol=scale, err_msg=f"{label} vs autograd")
        np.testing.assert_allclose(x.numpy(), r, rtol=RTOL, atol=scale, err_msg=f"{label} vs jax.grad")
    if fresh:
        xp = srnn_ops.hoist([w.detach() for w in step.chain_weights()], torch.tensor(_chain_inputs(True)[0]), None,
                            False)[0]
        assert not xp[:, 0].any()  # the trap is live: every prior unit's first pre-activation is exactly 0


def test_backward_twins_write_the_kernels_layout():
    """The contracts K7-bwd and K9-bwd keep: ``gru_recurrence_backward_plain`` gives ``d_gi`` (the
    gradient of ``xw``) and ``d_gh`` (B, T, 3H), ``d_gh``'s n part ``d_gi``'s times r and its r and z
    parts equal, from the save buffer (B, T, 5H); ``srnn_chain_backward_plain`` gives ``dpre`` (B, T',
    4Z + 6H) in ``grad_fields``' order with ``p1`` and ``q1`` the gradients of ``xp`` and ``xq``, and
    dz0, from the save buffer of ``save_fields`` (B, T', 6H + 2Z)."""
    rng = np.random.default_rng(6)
    xw, w_hh, b_hh = (torch.tensor(rng.normal(scale=0.4, size=s), requires_grad=i == 0)
                      for i, s in enumerate(((B, T, 3 * R), (R, 3 * R), (3 * R,))))
    h0, g_out = torch.tensor(rng.normal(size=(B, R))), torch.tensor(rng.normal(size=(B, T, R)))
    mask = torch.tensor(_mask("flipped"))
    out, h_n, saved = recurrent_ops.gru_recurrence_save(xw.detach(), w_hh, b_hh, mask, h0)
    assert saved.shape == (B, T, 5 * R) and torch.equal(saved[:, 0, :R], h0)
    d_gi, d_gh, d_h0 = recurrent_ops.gru_recurrence_backward_plain(w_hh, mask, saved, g_out, None)
    assert d_gi.shape == d_gh.shape == (B, T, 3 * R) and d_h0.shape == (B, R)
    ref_out, _ = recurrent_ops.gru_recurrence_plain(xw, w_hh, b_hh, mask, h0)
    assert torch.equal(out, ref_out.detach())
    torch.testing.assert_close(d_gi, torch.autograd.grad((ref_out * g_out).sum(), xw)[0], rtol=1e-12, atol=1e-14)
    assert torch.equal(d_gh[..., :2 * R], d_gi[..., :2 * R])
    assert torch.equal(d_gh[..., 2 * R:], d_gi[..., 2 * R:] * saved[..., R:2 * R])  # r

    step, _ = _step(True, False)
    d, a, z0, eps, g_out = (torch.tensor(v) if not isinstance(v, list) else [torch.tensor(g) for g in v]
                            for v in _chain_inputs(False, seed=7))
    w = [t.detach() for t in step.chain_weights()]
    xp, xq, kernel_weights = srnn_ops.hoist(w, d, a, True)
    xp.requires_grad_(True)
    xq.requires_grad_(True)
    head = step.prior_net.layers_1
    kw = dict(residual_posterior=True, sd_beta=head.beta)
    outs, saved = srnn_ops.srnn_chain_save(kernel_weights, xp.detach(), xq.detach(), z0, eps,
                                           sd_epsilon=head.epsilon, **kw)
    assert list(srnn_ops.save_fields(H, Z)) == ["p1", "q1", "p2", "q2", "p3", "q3", "raw_p", "raw_q"]
    assert saved.shape == (B, T, 6 * H + 2 * Z)
    dpre, dz0 = srnn_ops.srnn_chain_backward_plain(kernel_weights, eps, saved, g_out, **kw)
    fields = srnn_ops.grad_fields(H, Z)
    assert list(fields) == ["head_p", "head_q", "p3", "q3", "p2", "q2", "p1", "q1"]
    assert dpre.shape == (B, T, 4 * Z + 6 * H) and dz0.shape == (B, Z)
    ref = srnn_ops.srnn_chain_plain(kernel_weights, xp, xq, z0, eps, inference=True, sd_epsilon=head.epsilon, **kw)
    assert all(torch.equal(u, v.detach()) for u, v in zip(outs, ref))
    d_xp, d_xq = torch.autograd.grad(sum((o * g).sum() for o, g in zip(ref, g_out)), [xp, xq])
    for name, want in (("p1", d_xp), ("q1", d_xq)):
        offset, width = fields[name]
        torch.testing.assert_close(dpre[..., offset:offset + width], want, rtol=1e-12, atol=1e-14)


def _small_model():
    model = SRNNAudio(likelihood="DMoL", input_size=8, hidden_size=16, latent_size=4, residual_posterior=True)
    params = weights.random_jax_params(model, seed=9)
    weights.load_jax_params(model, params)
    return model.double(), params


SRNN_B, SRNN_T = 3, 128  # 16 stacks of 8


def _model_batch():
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, (SRNN_B, SRNN_T))
    x_sl = np.asarray([128, 97, 40], np.int32)
    for row, n in enumerate(x_sl):
        x[row, n:] = 0.0
    return x, x_sl, rng.normal(size=(SRNN_B, 4))  # the latent noise, one draw a row for every step


@pytest.fixture(scope="module")
def jax_model_grads():
    """``jax.grad`` of the JAX ``SRNNAudio``'s loss (beta 0.8, free nats 0.5, the driver's residual
    posterior and smoothing) by every parameter, float64, its ``rsample_gaussian`` made
    ``mu + sd e`` with the supplied noise ``e`` (B, Z) at every step."""
    _, params = _small_model()
    x, x_sl, e = _model_batch()
    jmodel = JaxSRNNAudio(likelihood="DMoL", input_size=8, hidden_size=16, latent_size=4, residual_posterior=True)
    with jax.enable_x64(True), mock.patch.object(jax_srnn, "rsample_gaussian", lambda key, mu, sd: mu + sd * e):
        loss = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
            {"params": p}, x, x_sl, beta=0.8, free_nats=0.5, rngs={"sample": jax.random.PRNGKey(0)})[0]))
        tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(params))
        value, grads = loss(tree)
    return float(value), weights.flatten(jax.tree_util.tree_map(np.asarray, grads))


def test_srnn_audio_gradients_match_jax_in_float64(jax_model_grads):
    """The whole ``SRNNAudio`` loss and the gradient of every parameter through both GRU Functions,
    the chain's Function, the hoisted products and the DMoL loss, against ``jax.grad`` of the JAX
    model, float64, the latent noise supplied alike: loss at rtol 1e-9, gradients at rtol 1e-7 (with
    as much of each tensor's largest value as absolute slack: the DMoL ladder's sums in another
    order)."""
    model, _ = _small_model()
    x, x_sl, e = _model_batch()
    eps = torch.tensor(e)[:, None].expand(SRNN_B, 16, 4)
    loss, _, _ = model(torch.tensor(x), torch.tensor(x_sl), beta=0.8, free_nats=0.5, eps=eps)
    loss.backward()
    value, ref = jax_model_grads
    np.testing.assert_allclose(loss.item(), value, rtol=1e-9)
    got = {name.replace(".", "/"): p.grad.numpy() for name, p in model.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        np.testing.assert_allclose(g, ref[name], rtol=1e-7, atol=1e-7 * np.abs(ref[name]).max(), err_msg=name)


@pytest.fixture(scope="module")
def golden_trajectory():
    """``train_step_srnn.npz`` replayed through the port's train step in float64, the latent noise at
    zero (the golden's mean-sample patch, ``tests/parity/test_parity_train_step.py:320-322``), its beta
    0.8 and free nats 1.0 handed over as the step's scalars, its clips."""
    data = np.load(GOLDENS / "train_step_srnn.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    params = {k[2:]: data[k] for k in data.files if k.startswith("p|")}
    model = SRNNAudio(**meta["model_kwargs"]).double()
    weights.load_jax_params(model, params)
    tx = get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator().manual_seed(0))
    step = make_train_step(common.loss_fn)
    losses = []
    with mock.patch.object(port_srnn, "gaussian_noise", lambda g, shape, like: torch.zeros(shape, dtype=like.dtype)):
        for x in data["x"]:
            state, mets = step(state, dict(x=torch.from_numpy(x), x_sl=torch.from_numpy(data["x_sl"])),
                               meta["fwd_kwargs"])
            losses.append(float(mets["loss"]))
    return data, meta, params, losses, weights.flatten(weights.export_jax_params(model))


def test_train_step_replays_the_srnn_golden_in_float64(golden_trajectory):
    """The torch reference's f64 trajectory of 4 clipped Adam steps (lr 3e-4, beta 0.8, free nats
    1.0): losses at rtol 1e-6 (``PARITY.md:147-159``)."""
    data, meta, _, losses, _ = golden_trajectory
    assert meta["fwd_kwargs"] == dict(beta=0.8, free_nats=1.0) and meta["patch_modules"] == ["blvm_tpu.models.srnn"]
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-6, atol=1e-9)


def test_srnn_train_step_parameters_match_jax_in_float64(golden_trajectory):
    """The parameters after the golden's 4 steps against the JAX package's optax chain (the same
    clips) on the same batches, the JAX latent sample at its mean, both in float64: rtol 1e-5
    (``PARITY.md:147-159``)."""
    data, meta, params, _, final = golden_trajectory
    jmodel = JaxSRNNAudio(**meta["model_kwargs"])
    with jax.enable_x64(True), mock.patch.object(jax_srnn, "rsample_gaussian", lambda key, mu, sd: mu):
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


def test_driver_train_steps_the_annealers():
    """``srnn_audio.train``: beta and free nats stepped once a train step, handed to the forward as
    float32 scalars, and logged under ``train`` step for step as JAX's ``CosineAnnealer`` gives them
    (``experiments/experiment_srnn_audio.py:71-90``)."""
    args = srnn_audio.build_args("--stack_frames 8 --hidden_size 16 --latent_size 4 --likelihood DMoL --epochs 1 "
                                 "--beta_anneal_steps 3 --free_nats_steps 4 --free_nats_start_value 2 --seed 0".split())
    model = srnn_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    calls, forward = [], model.forward

    def recorded(*a, **kwargs):
        calls.append(kwargs)
        return forward(*a, **kwargs)

    model.forward = recorded
    rng = np.random.default_rng(1)
    utterances = [(i, rng.uniform(-0.5, 0.5, n).astype(np.float32)) for i, n in enumerate((40, 64, 24, 56, 48))]
    log = _StepLog()
    state = srnn_audio.train(model, args, [utterances[i:i + 1] for i in range(5)], log, device="cpu")
    beta = JaxCosineAnnealer(anneal_steps=3, start_value=0.0, end_value=1.0)
    free_nats = JaxCosineAnnealer(anneal_steps=2, constant_steps=2, start_value=2.0, end_value=0.0)
    expected = [(np.float32(beta.step()), np.float32(free_nats.step())) for _ in range(5)]
    assert state.step == 5 and len(calls) == 5 and [s for s, _ in log.per_step] == ["train"] * 5
    assert expected[0] == (0.0, 2.0) and expected[-1] == (1.0, 0.0)
    for call, (_, values), (b, f) in zip(calls, log.per_step, expected):
        assert call["beta"].dtype == torch.float32 and float(call["beta"]) == b and float(call["free_nats"]) == f
        assert values["beta"] == b and values["free_nats"] == f and np.isfinite(values["loss"])
    assert all(torch.isfinite(p).all() for p in model.parameters())
