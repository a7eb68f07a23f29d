"""The CW-VAE's training half on the CPU: the frozen f64 trajectory ``train_step_cwvae.npz`` replayed through the
port's train step and held to the JAX package's optax chain; the whole ``CWVAEAudio``'s loss and gradient against
``jax.grad`` (the golden's two-level configuration over 32 top-level steps, at the golden's scalars and at beta 1,
free nats 0, and with the precision-weighted posterior); ``RSSMChainFunction`` (K10's save twin,
``rssm_chain_backward_plain``, ``chain_weight_grads``) and ``DepthwiseNormFunction`` (K11's save twin,
``depthwise_norm_backward_plain``) against autograd of their forward twins and ``jax.grad`` of the JAX ``RSSMCell``
scanned by ``lax.scan`` and of the JAX block's chain; and the driver's ``train`` with its annealers. On the CPU the
Functions run the twins, so these gradients are the ones K10-bwd and K11-bwd are held to on the card. Everything
is float64; the Gaussian latent samples are at their mean where the golden's are (``patch_modules:
["blvm_tpu.modules.rssm"]``), and ``mu + sd e_t`` with supplied noise in the chain's checks. GroupNorm runs over at
least 30 rows everywhere. Inputs come from numpy seeds; each JAX reference compiles once, in a module-scoped
fixture, at XLA's CPU optimization level 0."""

import inspect
import json
from pathlib import Path
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.modules.rssm as jax_rssm
from blvm_tpu.models import CWVAEAudio as JaxCWVAEAudio
from blvm_tpu.modules import convolutions as jax_conv
from blvm_tpu.training.annealers import CosineAnnealer as JaxCosineAnnealer
from blvm_tpu.training.optim import get_optimizer as jax_get_optimizer
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import clockwork_audio, common
from blvm_tpu_torch.models import CWVAEAudio
from blvm_tpu_torch.models.clockwork_vae import clockwork_vae as port_cwvae
from blvm_tpu_torch.modules.rssm import RSSMCell
from blvm_tpu_torch.ops import depthwise as depthwise_ops
from blvm_tpu_torch.ops import rssm as rssm_ops
from blvm_tpu_torch.training.optim import get_optimizer
from blvm_tpu_torch.training.train_state import TrainState
from blvm_tpu_torch.training.train_step import make_train_step

GOLDEN = Path(__file__).resolve().parent.parent / "parity" / "goldens" / "train_step_cwvae.npz"
# the whole model's gradient: the golden's model with the precision posterior off (its own) and on (the run specs'),
# over 256 samples (32 top-level steps at stride 8), one row right-padded
MODEL_CASES = {"golden": {}, "precision_posterior": dict(precision_posterior=True)}
SCALARS = {"golden_scalars": None, "beta1_free_nats0": dict(beta=1.0, free_nats=0.0)}
GRAD_LENGTHS = (256, 201)
# the RSSM chain: hidden, latent, enc and context widths, steps, rows; name: (residual, precision, context, resets,
# the output gradients absent (indices into z, h, enc_mu, enc_sd, prior_mu, prior_sd))
H, Z, E, CTX, T, B = 8, 4, 6, 5, 12, 3
CHAIN_CASES = {
    "precision_context_resets": (False, True, True, True, ()),
    "precision_context_some_absent": (False, True, True, False, (0, 4)),
    "residual_no_context_some_absent": (True, False, False, False, (1, 3)),
}
OUTPUTS = ("z", "h", "enc_mu", "enc_sd", "prior_mu", "prior_sd")
RESET_EVERY = 4
# the depthwise chain: rows, channels, taps; name: (stride, dilation, transposed, an all-padding row)
N, C, K = 61, 8, 5
BLOCK_CASES = {"encoder_stride4": (4, 1, False, False), "encoder_dilated": (1, 2, False, False),
               "decoder_stride4": (4, 1, True, False), "encoder_padding_row": (4, 1, False, True),
               "decoder_padding_row": (4, 1, True, True)}
RTOL = 1e-7  # float64 against float64: the same arithmetic in other orders


def _golden():
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    return data, meta, {k[2:]: data[k] for k in data.files if k.startswith("p|")}


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's CPU backend optimization level 0: the same program compiled
    faster; only the order of some sums may differ, well inside the tolerances."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(tree))


def _zero_noise():
    """The port's latent noise at zero: z at the posterior mean, as the golden's JAX side."""
    return mock.patch.object(port_cwvae, "gaussian_noise",
                             lambda g, shape, like: torch.zeros(shape, dtype=like.dtype, device=like.device))


def _model(meta, params=None, seed=3, **kwargs):
    """The port's model in float64 at the golden's configuration (``kwargs`` besides) and the tree it holds."""
    model = CWVAEAudio(**{**meta["model_kwargs"], **kwargs}, device="cpu")
    params = weights.random_jax_params(model, seed) if params is None else params
    model = model.double()
    weights.load_jax_params(model, params)
    return model, params


def _batch(lengths, T_, seed=7):
    x = np.random.default_rng(seed).uniform(-1, 1, (len(lengths), T_))
    for row, n in enumerate(lengths):
        x[row, n:] = 0.0
    return x, np.asarray(lengths, np.int32)


def _scalars(meta, name):
    return SCALARS[name] or meta["fwd_kwargs"]


@pytest.fixture(scope="module")
def jax_models():
    """In float64 with the latents at the mean: the JAX model's value and gradient by every parameter at both
    scalar settings, one compile a model case; and the JAX package's optax chain (the golden's clips) stepped with
    the golden model's gradients over the golden's 4 batches."""
    data, meta, golden_params = _golden()
    out = {}
    with jax.enable_x64(True), mock.patch.object(jax_rssm, "rsample_gaussian", lambda key, mu, sd: mu):
        x, x_sl = _batch(GRAD_LENGTHS, GRAD_LENGTHS[0])
        for case, extra in MODEL_CASES.items():
            _, params = _model(meta, golden_params if case == "golden" else None, **extra)
            jmodel = JaxCWVAEAudio(**{**meta["model_kwargs"], **extra})

            def loss_of(p, x_, sl_, beta, free_nats, m=jmodel):
                return m.apply({"params": p}, x_, sl_, beta=beta, free_nats=free_nats,
                               rngs={"sample": jax.random.PRNGKey(0)})[0]

            p64 = _f64(params)
            vg = _compiled(jax.value_and_grad(loss_of), p64, x, x_sl, 1.0, 0.0)
            for name in SCALARS:
                s = _scalars(meta, name)
                value, grads = vg(p64, x, x_sl, float(s["beta"]), float(s["free_nats"]))
                out[case, name] = (params, float(value), weights.flatten(jax.tree_util.tree_map(np.asarray, grads)))

        jmodel = JaxCWVAEAudio(**meta["model_kwargs"])
        s = meta["fwd_kwargs"]
        vg = _compiled(jax.value_and_grad(lambda p, x_, sl_: jmodel.apply(
            {"params": p}, x_, sl_, rngs={"sample": jax.random.PRNGKey(0)}, **s)[0]), _f64(golden_params),
            data["x"][0], data["x_sl"].astype(np.int32))
        tx = jax_get_optimizer("Adam", 3e-4, clip_grad_norm=meta["clip_norm"], clip_grad_value=meta["clip_value"])
        jparams = _f64(golden_params)
        opt_state = tx.init(jparams)
        update = None
        for xb in data["x"]:
            _, grads = vg(jparams, xb, data["x_sl"].astype(np.int32))
            update = update or _compiled(tx.update, grads, opt_state, jparams)
            updates, opt_state = update(grads, opt_state, jparams)
            jparams = jax.tree_util.tree_map(lambda a, u: a + u, jparams, updates)
        final = weights.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    return out, final


@pytest.fixture(scope="module")
def golden_trajectory():
    """``train_step_cwvae.npz`` replayed through the port's train step in float64: the latent noise at zero, its
    beta 0.7 and free nats 2 handed over as the step's scalars, its clips."""
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


def test_train_step_replays_the_cwvae_golden_in_float64(golden_trajectory):
    """The torch reference's f64 trajectory of 4 clipped Adam steps (lr 3e-4, beta 0.7, free nats 2): losses at
    rtol 1e-6 (``PARITY.md:147-159``)."""
    data, meta, losses, _ = golden_trajectory
    assert meta["fwd_kwargs"] == dict(beta=0.7, free_nats=2.0)
    assert meta["patch_modules"] == ["blvm_tpu.modules.rssm"]
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-6, atol=1e-9)


def test_cwvae_train_step_parameters_match_jax_in_float64(golden_trajectory, jax_models):
    """The parameters after the golden's 4 steps against the JAX package's optax chain (the same clips) on the same
    batches, the JAX latent sample at its mean, both in float64: rtol 1e-5 (``PARITY.md:147-159``)."""
    final = golden_trajectory[3]
    jfinal = jax_models[1]
    assert final.keys() == jfinal.keys()
    for name, value in final.items():
        np.testing.assert_allclose(value, jfinal[name], rtol=1e-5, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("scalars", list(SCALARS))
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_cwvae_gradients_match_jax_in_float64(case, scalars, jax_models):
    """The whole CWVAEAudio's loss and the gradient of every parameter (through both levels' RSSM chains, the lower
    level's context from the upper, the coders' depthwise chains, the KL with free nats scaled by each level's stride
    and the DMoL loss) against ``jax.grad`` of the JAX model, float64, z at the mean alike, 32 top-level steps with
    one row right-padded: loss at rtol 1e-9, gradients at rtol 1e-7 (with as much of each tensor's largest value as
    absolute slack). At the golden's scalars (beta 0.7, free nats 2) the free nats cut part of the KL's gradient; at
    beta 1, free nats 0 every head's backward is exercised."""
    _, meta, _ = _golden()
    params, jvalue, jgrads = jax_models[0][case, scalars]
    model, _ = _model(meta, params, **MODEL_CASES[case])
    x, x_sl = _batch(GRAD_LENGTHS, GRAD_LENGTHS[0])
    with _zero_noise():
        loss, _, _ = model(torch.from_numpy(x), torch.from_numpy(x_sl), **_scalars(meta, scalars))
    loss.backward()
    grads = {name.replace(".", "/"): p.grad.numpy() for name, p in model.named_parameters()}
    np.testing.assert_allclose(loss.item(), jvalue, rtol=1e-9)
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], rtol=RTOL, atol=RTOL * np.abs(jgrads[name]).max(), err_msg=name)


def _cell(case):
    residual, precision, context, _, _ = CHAIN_CASES[case]
    cell = RSSMCell(Z, H, CTX if context else 0, E, residual_posterior=residual, precision_posterior=precision)
    params = weights.random_jax_params(cell, 5 + residual)
    weights.load_jax_params(cell, params)
    return cell.double(), params


def _chain_inputs(case, seed=8):
    """enc, the context, z0, h0, the noise, the reset mask (T,) and the six output gradients (zeros where absent),
    numpy float64."""
    _, _, context, resets, absent = CHAIN_CASES[case]
    rng = np.random.default_rng(seed)
    widths = (Z, H, Z, Z, Z, Z)
    grads = [np.zeros((B, T, w)) if i in absent else rng.normal(size=(B, T, w)) for i, w in enumerate(widths)]
    mask = (np.arange(T) % RESET_EVERY == 0).astype(np.float64) * resets
    return (rng.normal(size=(B, T, E)), rng.normal(size=(B, T, CTX if context else 0)),
            rng.normal(scale=0.5, size=(B, Z)), rng.normal(scale=0.5, size=(B, H)), rng.normal(size=(B, T, Z)), mask,
            grads)


@pytest.fixture(scope="module")
def jax_chain_grads():
    """``jax.grad`` of ``sum(outputs * g_out)`` through the JAX ``RSSMCell`` scanned over T' steps (its
    ``rsample_gaussian`` made ``mu + sd e_t``, ``e_t`` the noise of the step being traced; the carry zeroed where
    the reset mask is 1, as ``CWVAE._run_level`` does) by the cell's parameters, enc, the context, z0 and h0, float64:
    one compile per posterior and context width."""
    out, holder, compiled = {}, {}, {}
    with jax.enable_x64(True), mock.patch.object(jax_rssm, "rsample_gaussian",
                                                 lambda key, mu, sd: mu + sd * holder["eps"]):
        for case, (residual, precision, context, _, _) in CHAIN_CASES.items():
            key = (residual, precision, context)
            if key not in compiled:
                jcell = jax_rssm.RSSMCell(z_dim=Z, h_dim=H, c_dim=CTX if context else 0, e_dim=E,
                                          residual_posterior=residual, precision_posterior=precision)

                def loss(p, enc, ctx, z0, h0, eps, mask, gs, jcell=jcell):
                    def body(carry, xs):
                        enc_t, ctx_t, e_t, reset_t = xs
                        z, h = carry
                        z, h = z * (1.0 - reset_t), h * (1.0 - reset_t)
                        holder["eps"] = e_t
                        state, dists = jcell.apply({"params": p}, enc_t, (z, h), ctx_t, jax.random.PRNGKey(0))
                        return state, tuple(state[1] if k == "h" else dists[k] for k in OUTPUTS)

                    xs = tuple(jnp.swapaxes(v, 0, 1) for v in (enc, ctx, eps)) + (mask,)
                    _, outs = jax.lax.scan(body, (z0, h0), xs)
                    return sum((jnp.swapaxes(o, 0, 1) * g).sum() for o, g in zip(outs, gs))

                compiled[key] = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))
            _, params = _cell(case)
            grads = compiled[key](_f64(params), *_chain_inputs(case))
            out[case] = (weights.flatten(jax.tree_util.tree_map(np.asarray, grads[0])), *map(np.asarray, grads[1:]))
    return out


def _port_chain_grads(case, plain):
    """The gradients of the cell's parameters, enc, the context, z0 and h0 through ``RSSMCell.run`` (the hoisted
    products and ``RSSMChainFunction``), or with ``plain`` autograd of K10's forward twin."""
    cell, _ = _cell(case)
    enc, ctx, z0, h0, eps, mask, g_out = _chain_inputs(case)
    absent = CHAIN_CASES[case][4]
    leaves = [torch.tensor(v, requires_grad=True) for v in (enc, ctx, z0, h0)]
    resets = torch.from_numpy(mask).bool() if mask.any() else None
    patch = mock.patch.object(rssm_ops, "rssm_chain", rssm_ops.rssm_chain_plain) if plain else mock.MagicMock()
    with patch:
        outs = cell.run(*leaves, torch.from_numpy(eps), resets)
    loss = sum((getattr(outs, k) * torch.from_numpy(g)).sum() for i, (k, g) in enumerate(zip(OUTPUTS, g_out))
               if i not in absent)
    names = [name.replace(".", "/") for name, _ in cell.named_parameters()]
    grads = torch.autograd.grad(loss, [*cell.parameters(), *leaves], allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, [*cell.parameters(), *leaves])]
    return names, grads


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_rssm_chain_function_gradients_match_autograd_and_jax(jax_chain_grads, case):
    """``RSSMCell.run`` with gradients runs the hoisted products and ``RSSMChainFunction`` on the CPU (K10's save
    twin, ``rssm_chain_backward_plain``, ``chain_weight_grads``): the gradients of the cell's 22 parameters, enc,
    the context, z0 and h0 against autograd of K10's forward twin and ``jax.grad`` of the JAX cell's scan, float64,
    rtol 1e-7 with as much of each tensor's largest value as absolute slack. The cases take the precision-weighted
    and the residual posterior, a level with and without context, a reset every 4th step (no gradient crosses it)
    and output gradients that are absent (None in the backward)."""
    names, got = _port_chain_grads(case, plain=False)
    _, twin = _port_chain_grads(case, plain=True)
    gp, genc, gctx, gz0, gh0 = jax_chain_grads[case]
    labels = names + ["enc", "context", "z0", "h0"]
    refs = [gp[n] for n in names] + [genc, gctx, gz0, gh0]
    for label, a, b, r in zip(labels, got, twin, refs):
        scale = RTOL * np.abs(r).max() if r.size else 0.0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=scale, err_msg=f"{label} vs autograd")
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=scale, err_msg=f"{label} vs jax.grad")
    if CHAIN_CASES[case][3]:  # a reset at step 0: nothing reaches the initial state
        assert not got[-2].abs().any() and not got[-1].abs().any()


def _block_inputs(case, seed=11):
    """u (B, N, C), the chain's six parameters and the output gradient, numpy float64; with an all-padding row,
    row 1 of u is constant along time (as x = 0 expands to the 1x1's bias) and gets no output gradient."""
    stride, dilation, transposed, padding_row = BLOCK_CASES[case]
    rng = np.random.default_rng(seed)
    u = rng.normal(scale=1.5, size=(B, N, C)) + 0.3
    if padding_row:
        u[1] = rng.normal(size=C)
    p = dict(scale1=1 + 0.2 * rng.normal(size=C), bias1=0.2 * rng.normal(size=C),
             kernel=rng.normal(scale=0.4, size=(K, 1, C)), depthwise_bias=0.2 * rng.normal(size=C),
             scale2=1 + 0.2 * rng.normal(size=C), bias2=0.2 * rng.normal(size=C))
    n_out = depthwise_ops.output_length(N, K, stride, dilation, transposed)
    dz = rng.normal(size=(B, n_out, C))
    if padding_row:
        dz[1] = 0.0
    return u, p, dz


def _jax_chain(u, p, stride, dilation, transposed):
    """K11's function from the JAX pieces (``conv_coders.py:121-134`` and ``:70-88`` between the 1x1s)."""
    gn = lambda x, s, b: fnn.GroupNorm(num_groups=x.shape[-1], epsilon=1e-5).apply(  # noqa: E731
        {"params": {"scale": s, "bias": b}}, x)
    g = gn(jax.nn.relu(u), p["scale1"], p["bias1"])
    if transposed:
        v = jax_conv.depthwise_conv_transpose1d(g, p["kernel"], stride=stride, padding=0, dilation=dilation)
    else:
        v = jax_conv.depthwise_conv1d(g, p["kernel"], stride=stride, dilation=dilation)
    return gn(jax.nn.relu(v + p["depthwise_bias"]), p["scale2"], p["bias2"])


@pytest.fixture(scope="module")
def jax_block_grads():
    """``jax.grad`` of ``sum(chain(u) * dz)`` by u and the six parameters, float64: one compile a geometry."""
    out, compiled = {}, {}
    with jax.enable_x64(True):
        for case, (stride, dilation, transposed, _) in BLOCK_CASES.items():
            key = (stride, dilation, transposed)
            if key not in compiled:
                compiled[key] = jax.jit(jax.grad(
                    lambda u, p, dz, k=key: (_jax_chain(u, p, *k) * dz).sum(), argnums=(0, 1)))
            u, p, dz = _block_inputs(case)
            gu, gp = compiled[key](u, p, dz)
            out[case] = (np.asarray(gu), {k: np.asarray(v) for k, v in gp.items()})
    return out


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_depthwise_norm_function_gradients_match_autograd_and_jax(jax_block_grads, case):
    """``depthwise_norm`` with gradients runs ``DepthwiseNormFunction`` on the CPU (K11's save twin and
    ``depthwise_norm_backward_plain``): the gradients of u and the six parameters against autograd of K11's forward
    twin and ``jax.grad`` of the JAX block's chain (flax's GroupNorms, the JAX depthwise convs), float64, rtol 1e-7
    with as much of each tensor's largest value as absolute slack; the encoder at stride 4 and dilated, the decoder
    transposed at stride 4, and a batch with an all-padding row, whose u gets a gradient of exactly 0."""
    stride, dilation, transposed, padding_row = BLOCK_CASES[case]
    u, p, dz = _block_inputs(case)
    names = ("scale1", "bias1", "kernel", "depthwise_bias", "scale2", "bias2")
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)

    def grads(fn):
        leaves = [torch.tensor(u, requires_grad=True)] + [torch.tensor(p[n], requires_grad=True) for n in names]
        return torch.autograd.grad((fn(*leaves, **kw) * torch.from_numpy(dz)).sum(), leaves)

    got, twin = grads(depthwise_ops.depthwise_norm), grads(depthwise_ops.depthwise_norm_plain)
    gu, gp = jax_block_grads[case]
    for label, a, b, r in zip(("u",) + names, got, twin, [gu] + [gp[n] for n in names]):
        scale = RTOL * np.abs(r).max()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=scale, err_msg=f"{label} vs autograd")
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=scale, err_msg=f"{label} vs jax.grad")
    if padding_row:
        assert torch.isfinite(got[0]).all() and not got[0][1].abs().any()


class _StepLog(Tracker):
    """A tracker that also keeps each update's metric values."""

    def __init__(self):
        super().__init__()
        self.per_step = []

    def update(self, metrics, source):
        super().update(metrics, source)
        self.per_step.append((source, {m.name: m.value for m in metrics}))


def _train_args():
    return clockwork_audio.build_args("--hidden_size 8 --latent_size 4 --strides 16 --num_mix 2 --epochs 1 "
                                      "--beta_anneal_steps 4 --free_nats_steps 2 --free_nats_start_value 2 "
                                      "--seed 0".split())


def test_driver_train_steps_the_annealers():
    """``clockwork_audio.train`` at a small width: beta (cosine from 0) and free nats (2, held, then annealed to 0)
    stepped once a train step and handed to the forward as float32 scalars, the forward at the train loss's
    ``pad_strideable=True`` (``experiment_clockwork_audio.py:79-99``; the model's default), logged under ``train`` as
    JAX's ``CosineAnnealer`` gives them; the parameters stay finite."""
    args = _train_args()
    model = clockwork_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    calls, forward = [], model.forward

    def recorded(*a, **kwargs):
        calls.append(kwargs)
        return forward(*a, **kwargs)

    model.forward = recorded
    rng = np.random.default_rng(1)
    utterances = [(i, rng.uniform(-0.5, 0.5, n).astype(np.float32)) for i, n in enumerate((640, 500) * 3)]
    log = _StepLog()
    state = clockwork_audio.train(model, args, [utterances[i: i + 2] for i in (0, 2, 4)], log, device="cpu")
    beta = JaxCosineAnnealer(anneal_steps=4, start_value=0.0, end_value=1.0)
    free_nats = JaxCosineAnnealer(anneal_steps=1, constant_steps=1, start_value=2.0, end_value=0.0)
    expected = [(np.float32(beta.step()), np.float32(free_nats.step())) for _ in range(3)]
    assert inspect.signature(CWVAEAudio.forward).parameters["pad_strideable"].default is True
    assert state.step == 3 and len(calls) == 3 and [s for s, _ in log.per_step] == ["train"] * 3
    assert expected[0] == (0.0, 2.0) and 0.0 < expected[1][0] < 1.0 and expected[1][1] == 0.0
    for (b, f), call, (_, values) in zip(expected, calls, log.per_step):
        assert call.get("pad_strideable", True) is True and call["beta"].dtype == torch.float32
        assert float(call["beta"]) == b and float(call["free_nats"]) == f
        assert values["beta"] == b and values["free_nats"] == f and np.isfinite(values["loss"])
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_driver_train_runs_on_the_card_unless_asked(monkeypatch):
    """``clockwork_audio.train`` without a device means the card: where there is none it raises, never training on
    the CPU silently."""
    args = _train_args()
    model = clockwork_audio.build_model(args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clockwork_audio.train(model, args, [[(0, np.zeros(640, np.float32))] * 2], Tracker())
