"""The SRNN slice's building blocks against the JAX package, on the CPU: the port's ``GRU``
(K7's plain twin on the CPU) against ``blvm_tpu.modules.recurrent.GRU`` under ragged, flipped
and zero-length masks and a given state; K9's plain twin (``ops/srnn.py``) against the JAX
``_SRNNStep`` stepped over T' steps in inference and in prior mode with the same noise; the
gated transfer and ``phi_z`` twin path against the JAX step; the wrappers' refusals on the
card (the unported fields, the prior mode under a gradient). Inputs and weights come from numpy seeds; each JAX reference compiles once, in a
module-scoped fixture."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.models.srnn as jax_srnn
from blvm_tpu.models.srnn import _SRNNStep as JaxSRNNStep
from blvm_tpu.modules.recurrent import GRU as JaxGRU
from blvm_tpu_torch import weights
from blvm_tpu_torch.models.srnn import _SRNNStep
from blvm_tpu_torch.modules.recurrent import GRU
from blvm_tpu_torch.ops import recurrent as recurrent_ops
from blvm_tpu_torch.ops import srnn as srnn_ops

B, T, D, R, H, Z = 4, 10, 8, 32, 16, 4
LENGTHS = np.asarray([10, 7, 3, 0])  # a zero-length row among them
# f32 throughout: the same ops in the same order, only the products' summation order (and, in the chain,
# the hoisted d and a parts of the first layers) differ, over 10 steps of chains that do not amplify them
TOL = dict(atol=1e-6, rtol=1e-5)
# name: (mask, a given initial state)
GRU_CASES = {
    "ragged_with_a_zero_length_row": ("ragged", False),
    "flipped_mask_given_state": ("flipped", True),
    "no_mask_given_state": ("none", True),
}
# name: (inference, residual_posterior, use_mode)
CHAIN_CASES = {
    "inference_residual": (True, True, False),
    "inference_plain_posterior": (True, False, False),
    "prior_sampled": (False, True, False),
    "prior_mode": (False, True, True),
}


def _mask(kind):
    mask = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32)
    return {"ragged": mask, "flipped": mask[:, ::-1].copy(), "none": np.ones_like(mask)}[kind]


def _gru_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, D)).astype(np.float32), rng.normal(scale=0.5, size=(B, R)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_gru():
    """Every GRU case through the JAX ``GRU``, one compile: ``(out, h_n)`` as numpy."""
    model = GRU(D, R)
    params = weights.random_jax_params(model, seed=1)
    fn = jax.jit(lambda p, x_, m_, h_: JaxGRU(hidden_size=R).apply({"params": p}, x_, mask=m_, initial_state=h_))
    x, h0 = _gru_inputs()
    out = {}
    for name, (kind, given) in GRU_CASES.items():
        out[name] = tuple(np.asarray(a) for a in fn(weights.unflatten(params), x, _mask(kind),
                                                    h0 if given else np.zeros_like(h0)))
    return params, out


@pytest.mark.parametrize("case", list(GRU_CASES))
def test_gru_matches_jax(jax_gru, case):
    """The port's GRU against JAX's: outputs (``h_new * m``, zero where the mask is) and the state
    frozen at each row's end; under the flipped mask the state holds the given one until the valid
    frames begin, and the zero-length row keeps it throughout."""
    params, ref = jax_gru
    kind, given = GRU_CASES[case]
    model = weights.load_jax_params(GRU(D, R), params)
    x, h0 = _gru_inputs()
    with torch.no_grad():
        out, h_n = model(torch.from_numpy(x), mask=None if kind == "none" else torch.from_numpy(_mask(kind)),
                         initial_state=torch.from_numpy(h0) if given else None)
    np.testing.assert_allclose(out.numpy(), ref[case][0], **TOL)
    np.testing.assert_allclose(h_n.numpy(), ref[case][1], **TOL)
    if kind != "none":
        np.testing.assert_array_equal(out.numpy()[3], 0.0)
        np.testing.assert_array_equal(h_n.numpy()[3], h0[3] if given else 0.0)


def test_gru_recurrence_twin_is_the_cpu_entry_point():
    """``gru_recurrence`` on CPU tensors is its twin, and a gradient flows through it there."""
    rng = np.random.default_rng(2)
    xw, w_hh = (torch.from_numpy(rng.normal(scale=0.3, size=s).astype(np.float32)) for s in ((2, 5, 12), (4, 12)))
    b_hh, h0 = torch.zeros(12), torch.zeros(2, 4)
    mask = torch.tensor([[1.0] * 5, [0, 0, 1, 1, 1]])
    a = recurrent_ops.gru_recurrence(xw, w_hh, b_hh, mask, h0)
    b = recurrent_ops.gru_recurrence_plain(xw, w_hh, b_hh, mask, h0)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    w_hh.requires_grad_(True)
    recurrent_ops.gru_recurrence(xw, w_hh, b_hh, mask, h0)[1].sum().backward()
    assert w_hh.grad is not None and torch.isfinite(w_hh.grad).all()


def _step(residual, use_phi_z=False, gated=False, seed=3):
    step = _SRNNStep(H, Z, R, use_phi_z=use_phi_z, gated_stochastic_transfer=gated, residual_posterior=residual)
    params = weights.random_jax_params(step, seed=seed)
    weights.load_jax_params(step, params)
    return step, params


def _chain_inputs(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(B, T, R)).astype(np.float32), rng.normal(scale=0.5, size=(B, T, R)).astype(np.float32),
            rng.normal(scale=0.5, size=(B, Z)).astype(np.float32), rng.normal(size=(B, T, Z)).astype(np.float32))


def _given_noise(holder):
    """The JAX step's ``rsample_gaussian`` made ``mu + sd * e_t``, ``e_t`` the noise of the step being
    traced (the scan body sets ``holder["eps"]`` before it calls the step)."""
    return mock.patch.object(jax_srnn, "rsample_gaussian", lambda key, mu, sd: mu + sd * holder["eps"])


def _jax_scan(step_kwargs, params, inference, use_mode, carry_gru=False):
    """The JAX ``_SRNNStep`` (``__call__`` in inference mode, ``prior_step`` in prior mode) over the
    T steps of the chain inputs with their noise, under ``jax.lax.scan``: one compile."""
    jstep = JaxSRNNStep(h_dim=H, z_dim=Z, r_dim=R, **step_kwargs)
    tree = {"params": weights.unflatten(params)}
    d, a, z0, eps = _chain_inputs()
    holder = {}

    def body(carry, inputs):
        d_t, a_t, e_t = inputs
        holder["eps"] = e_t
        key = jax.random.PRNGKey(0)
        if inference:
            carry, outs = jstep.apply(tree, carry, (d_t, a_t), rngs={"sample": key})
            return carry, outs
        z, d_in = carry
        z, _ = jstep.apply(tree, (z, d_in), d_t, key, use_mode=use_mode, method=JaxSRNNStep.prior_step)
        return (z, d_t), dict(z=z)

    zeros = jnp.zeros((B, R))
    carry0 = ((z0, zeros, zeros) if carry_gru else (z0,)) if inference else (z0, zeros)
    with _given_noise(holder):
        _, outs = jax.jit(lambda: jax.lax.scan(body, carry0, tuple(jnp.swapaxes(v, 0, 1) for v in (d, a, eps))))()
    return {k: np.asarray(jnp.swapaxes(v, 0, 1)) for k, v in outs.items()}


@pytest.fixture(scope="module")
def jax_chain_runs():
    """Every chain case through the JAX step, and the gated transfer with ``phi_z`` in inference mode."""
    runs = {}
    for name, (inference, residual, use_mode) in CHAIN_CASES.items():
        _, params = _step(residual)
        runs[name] = _jax_scan(dict(use_phi_z=False, gated_stochastic_transfer=False, residual_posterior=residual),
                               params, inference, use_mode)
    _, params = _step(True, use_phi_z=True, gated=True)
    runs["gated_phi_z"] = _jax_scan(dict(use_phi_z=True, gated_stochastic_transfer=True, residual_posterior=True),
                                    params, True, False, carry_gru=True)
    return runs


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_srnn_chain_twin_matches_jax_step(jax_chain_runs, case):
    """K9's twin over T' = 10 steps against the JAX step fed the same noise: z and, in inference
    mode, both heads' mu and sd; the entry point on CPU tensors is the twin, and the model's
    ``run`` builds ``h_p_n``, ``h_q_n`` as the last step's concatenations."""
    inference, residual, use_mode = CHAIN_CASES[case]
    step, _ = _step(residual)
    d, a, z0, eps = (torch.from_numpy(v) for v in _chain_inputs())
    head = step.prior_net.layers_1
    kw = dict(inference=inference, residual_posterior=residual, use_mode=use_mode, sd_beta=head.beta,
              sd_epsilon=head.epsilon)
    with torch.no_grad():
        xp, xq, kernel_weights = srnn_ops.hoist(step.chain_weights(), d, a, inference)
        got = srnn_ops.srnn_chain_plain(kernel_weights, xp, xq, z0, None if use_mode else eps, **kw)
        again = srnn_ops.srnn_chain(kernel_weights, xp, xq, z0, None if use_mode else eps, **kw)
        outs, h_p_n, h_q_n = step.run(d, a if inference else None, z0, None if use_mode else eps, inference=inference,
                                      use_mode=use_mode)
    ref = jax_chain_runs[case]
    for name, value in got._asdict().items():
        assert torch.equal(getattr(again, name), value) if value is not None else getattr(again, name) is None
        assert torch.equal(getattr(outs, name), value) if value is not None else getattr(outs, name) is None
        if name in ref:
            np.testing.assert_allclose(value.numpy(), ref[name], err_msg=name, **TOL)
        elif value is None:
            assert not inference and name.startswith("enc_")
    if inference:
        np.testing.assert_allclose(h_p_n.numpy(), ref["h_p"][:, -1], **TOL)
        np.testing.assert_allclose(h_q_n.numpy(), ref["h_q"][:, -1], **TOL)


def test_gated_transfer_and_phi_z_twin_path_matches_jax_step(jax_chain_runs):
    """The fields ``SRNNAudio`` never sets, on the CPU: the step's plain loop with ``phi_z`` and
    the gated transfer against the JAX step, and the transfer GRU's final states."""
    step, _ = _step(True, use_phi_z=True, gated=True)
    d, a, z0, eps = (torch.from_numpy(v) for v in _chain_inputs())
    with torch.no_grad():
        outs, h_p_n, h_q_n = step.run(d, a, z0, eps)
    ref = jax_chain_runs["gated_phi_z"]
    for name, value in outs._asdict().items():
        np.testing.assert_allclose(value.numpy(), ref[name], err_msg=name, **TOL)
    np.testing.assert_allclose(h_p_n.numpy(), ref["h_p"][:, -1], **TOL)
    np.testing.assert_allclose(h_q_n.numpy(), ref["h_q"][:, -1], **TOL)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrappers' refusals before any launch."""

    @property
    def is_cuda(self):
        return True


def test_card_paths_refuse_gradients_and_the_unported_fields():
    """On the card the gated transfer and ``phi_z`` have no kernel, and K9-bwd runs the inference
    mode only: each raises ``NotImplementedError`` before a launch, never running a twin (the prior
    mode under a gradient, since no driver differentiates a generation)."""
    step, _ = _step(True)
    d, a, z0, eps = (torch.from_numpy(v).as_subclass(_OnTheCard) for v in _chain_inputs())
    head = step.prior_net.layers_1
    xp, _, kernel_weights = srnn_ops.hoist(step.chain_weights(), d, None, False)
    assert xp.requires_grad and xp.is_cuda
    with pytest.raises(NotImplementedError, match="inference mode only"):
        srnn_ops.srnn_chain(kernel_weights, xp, None, z0, eps, inference=False, residual_posterior=True,
                            sd_beta=head.beta, sd_epsilon=head.epsilon)
    with pytest.raises(NotImplementedError, match="inference mode only"):
        step.prior_step(z0, d[:, 0], d[:, 1], eps[:, 0])
    for fields in (dict(use_phi_z=True), dict(gated=True)):
        unported, _ = _step(True, **fields)
        with torch.no_grad(), pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            unported.run(d, a, z0, eps)
