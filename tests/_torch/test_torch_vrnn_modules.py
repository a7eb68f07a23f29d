"""The VRNN slice's building blocks against the JAX package, on the CPU: the Gaussian
log-likelihood, both KLs and free nats, the diagonal Gaussian head, the GRU cell, and
K8's plain twin (``ops/vrnn.py``) against the JAX ``VRNNCell`` stepped over T' steps in
inference and in prior mode with the same noise. Inputs and weights come from numpy
seeds; each JAX reference compiles once, in a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.models.vrnn import VRNNCell as JaxVRNNCell
from blvm_tpu.modules.distributions import DiagonalGaussianDense as JaxGaussianHead
from blvm_tpu.modules.recurrent import GRUCell as JaxGRUCell
from blvm_tpu.ops import likelihoods as jax_likelihoods
from blvm_tpu.ops import variational as jax_variational
from blvm_tpu_torch import weights
from blvm_tpu_torch.models.vrnn import VRNNCell
from blvm_tpu_torch.modules.distributions import DiagonalGaussianDense, get_likelihood_head
from blvm_tpu_torch.modules.recurrent import GRUCell
from blvm_tpu_torch.ops import likelihoods, variational
from blvm_tpu_torch.ops.vrnn import vrnn_cell, vrnn_cell_plain

B, T, X, H, Z, R = 3, 12, 16, 16, 4, 32
# f32 throughout: the same ops in the same order, only the products' summation order (and the
# hoisted x parts of two products) differ, over 12 steps of a chain that does not amplify them
TOL = dict(atol=1e-5, rtol=1e-5)
# name: (inference, residual_posterior, condition_h_on_x, use_mode)
CELL_CASES = {
    "inference_residual": (True, True, True, False),
    "inference_plain_posterior": (True, False, True, False),
    "inference_h_not_on_x": (True, True, False, False),
    "inference_h_not_on_x_plain_posterior": (True, False, False, False),
    "prior_sampled": (False, True, True, False),
    "prior_mode": (False, True, True, True),
    "prior_sampled_h_not_on_x": (False, False, False, False),
}


def _gaussians(seed=0, shape=(B, T, Z)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32),
            rng.uniform(0.05, 2.0, shape).astype(np.float32), rng.normal(size=shape).astype(np.float32),
            rng.uniform(0.05, 2.0, shape).astype(np.float32))


GAUSSIAN_LL_CASES = [(epsilon, reduce_dim) for epsilon in (0.0, 0.5) for reduce_dim in (None, -1)]


@pytest.fixture(scope="module")
def jax_gaussian_ll():
    """``(value, gradient by sd)`` of JAX's ``gaussian_ll`` in every case, one compile."""
    y, mu, sd, _, _ = _gaussians()

    def value_and_grad(eps, dim):
        return (jax.value_and_grad(lambda s: jax_likelihoods.gaussian_ll(y, mu, s, epsilon=eps, reduce_dim=dim).sum())(sd),
                jax_likelihoods.gaussian_ll(y, mu, sd, epsilon=eps, reduce_dim=dim))

    out = jax.jit(lambda: [value_and_grad(*case) for case in GAUSSIAN_LL_CASES])()
    return {case: (np.asarray(v), np.asarray(g)) for case, ((_, g), v) in zip(GAUSSIAN_LL_CASES, out)}


@pytest.mark.parametrize("epsilon,reduce_dim", GAUSSIAN_LL_CASES)
def test_gaussian_ll_matches_jax(jax_gaussian_ll, epsilon, reduce_dim):
    """Values, and the gradient by ``sd`` through the straight-through clamp (half the
    scales lie below ``epsilon = 0.5``), against ``jax.grad``."""
    y, mu, sd, _, _ = _gaussians()
    ref, ref_grad = jax_gaussian_ll[(epsilon, reduce_dim)]
    sd_t = torch.from_numpy(sd).requires_grad_(True)
    got = likelihoods.gaussian_ll(torch.from_numpy(y), torch.from_numpy(mu), sd_t, epsilon=epsilon, reduce_dim=reduce_dim)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    got.sum().backward()
    np.testing.assert_allclose(sd_t.grad.numpy(), ref_grad, atol=1e-4, rtol=1e-5)


def test_kl_divergences_and_free_nats_match_jax():
    """The analytic and the single-sample KL, and ``discount_free_nats`` with the budget
    shared over the latent dim (``free_nats / Z`` an element), unshared, and zero."""
    z, mu_q, sd_q, mu_p, sd_p = _gaussians(1)
    args = [torch.from_numpy(a) for a in (mu_q, sd_q, mu_p, sd_p)]
    kl = variational.kl_divergence_gaussian(*args)
    np.testing.assert_allclose(kl.numpy(), np.asarray(jax_variational.kl_divergence_gaussian(mu_q, sd_q, mu_p, sd_p)),
                               **TOL)
    np.testing.assert_allclose(
        variational.kl_divergence_gaussian_mc(*args, torch.from_numpy(z)).numpy(),
        np.asarray(jax_variational.kl_divergence_gaussian_mc(mu_q, sd_q, mu_p, sd_p, z)), **TOL)
    for free_nats, shared in ((2.0, -1), (0.3, None), (0.0, -1)):
        ref = jax_variational.discount_free_nats(np.asarray(kl), free_nats, shared_dims=shared)
        np.testing.assert_array_equal(variational.discount_free_nats(kl, free_nats, shared_dims=shared).numpy(),
                                      np.asarray(ref))
    assert (variational.discount_free_nats(kl, 2.0, shared_dims=-1) >= 2.0 / Z).all()


def test_diagonal_gaussian_head_matches_jax():
    """``mu`` and the softplus-calibrated ``sd`` (``sd(0) = initial_sd``), ``log_prob`` and the
    head's name in :func:`get_likelihood_head`."""
    head = DiagonalGaussianDense(H, Z)
    params = weights.random_jax_params(head, seed=2)
    weights.load_jax_params(head, params)
    x = np.random.default_rng(3).normal(scale=2.0, size=(B, T, H)).astype(np.float32)
    jhead = JaxGaussianHead(y_dim=Z)
    ref_mu, ref_sd = jhead.apply({"params": weights.unflatten(params)}, x)
    with torch.no_grad():
        mu, sd = head(torch.from_numpy(x))
        y = torch.from_numpy(np.array(ref_mu)) + 0.5
        lp = head.log_prob(y, (mu, sd), reduce_dim=-1)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), **TOL)
    np.testing.assert_allclose(sd.numpy(), np.asarray(ref_sd), **TOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jhead.log_prob(y.numpy(), (ref_mu, ref_sd), reduce_dim=-1)), **TOL)
    with torch.no_grad():
        head.Dense_0.kernel.zero_()
        head.Dense_0.bias.zero_()
        np.testing.assert_allclose(head(torch.zeros(1, H))[1].numpy(), 1.0, rtol=1e-6)
    assert isinstance(get_likelihood_head("Gaussian", H, y_dim=Z), DiagonalGaussianDense)


def test_gru_cell_matches_jax_with_gradients():
    """One step's output and the gradients by ``x`` and ``h`` against ``jax.grad``; the port's
    own init makes ``w_hh`` orthogonal under ``orthogonal_hh``."""
    cell = GRUCell(X, R, orthogonal_hh=True)
    w_hh = cell.w_hh.detach()
    np.testing.assert_allclose((w_hh @ w_hh.T).numpy(), np.eye(R), atol=1e-5)
    params = weights.random_jax_params(cell, seed=4)
    weights.load_jax_params(cell, params)
    rng = np.random.default_rng(5)
    x, h = rng.normal(size=(B, X)).astype(np.float32), rng.normal(scale=0.5, size=(B, R)).astype(np.float32)
    w_out = rng.normal(size=(B, R)).astype(np.float32)
    jcell = JaxGRUCell(hidden_size=R, orthogonal_hh=True)
    tree = weights.unflatten(params)
    ref, (gx, gh) = jax.jit(jax.value_and_grad(lambda x_, h_: (jcell.apply({"params": tree}, x_, h_) * w_out).sum(),
                                               argnums=(0, 1)))(x, h)
    xt, ht = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(h).requires_grad_(True)
    out = (cell(xt, ht) * torch.from_numpy(w_out)).sum()
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **TOL)


def _cell(condition_h_on_x, residual_posterior=True):
    cell = VRNNCell(X, H, Z, R, condition_h_on_x=condition_h_on_x, residual_posterior=residual_posterior)
    params = weights.random_jax_params(cell, seed=6 + condition_h_on_x)
    weights.load_jax_params(cell, params)
    return cell, params


def _cell_inputs(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, X)).astype(np.float32), rng.normal(scale=0.5, size=(B, R)).astype(np.float32),
            rng.normal(size=(B, T, Z)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_cell_runs():
    """Every cell case through the JAX ``VRNNCell``'s own pieces (``prior_params``,
    ``posterior_params``, ``phi_z_features``, ``gru_step``, as ``__call__`` and
    ``generate_step`` chain them) under ``jax.lax.scan``, with the noise given: one compile
    per ``condition_h_on_x``, the mode flags passed as data."""
    x, h0, eps = _cell_inputs()
    runs = {}
    for cond in (True, False):
        _, params = _cell(cond)
        jcell = JaxVRNNCell(x_dim=X, h_dim=H, z_dim=Z, r_dim=R, condition_h_on_x=cond)
        tree = {"params": weights.unflatten(params)}

        def piece(method, *a):
            return jcell.apply(tree, *a, method=method)

        @jax.jit
        def scan(inference, residual, use_mode):
            def step(h, inputs):
                x_t, e_t = inputs
                p_mu, p_sd = piece(JaxVRNNCell.prior_params, h)
                q_mu, q_sd = piece(JaxVRNNCell.posterior_params, h, x_t)
                q_mu = jnp.where(residual, q_mu + p_mu, q_mu)
                z_prior = jnp.where(use_mode, p_mu, p_mu + p_sd * e_t)
                z = jnp.where(inference, q_mu + q_sd * e_t, z_prior)
                phi = piece(JaxVRNNCell.phi_z_features, z)
                h = piece(JaxVRNNCell.gru_step, jnp.concatenate([x_t, phi], -1) if cond else phi, h)
                return h, (h, z, phi, q_mu, q_sd, p_mu, p_sd)

            _, outs = jax.lax.scan(step, h0, (jnp.swapaxes(x, 0, 1), jnp.swapaxes(eps, 0, 1)))
            return [jnp.swapaxes(o, 0, 1) for o in outs]

        for name, (inference, residual, c, use_mode) in CELL_CASES.items():
            if c == cond:
                runs[name] = [np.asarray(o) for o in scan(inference, residual, use_mode)]
    return runs


@pytest.mark.parametrize("case", list(CELL_CASES))
def test_vrnn_cell_twin_matches_jax_cell(jax_cell_runs, case):
    """K8's twin over T' = 12 steps against the JAX cell fed the same noise: the states, z, phi
    and, in inference mode, both heads' mu and sd; the entry point on CPU tensors is the twin."""
    inference, residual, cond, use_mode = CELL_CASES[case]
    cell, _ = _cell(cond, residual_posterior=residual)
    x, h0, eps = (torch.from_numpy(a) for a in _cell_inputs())
    kwargs = dict(inference=inference, residual_posterior=residual, condition_h_on_x=cond, use_mode=use_mode,
                  sd_beta=cell.prior_head.beta, sd_epsilon=cell.prior_head.epsilon)
    with torch.no_grad():
        got = vrnn_cell_plain(cell.cell_weights(), x, h0, None if use_mode else eps, **kwargs)
        again = vrnn_cell(cell.cell_weights(), x, h0, None if use_mode else eps, **kwargs)
    ref = dict(zip(got._fields, jax_cell_runs[case]))
    for name, value in got._asdict().items():
        if value is None:
            assert not inference and name.startswith("enc_")
            continue
        assert value.shape[:2] == (B, T)
        np.testing.assert_allclose(value.numpy(), ref[name], err_msg=name, **TOL)
        assert torch.equal(getattr(again, name), value)


def test_generate_step_is_one_prior_step():
    """``VRNNCell.generate_step`` (the prior-only step of a generation) against the JAX
    ``generate_step`` at the mode, from the same state and input."""
    cell, params = _cell(True)
    x, h0, _ = _cell_inputs(8)
    jcell = JaxVRNNCell(x_dim=X, h_dim=H, z_dim=Z, r_dim=R)
    ref_h, ref = jax.jit(lambda p_, h_, x_: jcell.apply({"params": p_}, h_, x_, None, use_mode=True,
                                                        method=JaxVRNNCell.generate_step))(
        weights.unflatten(params), h0, x[:, 0])
    with torch.no_grad():
        h, out = cell.generate_step(torch.from_numpy(h0), torch.from_numpy(x[:, 0]), None, use_mode=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    for name in ("z", "phi_z"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), err_msg=name, **TOL)


def _piece_inputs(seed=9):
    """Each of the cell's pieces with its arguments (numpy): ``prior_params(h)``,
    ``posterior_params(h, x)``, ``phi_z_features(z)``, ``gru_step([x, phi], h)``."""
    x, h, z = (a[:, 0] if a.ndim == 3 else a for a in _cell_inputs(seed))
    phi = np.random.default_rng(seed).normal(size=(B, H)).astype(np.float32)
    return {"prior_params": (h,), "posterior_params": (h, x), "phi_z_features": (z,),
            "gru_step": (np.concatenate([x, phi], -1), h)}


@pytest.fixture(scope="module")
def jax_cell_pieces():
    """The JAX ``VRNNCell``'s four pieces on one step's inputs, one compile."""
    _, params = _cell(True)
    jcell = JaxVRNNCell(x_dim=X, h_dim=H, z_dim=Z, r_dim=R)
    pieces = _piece_inputs()
    out = jax.jit(lambda tree: {name: jcell.apply(tree, *args, method=getattr(JaxVRNNCell, name))
                                for name, args in pieces.items()})({"params": weights.unflatten(params)})
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("name", ["prior_params", "posterior_params", "phi_z_features", "gru_step"])
def test_vrnn_cell_pieces_match_jax(jax_cell_pieces, name):
    """The port's ``VRNNCell`` pieces, the modules K8 and its twin take their weights from,
    against the JAX cell's methods of the same name on the same weights."""
    cell, _ = _cell(True)
    with torch.no_grad():
        got = getattr(cell, name)(*(torch.from_numpy(a) for a in _piece_inputs()[name]))
    ref = jax_cell_pieces[name]
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
