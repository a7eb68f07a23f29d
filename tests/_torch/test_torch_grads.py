"""Gradients of the port's plain twins against ``jax.grad`` of the JAX package.

On the CPU the wrappers of K1 and K2 are their plain twins, so autograd of the
twins is the gradient the CPU path trains with, and the gradient the backward
kernels are held to on the card (``chip_smoke.py``, ``test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.models import WaveNet as JaxWaveNet
from blvm_tpu.models.wavenet.modules import Conv1dResidualGLU as JaxGLU
from blvm_tpu.ops.likelihoods import discretized_logistic_mixture_ll as jax_dmol_ll
from blvm_tpu_torch import weights
from blvm_tpu_torch.models import WaveNet
from blvm_tpu_torch.models.wavenet.modules import Conv1dResidualGLU
from blvm_tpu_torch.ops.likelihoods import discretized_logistic_mixture_ll
from tests._torch.helpers import np32


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dilation,need_skip", [(1, True), (4, True), (1, False), (4, False)],
                         ids=["1", "4", "1-skip_free", "4-skip_free"])
def test_residual_glu_block_gradients_match_jax(dilation, need_skip, bf16):
    """Gradients of sum(o * dO) + sum(s * dS) by x and by the six f32 parameters, with the
    skip and skip-free (``need_skip=False``, STCN's dead blocks: only sum(o * dO), and the
    skip columns of rs_kernel and rs_bias get JAX's zero gradient of its column slice).
    f32: summation order only (1e-5 relative to each gradient's norm). bf16: both
    round after every op in bf16, forward and backward; the parameter gradients
    are sums over all rows of products rounded at 2^-8 relative, so their
    relative-norm distance stays within a few such roundings (3e-2)."""
    C, B, T_in, skip_size = 8, 2, 24, 12
    dtype = torch.bfloat16 if bf16 else None
    module = Conv1dResidualGLU(C, dilation=dilation, dtype=dtype, need_skip=need_skip)
    params = weights.random_jax_params(module, seed=dilation)
    weights.load_jax_params(module, params)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T_in, C)).astype(np.float32)
    d_o = rng.normal(size=(B, T_in - dilation, C)).astype(np.float32)
    d_s = rng.normal(size=(B, skip_size, C)).astype(np.float32)

    jmod = JaxGLU(res_channels=C, dilation=dilation, dtype=jnp.bfloat16 if bf16 else None, need_skip=need_skip)

    def objective(p, x_):
        o, s = jmod.apply({"params": p}, x_, skip_size)
        return jnp.sum(o.astype(jnp.float32) * d_o) + (jnp.sum(s.astype(jnp.float32) * d_s) if need_skip else 0.0)

    jgrad_p, jgrad_x = jax.jit(jax.grad(objective, argnums=(0, 1)))(weights.unflatten(params), jnp.asarray(x))
    jgrads = weights.flatten(jgrad_p)

    xt = torch.from_numpy(x).requires_grad_(True)
    o, s = module(xt, skip_size)
    assert (s is None) == (not need_skip)
    objective_t = torch.sum(o.float() * torch.from_numpy(d_o))
    (objective_t + (torch.sum(s.float() * torch.from_numpy(d_s)) if need_skip else 0.0)).backward()

    tol = 3e-2 if bf16 else 1e-5
    assert _rel_norm(np32(xt.grad), jgrad_x) <= tol
    for name, p in module.named_parameters():
        assert p.grad.dtype == torch.float32
        assert _rel_norm(np32(p.grad), jgrads[name]) <= tol, name
    if not need_skip:  # the skip columns: zero on both sides
        assert not np.any(jgrads["rs_kernel"][..., C:]) and not np.any(np32(module.rs_kernel.grad)[..., C:])
        assert not np.any(jgrads["rs_bias"][C:]) and not np.any(np32(module.rs_bias.grad)[C:])


def test_dmol_gradients_match_jax_at_the_edges_of_the_ladder():
    """Gradients by logits, locs and log-scales of a weighted sum of per-frame
    log-masses, with frames in the lowest and the highest bin and components of
    tiny scale far from their target (the midpoint branch). In float64 on both
    sides: the point is the algebra of the ladder, and f64 leaves no room (1e-9)."""
    N, M, num_bins = 600, 5, 256
    rng = np.random.default_rng(3)
    y = rng.uniform(-1, 1, (N, 1))
    y[:100], y[100:200] = -1.0, 1.0
    logits = rng.normal(size=(N, M))
    locs = rng.uniform(-1, 1, (N, 1, M))
    log_scales = rng.uniform(-5, 0, (N, 1, M))
    log_scales[200:300] = -7.0
    g = rng.uniform(0.5, 1.5, N)

    with jax.enable_x64(True):
        jgrads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jax_dmol_ll(jnp.asarray(y), a, b, c, num_bins=num_bins) * g),
                                  argnums=(0, 1, 2)))(jnp.asarray(logits), jnp.asarray(locs), jnp.asarray(log_scales))
        jgrads = [np.asarray(t) for t in jgrads]
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in (logits, locs, log_scales)]
    lp = discretized_logistic_mixture_ll(torch.from_numpy(y), *inputs, num_bins=num_bins)
    (lp * torch.from_numpy(g)).sum().backward()
    for t, ref in zip(inputs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-9, atol=1e-9)
    # the edges took part: every branch of the ladder has a nonzero gradient somewhere
    assert np.abs(jgrads[1][:100]).max() > 0 and np.abs(jgrads[1][100:200]).max() > 0
    assert np.abs(jgrads[2][200:300]).max() > 0


def test_wavenet_parameter_gradients_match_jax():
    """Every parameter's gradient of the loss of a small WaveNet, in float64 on
    both sides (rtol 1e-7: only summation order differs)."""
    config = dict(n_layers=3, n_stacks=2, res_channels=8, num_mix=3, num_bins=256)
    model = WaveNet(**config).double()
    params = weights.random_jax_params(model, 4)
    weights.load_jax_params(model, params)
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 60))
    x[1, 41:] = 0.0
    x_sl = np.asarray([60, 41])

    jmodel = JaxWaveNet(**config)
    with jax.enable_x64(True):
        def loss_of(p):
            return jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(x_sl), rngs={"sample": jax.random.PRNGKey(0)})[0]

        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights.unflatten(params))
        jgrads = weights.flatten(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_of))(jparams)))

    loss, _, _ = model(torch.from_numpy(x), torch.from_numpy(x_sl), generator=torch.Generator().manual_seed(0))
    loss.backward()
    grads = {name.replace(".", "/"): p.grad.numpy() for name, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name in grads:
        np.testing.assert_allclose(grads[name], jgrads[name], rtol=1e-7, atol=1e-12, err_msg=name)
