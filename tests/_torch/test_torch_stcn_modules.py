"""STCN's modules in the port against the JAX package, on the CPU: the skip-free residual-GLU
block, ``ResidualStack(skip_mask=...)`` with and without ``collect_tails``,
``DiagonalGaussianDenseSTCN`` and ``precision_weighted_gaussian``. Inputs and weights come from
numpy seeds; each JAX reference is jitted once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.models.stcn.stcn import DiagonalGaussianDenseSTCN as JaxHead
from blvm_tpu.models.wavenet.modules import Conv1dResidualGLU as JaxGLU
from blvm_tpu.models.wavenet.modules import ResidualStack as JaxStack
from blvm_tpu.ops.variational import precision_weighted_gaussian as jax_pwg
from blvm_tpu_torch import weights
from blvm_tpu_torch.models.stcn import DiagonalGaussianDenseSTCN
from blvm_tpu_torch.models.wavenet.modules import Conv1dResidualGLU, ResidualStack, residual_glu, residual_glu_plain
from blvm_tpu_torch.ops.variational import precision_weighted_gaussian

C, B, T = 8, 2, 40


def _load(module, seed):
    params = weights.random_jax_params(module, seed)
    weights.load_jax_params(module, params)
    return weights.unflatten(params)


@pytest.mark.parametrize("dilation", [1, 4])
def test_skip_free_block_matches_jax(dilation):
    """``need_skip=False``: only the residual columns of ``rs_kernel`` are contracted and the skip is
    None, as in JAX; the same block with its skip gives the same ``o`` (f32, 1e-6)."""
    module = Conv1dResidualGLU(C, dilation=dilation, need_skip=False)
    params = _load(module, 1)
    x = np.random.default_rng(2).normal(size=(B, T, C)).astype(np.float32)
    o_j, s_j = JaxGLU(res_channels=C, dilation=dilation, need_skip=False).apply({"params": params}, jnp.asarray(x), 7)
    with torch.no_grad():
        o, s = module(torch.from_numpy(x), 7)
        o_skip, s_skip = module(torch.from_numpy(x), 7, need_skip=True)
    assert s is None and s_j is None and s_skip.shape == (B, 7, C)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(o_skip.numpy(), o.numpy(), atol=1e-6, rtol=1e-6)


def test_residual_glu_wrapper_skip_free_on_cpu_is_the_twin():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, 30, C, generator=g)
    args = (torch.randn(2, C, C, generator=g), torch.randn(2, C, C, generator=g), torch.randn(C, generator=g),
            torch.randn(C, generator=g), torch.randn(1, C, 2 * C, generator=g), torch.randn(2 * C, generator=g))
    o, s = residual_glu(x, *args, dilation=3, skip_size=0, need_skip=False)
    o_ref, s_ref = residual_glu_plain(x, *args, dilation=3, skip_size=0, need_skip=False)
    assert s is None and s_ref is None and torch.equal(o, o_ref)


@pytest.fixture(scope="module")
def stack_case():
    """A 2 x 3-block stack (dilations 1, 2, 4 twice) with STCN's mask (every third skip used), the
    JAX stack's outputs with and without ``collect_tails``."""
    stack = ResidualStack(n_layers=3, n_stacks=2, res_channels=C, base_dilation=2)
    params = _load(stack, 4)
    x = np.random.default_rng(5).normal(size=(B, T, C)).astype(np.float32)
    mask = [False, False, True, False, False, True]
    jstack = JaxStack(n_layers=3, n_stacks=2, res_channels=C, base_dilation=2)
    skips_j, tails_j = jax.jit(lambda p, x_: jstack.apply({"params": p}, x_, 9, collect_tails=True, skip_mask=mask))(
        params, jnp.asarray(x))
    return stack, x, mask, skips_j, tails_j


def test_masked_residual_stack_matches_jax(stack_case):
    """The masked blocks give None where JAX does, the used ones their skips, and ``collect_tails``
    each block's last ``dilation`` input frames (f32, 1e-5)."""
    stack, x, mask, skips_j, tails_j = stack_case
    with torch.no_grad():
        skips, tails = stack(torch.from_numpy(x), 9, collect_tails=True, skip_mask=mask)
        plain = stack(torch.from_numpy(x), 9, skip_mask=mask)
    assert [s is None for s in skips] == [s is None for s in skips_j] == [not m for m in mask]
    for got, ref, again in zip(skips, skips_j, plain):
        if ref is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
            assert torch.equal(got, again)
    assert [tuple(t.shape) for t in tails] == [(B, d, C) for d in (1, 2, 4, 1, 2, 4)]
    for got, ref in zip(tails, tails_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("init_sd_mean", [0.5, 0.1])
def test_stcn_gaussian_head_matches_jax(init_sd_mean):
    """Two 3-layer LeakyReLU MLPs; ``sd`` through ``softplus_beta`` with ``log 2 / (init_sd_mean - 1e-3)``
    plus 1e-3 (``stcn.py:50-72``), inputs around 0 so both LeakyReLU branches are taken (f32, 1e-6)."""
    head = DiagonalGaussianDenseSTCN(12, 4, 16, init_sd_mean=init_sd_mean)
    params = _load(head, 6)
    x = np.random.default_rng(7).normal(size=(B, 5, 12)).astype(np.float32)
    mu_j, sd_j = JaxHead(out_channels=4, hidden_channels=16, init_sd_mean=init_sd_mean).apply({"params": params},
                                                                                               jnp.asarray(x))
    with torch.no_grad():
        mu, sd = head(torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_j), atol=1e-6, rtol=1e-6)
    assert (sd > 1e-3).all()


def test_precision_weighted_gaussian_matches_jax():
    rng = np.random.default_rng(8)
    mu_1, mu_2 = rng.normal(size=(2, 3, 6)).astype(np.float32)
    sd_1, sd_2 = rng.uniform(0.01, 3.0, size=(2, 3, 6)).astype(np.float32)
    mu_j, sd_j = jax_pwg(*map(jnp.asarray, (mu_1, sd_1, mu_2, sd_2)))
    mu, sd = precision_weighted_gaussian(*map(torch.from_numpy, (mu_1, sd_1, mu_2, sd_2)))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_j), rtol=1e-6, atol=1e-7)
