"""K1's plain twin (the residual-GLU block) and the residual stack against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.models.wavenet.modules import Conv1dResidualGLU as JaxGLU
from blvm_tpu.models.wavenet.modules import ResidualStack as JaxStack
from blvm_tpu_torch import weights
from blvm_tpu_torch.models.wavenet.modules import (
    CausalConv1d,
    Conv1dResidualGLU,
    ResidualStack,
    residual_glu,
    residual_glu_plain,
)
from tests._torch.helpers import np32

# f32: summation order of the small dots (PyTorch's CPU GEMM vs XLA's).
# bf16: both round after every op, but at ulps of 2^-7 relative, and the gate's
# tanh/sigmoid amplify one-ulp input differences (the JAX suite's bf16 tolerance,
# tests/models/test_wavenet.py:276).
TOL = {False: 1e-5, True: 5e-2}


def _glu_params(C: int, seed: int, **kwargs):
    module = Conv1dResidualGLU(C, **kwargs)
    return module, weights.random_jax_params(module, seed)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("skip_mode", ["full", "tail"])
@pytest.mark.parametrize("dilation", [1, 4])
def test_residual_glu_block_matches_jax(dilation, skip_mode, bf16):
    """skip_mode full: skip_size == T_out (the stack's last block under rf padding);
    tail: only the last rows are kept (every other block)."""
    C, B, T_in = 8, 2, 24
    module, params = _glu_params(C, seed=dilation, dilation=dilation, dtype=torch.bfloat16 if bf16 else None)
    weights.load_jax_params(module, params)
    T_out = T_in - dilation
    skip_size = T_out if skip_mode == "full" else T_out - 5
    x = np.random.default_rng(7).normal(size=(B, T_in, C)).astype(np.float32)

    jmod = JaxGLU(res_channels=C, dilation=dilation, dtype=jnp.bfloat16 if bf16 else None)
    jo, js = jax.jit(lambda p, x_: jmod.apply({"params": p}, x_, skip_size))(weights.unflatten(params), jnp.asarray(x))
    with torch.no_grad():
        o, s = module(torch.from_numpy(x), skip_size)

    assert o.shape == (B, T_out, C) and s.shape == (B, skip_size, C)
    assert o.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(np32(o), np32(jo), rtol=0, atol=TOL[bf16])
    np.testing.assert_allclose(np32(s), np32(js), rtol=0, atol=TOL[bf16])


def test_residual_glu_wrapper_on_cpu_is_the_twin():
    C = 8
    module, params = _glu_params(C, seed=3)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 20, C)).astype(np.float32))
    args = [torch.from_numpy(params[n]) for n in ("gate_kernel_t", "gate_kernel_s", "gate_bias_t", "gate_bias_s",
                                                  "rs_kernel", "rs_bias")]
    for a, b in zip(residual_glu(x, *args, dilation=2, skip_size=7), residual_glu_plain(x, *args, dilation=2, skip_size=7)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_residual_stack_matches_jax(bf16):
    """Two stacks of three layers (dilations 1, 2, 4, 1, 2, 4): per-block skips in order."""
    C, B, T, skip_size = 8, 2, 40, 20
    stack = ResidualStack(n_layers=3, n_stacks=2, res_channels=C, dtype=torch.bfloat16 if bf16 else None)
    params = weights.random_jax_params(stack, seed=11)
    weights.load_jax_params(stack, params)
    x = np.random.default_rng(9).normal(size=(B, T, C)).astype(np.float32)

    jstack = JaxStack(n_layers=3, n_stacks=2, res_channels=C, dtype=jnp.bfloat16 if bf16 else None)
    jskips = jax.jit(lambda p, x_: jstack.apply({"params": p}, x_, skip_size))(weights.unflatten(params), jnp.asarray(x))
    with torch.no_grad():
        skips = stack(torch.from_numpy(x), skip_size)
    assert len(skips) == len(jskips) == 6
    assert stack.receptive_field == jstack.receptive_field
    for s, js in zip(skips, jskips):
        np.testing.assert_allclose(np32(s), np32(js), rtol=0, atol=TOL[bf16])


def test_causal_conv_drops_last_frame_exactly():
    causal = CausalConv1d(1, 1, kernel_size=2)
    weights.load_jax_params(causal, {"Conv1d_0": {"kernel": np.ones((2, 1, 1), np.float32), "bias": np.zeros(1, np.float32)}})
    x = torch.arange(1, 7, dtype=torch.float32).reshape(1, 6, 1)
    with torch.no_grad():
        np.testing.assert_array_equal(causal(x)[0, :, 0].numpy(), [3, 5, 7, 9])
        np.testing.assert_array_equal(causal(x, pad_causal=False)[0, :, 0].numpy(), [3, 5, 7, 9, 11])


@pytest.mark.parametrize("bf16", [False, True])
def test_residual_stack_collect_tails_matches_jax(bf16):
    """The history tails that prime fast generation: each block's last ``dilation``
    input frames, in the stack dtype, beside the skips of the one output column."""
    C, B, T = 8, 2, 24
    stack = ResidualStack(n_layers=3, n_stacks=2, res_channels=C, dtype=torch.bfloat16 if bf16 else None)
    params = weights.random_jax_params(stack, seed=12)
    weights.load_jax_params(stack, params)
    x = np.random.default_rng(10).normal(size=(B, T, C)).astype(np.float32)

    jstack = JaxStack(n_layers=3, n_stacks=2, res_channels=C, dtype=jnp.bfloat16 if bf16 else None)
    jskips, jtails = jax.jit(lambda p, x_: jstack.apply({"params": p}, x_, 1, collect_tails=True))(
        weights.unflatten(params), jnp.asarray(x))
    with torch.no_grad():
        skips, tails = stack(torch.from_numpy(x), 1, collect_tails=True)
    assert [tuple(t.shape) for t in tails] == [(B, d, C) for d in (1, 2, 4, 1, 2, 4)]
    assert all(t.dtype == (torch.bfloat16 if bf16 else torch.float32) for t in tails)
    for got, ref in zip(tails + skips, list(jtails) + list(jskips)):
        np.testing.assert_allclose(np32(got), np32(ref), rtol=0, atol=TOL[bf16])
