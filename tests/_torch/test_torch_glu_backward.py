"""The twin of K1-bwd's warpgroup route (``ops/residual_glu.py:residual_glu_backward_plain``, split as its kernels
split it: pass A, the weight gradients, pass B) and its stacked form (``ops/wavenet_stack.py:stack_backward_plain``,
the blocks' gradients in the stack's ``(L, ...)`` tensors) on the CPU: against autograd of
``residual_glu_plain`` and ``wavenet_stack_plain`` in float64, and against ``jax.grad`` of the JAX block in float32.
On the card the route's kernels are held to this twin (``test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.models.wavenet.modules import Conv1dResidualGLU as JaxGLU
from blvm_tpu_torch import weights
from blvm_tpu_torch.models.wavenet.modules import Conv1dResidualGLU
from blvm_tpu_torch.ops import wavenet_stack as stack_ops
from blvm_tpu_torch.ops.residual_glu import residual_glu_backward_plain, residual_glu_plain

NAMES = ("x", "gate_kernel_t", "gate_kernel_s", "gate_bias_t", "gate_bias_s", "rs_kernel", "rs_bias")
C, B, T_IN = 8, 2, 150  # a dilation of 70 is longer than the route's 64-row tile


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _block(dilation, need_skip, seed):
    module = Conv1dResidualGLU(C, dilation=dilation, need_skip=need_skip)
    params = weights.random_jax_params(module, seed=seed)
    return params, [params[n] for n in NAMES[1:]]


@pytest.mark.parametrize(
    "dilation,window,need_skip",
    [(d, w, True) for d in (1, 4, 70) for w in ("every_row", "one", "part")] + [(d, "every_row", False) for d in (1, 4, 70)],
)
def test_backward_twin_matches_autograd_and_jax(dilation, window, need_skip):
    """Every gradient of sum(o dO) + sum(s dS): the twin in f64 against autograd of the f64 block (rtol 1e-10, the
    order of the sums), and in f32 against jax.grad of the JAX block (test_torch_grads.py's 1e-5 of each norm). The
    skip window covers every output row, its last row, or its last 37; skip-free the skip columns get exactly 0."""
    L = T_IN - dilation
    skip_size = {"every_row": L, "one": 1, "part": 37}[window]
    params, ws = _block(dilation, need_skip, seed=dilation)
    rng = np.random.default_rng(dilation + 7)
    x = rng.normal(size=(B, T_IN, C))
    d_o, d_s = rng.normal(size=(B, L, C)), rng.normal(size=(B, skip_size, C))

    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (x, *ws)]
    o, s = residual_glu_plain(*leaves, dilation=dilation, skip_size=skip_size, need_skip=need_skip)
    outputs, cotangents = [o], [torch.from_numpy(d_o)]
    if need_skip:
        outputs.append(s)
        cotangents.append(torch.from_numpy(d_s))
    torch.autograd.backward(outputs, cotangents)
    ref64 = [t.grad for t in leaves]

    def twin(dtype):
        x_, *w_ = (torch.from_numpy(np.asarray(a)).to(dtype) for a in (x, *ws))
        return residual_glu_backward_plain(x_, *w_[:5], d_o=torch.from_numpy(d_o).to(dtype),
                                           d_s=torch.from_numpy(d_s).to(dtype), dilation=dilation,
                                           skip_size=skip_size, need_skip=need_skip)

    got64 = twin(torch.float64)
    for name, a, r in zip(NAMES, got64, ref64):
        assert a.shape == r.shape and a.dtype == torch.float64, name
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-12, msg=name)

    jmod = JaxGLU(res_channels=C, dilation=dilation, need_skip=need_skip)
    d_o32, d_s32 = d_o.astype(np.float32), d_s.astype(np.float32)

    def objective(p, x_):
        o_, s_ = jmod.apply({"params": p}, x_, skip_size)
        return jnp.sum(o_ * d_o32) + (jnp.sum(s_ * d_s32) if need_skip else 0.0)

    jgrad_p, jgrad_x = jax.jit(jax.grad(objective, argnums=(0, 1)))(weights.unflatten(params), jnp.asarray(x, jnp.float32))
    jgrads = [jgrad_x] + [weights.flatten(jgrad_p)[n] for n in NAMES[1:]]
    got32 = twin(torch.float32)
    for name, a, r in zip(NAMES, got32, jgrads):
        assert _rel_norm(a.numpy(), r) <= 1e-5, name
    if not need_skip:
        assert not got64[5][..., C:].any() and not got64[6][C:].any()


def test_stacked_backward_twin_gives_the_stack_gradients():
    """``stack_backward_plain`` (the route's twin block by block, its gradients stacked) against
    autograd of ``wavenet_stack_plain`` over two chained stacks with taps, the second adding into the first's sum,
    in float64 (rtol 1e-10): the gradient of x and of every stacked parameter, ``rs_bias``'s included."""
    n_layers, dilations, skip_size = 4, [1, 2, 4, 70], 20
    blocks = []
    for l, d in enumerate(dilations * 2):
        module = Conv1dResidualGLU(C, dilation=d)
        weights.load_jax_params(module, weights.random_jax_params(module, seed=40 + l))
        blocks.append(module)
    params = [[p.detach() for p in stack_ops.pack_blocks(blocks[f : f + n_layers], torch.float64)] for f in (0, n_layers)]
    rng = np.random.default_rng(41)
    T = 2 * sum(dilations) + 30
    x0 = torch.from_numpy(rng.normal(size=(B, T, C)))
    g_out = torch.from_numpy(rng.normal(size=(B, T - 2 * sum(dilations), C)))
    g_sum = torch.from_numpy(rng.normal(size=(B, skip_size, C)))
    g_taps = [torch.from_numpy(rng.normal(size=(B, skip_size, C))) for _ in range(2)]

    leaves = [x0.clone().requires_grad_(True)] + [p.detach().clone().requires_grad_(True) for ps in params for p in ps]
    o1, sum1, (tap_a,) = stack_ops.wavenet_stack_plain(leaves[0], leaves[1:7], dilations, skip_size, (0,))
    o2, sum2, (tap_b,) = stack_ops.wavenet_stack_plain(o1, leaves[7:], dilations, skip_size, (3,), acc=sum1.clone())
    torch.autograd.backward([o2, sum2, tap_a, tap_b], [g_out, g_sum, *g_taps])

    with torch.no_grad():
        _, _, inputs2, _ = _stack_inputs(o1.detach(), params[1], dilations)
        d_o1, grads2 = stack_ops.stack_backward_plain(inputs2, params[1], dilations, skip_size, (3,), g_out, g_sum,
                                                      [g_taps[1]])
        _, _, inputs1, _ = _stack_inputs(x0, params[0], dilations)
        d_x, grads1 = stack_ops.stack_backward_plain(inputs1, params[0], dilations, skip_size, (0,), d_o1, g_sum,
                                                     [g_taps[0]])
    for i, (a, leaf) in enumerate(zip([d_x, *grads1, *grads2], leaves)):
        assert a.shape == leaf.shape
        torch.testing.assert_close(a, leaf.grad, rtol=1e-10, atol=1e-12, msg=f"leaf {i}")


def _stack_inputs(x, params, dilations):
    """Every block's input of one stack, as the save mode keeps them (the twin's chain)."""
    inputs, o = [], x
    for l, d in enumerate(dilations):
        inputs.append(o)
        o, _ = residual_glu_plain(o, *(p[l] for p in params), dilation=d, skip_size=1)
    return o, None, inputs, None
