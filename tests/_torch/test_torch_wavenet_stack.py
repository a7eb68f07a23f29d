"""P2/P3, the fused WaveNet residual stack, on the CPU: its plain twin (``ops/wavenet_stack.py``) against JAX's
``ResidualStack`` and ``WaveNet``, the windowed generation that runs it a step against the port's own forward, the
packing of the blocks' parameters, the gradient of the twin path against autograd of the block chain, and which
configurations take the fused path. On the card the kernel is held to this twin by ``chip_smoke.py`` and to the K1
chain by ``test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.models import WaveNet as JaxWaveNet
from blvm_tpu.models.wavenet.modules import ResidualStack as JaxStack
from blvm_tpu_torch import weights
from blvm_tpu_torch.models import WaveNet
from blvm_tpu_torch.models.wavenet.modules import ResidualStack, residual_glu_plain
from blvm_tpu_torch.ops import wavenet_stack as stack_ops
from blvm_tpu_torch.ops.variational import rsample_discretized_logistic_mixture
from tests._torch.helpers import jax_forward, np32, torch_forward

# test_torch_wavenet_modules.py's tolerances: f32 the summation order of the small dots (PyTorch's CPU GEMM vs
# XLA's); bf16 both round after every op, at ulps of 2^-7 relative, which the gate's tanh and sigmoid amplify (the
# JAX suite's bf16 tolerance, tests/models/test_wavenet.py:276)
TOL = {False: 1e-5, True: 5e-2}
# the width the kernel is built for (ops/wavenet_stack.py: KERNEL_WIDTHS), so that the model takes the fused path
C, N_LAYERS, N_STACKS = 96, 4, 2


def port_stack(bf16: bool, seed: int):
    stack = ResidualStack(n_layers=N_LAYERS, n_stacks=N_STACKS, res_channels=C, dtype=torch.bfloat16 if bf16 else None)
    params = weights.random_jax_params(stack, seed)
    weights.load_jax_params(stack, params)
    return stack, params


def run_stacks(stack, x, skip_size, taps=()):
    """The port's stacks one ``wavenet_stack`` call each, as ``ResidualStack.forward_summed`` runs them:
    ``(out, summed, tapped)``, ``out`` the last block's residual output."""
    o = stack.Conv1d_0(x)
    o = o.to(stack.blocks[0].dtype or o.dtype)
    summed, tapped = None, []
    for first in range(0, len(stack.blocks), N_LAYERS):
        blocks = stack.blocks[first : first + N_LAYERS]
        local = [i - first for i in taps if first <= i < first + N_LAYERS]
        o, summed, skips = stack_ops.wavenet_stack(o, stack_ops.pack_blocks(blocks, o.dtype),
                                                   [b.dilation for b in blocks], skip_size, local, summed)
        tapped += skips
    return o, summed, tapped


@pytest.mark.parametrize("bf16", [False, True])
def test_stack_twin_matches_jax(bf16):
    """Two stacks of four layers (dilations 1, 2, 4, 8 twice): the summed skip against the f32 sum of JAX's skips in
    block order, the residual output against JAX's last block's, the taps against JAX's skips."""
    B, T, skip_size = 2, 60, 20
    stack, params = port_stack(bf16, seed=21)
    x = np.random.default_rng(22).normal(size=(B, T, C)).astype(np.float32)
    jstack = JaxStack(n_layers=N_LAYERS, n_stacks=N_STACKS, res_channels=C, dtype=jnp.bfloat16 if bf16 else None)
    last = f"Conv1dResidualGLU_{N_LAYERS * N_STACKS - 1}"
    jskips, state = jax.jit(lambda p, x_: jstack.apply({"params": p}, x_, skip_size, capture_intermediates=True,
                                                       mutable=["intermediates"]))(weights.unflatten(params), jnp.asarray(x))
    jout = state["intermediates"][last]["__call__"][0][0]
    jsum = sum(np.asarray(s, np.float32) for s in jskips)
    with torch.no_grad():
        out, summed, tapped = run_stacks(stack, torch.from_numpy(x), skip_size, taps=(0, 5))
    assert summed.dtype == torch.float32 and summed.shape == (B, skip_size, C)
    assert out.shape == (B, T - 2 * 15, C) and out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(summed.numpy(), jsum, rtol=0, atol=TOL[bf16])
    np.testing.assert_allclose(np32(out), np32(jout), rtol=0, atol=TOL[bf16])
    for got, ref in zip(tapped, (jskips[0], jskips[5])):
        np.testing.assert_allclose(np32(got), np32(ref), rtol=0, atol=TOL[bf16])


@pytest.mark.parametrize("pad_receptive_field", [True, False])
def test_fused_wavenet_forward_matches_jax(pad_receptive_field):
    """The whole forward on the fused path: loss and log_prob at test_torch_wavenet.py's f32 tolerances (the
    network's sums in another order than XLA's, passed on by the 2^8-bin DMoL), the z taps (every 5th block's
    skip, here blocks 0 and 5) at the stack's."""
    config = dict(n_layers=N_LAYERS, n_stacks=N_STACKS, res_channels=C, num_mix=3, num_bins=256)
    model = WaveNet(**config)
    params = weights.random_jax_params(model, 23)
    weights.load_jax_params(model, params)
    assert model.res_stack.fused
    rng = np.random.default_rng(24)
    x = rng.uniform(-1, 1, (2, 70)).astype(np.float32)
    x_sl = np.asarray([70, 52], np.int32)
    jloss, jmets, jout = jax_forward(JaxWaveNet(**config), params, x, x_sl, pad_receptive_field=pad_receptive_field)
    loss, mets, out = torch_forward(model, x, x_sl, pad_receptive_field=pad_receptive_field)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(np32(mets["log_prob"]), np32(jmets["log_prob"]), rtol=1e-5)
    assert len(out.z) == len(jout.z) == 2
    for got, ref in zip(out.z, jout.z):
        np.testing.assert_allclose(np32(got), np32(ref), rtol=0, atol=TOL[False])


def test_windowed_generation_runs_the_stacks_and_matches_the_forward(monkeypatch):
    """``generate(fast=False)`` re-runs the stacks over the receptive-field window a step (P3: one
    ``wavenet_stack`` call a stack, one skip row): fed the generation's uniforms, the sampler over the rf-padded
    forward of the generated waveform gives back every frame (f32, the order of the sums)."""
    model = WaveNet(n_layers=N_LAYERS, n_stacks=N_STACKS, res_channels=C, num_mix=3, num_bins=256)
    weights.load_jax_params(model, weights.random_jax_params(model, 25))
    calls = []
    twin = stack_ops.wavenet_stack

    def counted(x, params, dilations, skip_size, taps=(), acc=None):
        calls.append((tuple(x.shape), skip_size))
        return twin(x, params, dilations, skip_size, taps, acc)

    monkeypatch.setattr(stack_ops, "wavenet_stack", counted)
    n = 12
    rng = np.random.default_rng(26)
    u_cat, u_log = (torch.from_numpy(rng.random(shape, np.float32)) for shape in ((n, 2, 3), (n, 2, 1)))
    x = model.generate(2, n, fast=False, uniforms=(u_cat, u_log))
    rf = model.receptive_field
    assert calls == [((2, rf - 1, C), 1), ((2, rf - 1 - 15, C), 1)] * n
    _, _, out = torch_forward(model, x.numpy(), np.full(2, n, np.int32))
    again = rsample_discretized_logistic_mixture(None, *out.parameters, uniforms=(u_cat.transpose(0, 1),
                                                                               u_log.transpose(0, 1)))
    np.testing.assert_allclose(again[..., 0].numpy(), x.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_packing_carries_the_jax_parameters_unchanged(bf16):
    stack, params = port_stack(bf16, seed=27)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for first in range(0, N_LAYERS * N_STACKS, N_LAYERS):
        packed = stack_ops.pack_blocks(stack.blocks[first : first + N_LAYERS], dtype)
        for name, tensor in zip(stack_ops.PARAM_NAMES, packed):
            assert tensor.dtype == dtype
            for l in range(N_LAYERS):
                ref = torch.from_numpy(params[f"Conv1dResidualGLU_{first + l}/{name}"]).to(dtype)
                assert torch.equal(tensor[l], ref), (first + l, name)


@pytest.mark.parametrize("bf16", [False, True])
def test_stack_function_gradient_is_the_block_chains(bf16):
    """Two chained calls with taps, the second adding into the first's sum in place: the gradients of x and of
    every stacked parameter through the twin (the path a CPU tensor takes) equal autograd of the chain of
    ``residual_glu_plain`` blocks summed in f32 in block order. The same operations in the same order: bitwise.
    On the card ``WaveNetStackFunction`` is held to the K1 chain by test_torch_kernels_cuda.py."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    stack, _ = port_stack(bf16, seed=28)
    dilations = [b.dilation for b in stack.blocks[:N_LAYERS]]
    rng = np.random.default_rng(29)
    B, T, skip_size = 2, 40, 9
    x0 = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)).to(dtype)
    params0 = [stack_ops.pack_blocks(stack.blocks[f : f + N_LAYERS], dtype) for f in (0, N_LAYERS)]
    T_out = T - 2 * sum(dilations)
    g_out = torch.from_numpy(rng.normal(size=(B, T_out, C)).astype(np.float32)).to(dtype)
    g_sum = torch.from_numpy(rng.normal(size=(B, skip_size, C)).astype(np.float32))
    g_taps = [torch.from_numpy(rng.normal(size=(B, skip_size, C)).astype(np.float32)).to(dtype) for _ in range(2)]

    def leaves():
        return [x0.clone().requires_grad_(True)] + [p.detach().clone().requires_grad_(True) for ps in params0 for p in ps]

    fused = leaves()
    o, summed, tap_a = stack_ops.wavenet_stack(fused[0], fused[1:7], dilations, skip_size, taps=(0,))
    o, summed, tap_b = stack_ops.wavenet_stack(o, fused[7:], dilations, skip_size, taps=(1,), acc=summed)
    torch.autograd.backward([o, summed, tap_a[0], tap_b[0]], [g_out, g_sum, *g_taps])

    chain = leaves()
    o, skips = chain[0], []
    for s0, ps in ((0, chain[1:7]), (1, chain[7:])):
        for l, d in enumerate(dilations):
            o, s = residual_glu_plain(o, *(p[l] for p in ps), dilation=d, skip_size=skip_size)
            skips.append(s)
    ref_sum = skips[0].float()
    for s in skips[1:]:
        ref_sum = ref_sum + s
    torch.autograd.backward([o, ref_sum, skips[0], skips[N_LAYERS + 1]], [g_out, g_sum, *g_taps])
    for i, (a, b) in enumerate(zip(fused, chain)):
        assert a.grad.dtype == dtype
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0, msg=f"leaf {i}")


def test_fused_is_decided_by_the_configuration():
    assert ResidualStack(n_layers=2, n_stacks=1, res_channels=C).fused
    assert not ResidualStack(n_layers=2, n_stacks=1, res_channels=C, kernel_size=3).fused
    assert not ResidualStack(n_layers=2, n_stacks=1, res_channels=C, skip_channels=2 * C).fused
    assert not ResidualStack(n_layers=2, n_stacks=1, res_channels=C, gate_channels=C).fused
    assert not ResidualStack(n_layers=stack_ops.MAX_LAYERS + 1, n_stacks=1, res_channels=C).fused
    # a width the kernel is not built for (the driver's default --res_channels 64) keeps the block calls (K1 on
    # the card), and the model its list of skips
    assert not ResidualStack(n_layers=2, n_stacks=1, res_channels=64).fused
    model = WaveNet(n_layers=2, n_stacks=3, res_channels=64, num_mix=2, num_bins=256)
    calls = []
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(stack_ops, "wavenet_stack", lambda *a, **k: calls.append(a))
        _, _, out = model(torch.zeros(1, 30), torch.tensor([30]))
    assert calls == [] and [tuple(z.shape) for z in out.z] == [(1, 30, 64), (1, 30, 64)]
