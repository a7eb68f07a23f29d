"""The hand-written CUDA kernels against their plain twins, on the card: K1 and
K2 forward and backward (against autograd of the twins), P2/P3 the fused residual
stack (against the chain of K1 launches: outputs, save mode, gradient), K3 the sampler, K4 the
Fast-WaveNet decode step, K5 the LSTM recurrence forward and backward, K8 the
VRNN cell and K8-bwd its backward through time, K7 the GRU recurrence and K9 the
SRNN's latent chain, their save modes and their backwards through time, K7-bwd and K9-bwd; K1 and
K1-bwd at STCN's width (C = 256, with and without its skip) and K12, STCN's frame decode; K10, the
CW-VAE's RSSM cell chain, and K11, its coders' depthwise chain, their save modes and their backwards,
K10-bwd and K11-bwd; K6, the CTC probe's bidirectional LSTM layer, and K6-bwd; K13, its CTC loss, and K13-bwd; the
warpgroup tile alone (wgmma_bf16.cuh) and K1-bwd's warpgroup route (bf16 at C = 96) against its twin.

Marked ``cuda``: they skip without a CUDA device (here, on CPU-only machines).
On the card, where JAX is not installed, leave out the root conftest (it imports
JAX): ``python -m pytest --confcutdir=tests/_torch tests/_torch/test_torch_kernels_cuda.py``.
``chip_smoke.py``
holds the kernels to their twins at the flagship shapes; these tests cover the
other widths, ragged tiles, strided inputs and the refusals.
"""

import contextlib
import math
from unittest import mock

import pytest
import torch

from blvm_tpu_torch import weights
from blvm_tpu_torch.models import STCN, CWVAEAudio, LSTMAudio, SimpleLSTMASR, SRNNAudio, VRNNAudio, WaveNet
from blvm_tpu_torch.models.wavenet.modules import residual_glu, residual_glu_plain
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense
from blvm_tpu_torch.ops import ctc, cuda, depthwise, generation, likelihoods, recurrent, variational
from blvm_tpu_torch.ops import rssm as rssm_ops
from blvm_tpu_torch.ops import wavenet_stack as stack_ops
from blvm_tpu_torch.ops import wgmma_tile
from blvm_tpu_torch.ops.residual_glu import residual_glu_backward, residual_glu_backward_plain, wg_chain_backward
from blvm_tpu_torch.ops import srnn as srnn_ops
from blvm_tpu_torch.ops import vrnn as vrnn_ops
from blvm_tpu_torch.ops.generation import STCNDecoder, WaveNetDecoder

# f32: the kernel's FMA order against cuBLAS's (a few ulps of O(1) values).
# bf16: the kernel rounds once at the store, the twin after every op as JAX does:
# up to two bf16 ulps (2^-6 relative) plus the one-ulp gate amplification the
# JAX suite allows (5e-2 absolute).
K1_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2.0**-6, atol=5e-2)}


def glu_inputs(B, T_in, C, half, S, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(*shape, generator=g) * 2 - 1) / fan_in**0.5).to(device, dtype)

    x = torch.randn(B, T_in, C, generator=g).to(device, dtype)
    return (x, u(2, C, half, fan_in=2 * C), u(2, C, half, fan_in=2 * C), u(half, fan_in=2 * C), u(half, fan_in=2 * C),
            u(1, half, C + S, fan_in=half), u(C + S, fan_in=half))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,T_in,C,half,S,dilation,skip",
    [
        (2, 100, 96, 96, 96, 1, 99),  # flagship widths, skip == T_out
        (3, 700, 96, 96, 96, 512, 150),  # the largest dilation, a short tail of skip rows
        (1, 77, 40, 24, 16, 3, 10),  # generic widths, a ragged last time tile
        (2, 40, 8, 128, 248, 5, 35),  # the limits: half = 128, R + S = 256
        (3, 301, 32, 32, 32, 7, 100),  # the second tensor-core width (bf16), a ragged tile
        (1, 130, 96, 96, 96, 2, 128),  # exactly one 128-row tile
    ],
)
def test_residual_glu_kernel_matches_twin(cuda_device, dtype, B, T_in, C, half, S, dilation, skip):
    args = glu_inputs(B, T_in, C, half, S, dtype, cuda_device)
    o, s = residual_glu(*args, dilation=dilation, skip_size=skip)
    torch.cuda.synchronize()
    o_ref, s_ref = residual_glu_plain(*args, dilation=dilation, skip_size=skip)
    assert o.shape == o_ref.shape and s.shape == s_ref.shape and o.dtype == dtype
    torch.testing.assert_close(o.float(), o_ref.float(), **K1_TOL[dtype])
    torch.testing.assert_close(s.float(), s_ref.float(), **K1_TOL[dtype])


@pytest.mark.cuda
def test_residual_glu_tensor_core_and_fma_paths_agree(cuda_device):
    """bf16 at C = 96 takes the tensor-core path when x's rows are 16-byte aligned and
    the FMA path when they are not (a view offset by one element); both hold to the twin."""
    args = glu_inputs(2, 400, 96, 96, 96, torch.bfloat16, cuda_device)
    shifted = torch.empty(2 * 400 * 96 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(2, 400, 96)
    shifted.copy_(args[0])
    outs = [residual_glu(x, *args[1:], dilation=16, skip_size=300) for x in (args[0], shifted)]
    ref = residual_glu_plain(*args, dilation=16, skip_size=300)
    for o, s in outs:
        torch.testing.assert_close(o.float(), ref[0].float(), **K1_TOL[torch.bfloat16])
        torch.testing.assert_close(s.float(), ref[1].float(), **K1_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_residual_glu_kernel_refuses_what_it_does_not_take(cuda_device):
    args = glu_inputs(1, 50, 8, 8, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        residual_glu(*args, dilation=2, skip_size=49)  # more skip rows than output rows
    big = glu_inputs(1, 50, 8, 264, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        residual_glu(*big, dilation=2, skip_size=10)  # half above the kernel's limit
    with pytest.raises(TypeError):
        residual_glu(args[0].half(), *args[1:], dilation=2, skip_size=10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,T_in,dilation,skip,need_skip",
    [
        (2, 300, 1, 299, True),  # STCN's width, skip == T_out
        (3, 333, 16, 100, True),  # its widest dilation, the last rows' skip
        (2, 300, 1, 0, False),  # skip-free: only the R residual columns of rs_kernel
        (1, 97, 16, 0, False),  # skip-free, a ragged tile
    ],
)
def test_residual_glu_kernel_at_stcn_width(cuda_device, dtype, B, T_in, dilation, skip, need_skip):
    """K1 at C = half = 256, R + S = 512 (STCN's blocks), with the skip and in its skip-free mode,
    against the twin at phase 4's tolerances."""
    args = glu_inputs(B, T_in, 256, 256, 256, dtype, cuda_device)
    o, s = residual_glu(*args, dilation=dilation, skip_size=skip, need_skip=need_skip)
    torch.cuda.synchronize()
    o_ref, s_ref = residual_glu_plain(*args, dilation=dilation, skip_size=skip, need_skip=need_skip)
    torch.testing.assert_close(o.float(), o_ref.float(), **K1_TOL[dtype])
    if need_skip:
        torch.testing.assert_close(s.float(), s_ref.float(), **K1_TOL[dtype])
    else:
        assert s is None and s_ref is None


@pytest.mark.cuda
@pytest.mark.parametrize("need_skip", [True, False])
def test_residual_glu_tiled_and_fma_paths_agree_at_stcn_width(cuda_device, need_skip):
    """f32 at C = 256 takes the register-tiled path when x's rows are 16-byte aligned and the FMA path
    when they are not (a view offset by one element); both hold to the twin at phase 4's tolerance."""
    args = glu_inputs(2, 200, 256, 256, 256, torch.float32, cuda_device)
    shifted = torch.empty(2 * 200 * 256 + 1, device=cuda_device)[1:].view(2, 200, 256)
    shifted.copy_(args[0])
    skip = 150 if need_skip else 0
    ref = residual_glu_plain(*args, dilation=8, skip_size=skip, need_skip=need_skip)
    for x in (args[0], shifted):
        o, s = residual_glu(x, *args[1:], dilation=8, skip_size=skip, need_skip=need_skip)
        torch.testing.assert_close(o, ref[0], **K1_TOL[torch.float32])
        if need_skip:
            torch.testing.assert_close(s, ref[1], **K1_TOL[torch.float32])


def _glu_grads_in(fn, args, dtype, dilation, skip, need_skip, seed=1):
    """Gradients of sum(o dO) + sum(s dS) by the block's seven inputs, cast to ``dtype``, through ``fn``."""
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in args]
    o, s = fn(*leaves, dilation=dilation, skip_size=skip, need_skip=need_skip)
    g = torch.Generator(device=o.device).manual_seed(seed)
    outputs, cotangents = [o], [torch.randn(o.shape, generator=g, device=o.device).to(dtype)]
    if need_skip:
        outputs.append(s)
        cotangents.append(torch.randn(s.shape, generator=g, device=o.device).to(dtype))
    torch.autograd.backward(outputs, cotangents)
    return [leaf.grad.double() for leaf in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("need_skip", [True, False])
@pytest.mark.parametrize("dilation", [1, 16])
def test_residual_glu_backward_kernel_at_stcn_width(cuda_device, dilation, need_skip):
    """K1-bwd at C = half = R = 256 in f32 (the register-tiled path), with the skip (S = 256, the last 150
    rows) and skip-free, at an uneven T: every gradient held to autograd of the float64 twin within twice
    the f32 twin's error plus 1e-6 (largest absolute error); skip-free, the skip columns of rs_kernel and
    rs_bias get exactly 0, as JAX's column slice gives them."""
    args = glu_inputs(2, 333, 256, 256, 256, torch.float32, cuda_device)
    cuda.reset_launch_counts()
    got = _glu_grads_in(residual_glu, args, torch.float32, dilation, 150, need_skip)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["residual_glu_bwd"] == 1
    twin = _glu_grads_in(residual_glu_plain, args, torch.float32, dilation, 150, need_skip)
    ref = _glu_grads_in(residual_glu_plain, args, torch.float64, dilation, 150, need_skip)
    for name, k, t, r in zip(("x", "w_t", "w_s", "b_t", "b_s", "w_rs", "b_rs"), got, twin, ref):
        err_k, err_t = (k - r).abs().max().item(), (t - r).abs().max().item()
        assert torch.isfinite(k).all() and err_k <= 2 * err_t + 1e-6, (name, err_k, err_t)
    if not need_skip:
        assert not got[5][..., 256:].any() and not got[6][256:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_glu_backward_kernel_skip_free_at_wavenet_widths(cuda_device, dtype):
    """The FMA and tensor-core widths' skip-free mode (the FMA path: only dO feeds d_act, rs_kernel read at its
    full row width): K1-bwd against autograd of the twin at K1_BWD_REL, the skip columns' gradients 0."""
    args = glu_inputs(2, 150, 96, 96, 96, dtype, cuda_device)
    got = _glu_grads_in(residual_glu, args, dtype, 4, 0, False)
    ref = _glu_grads_in(residual_glu_plain, args, dtype, 4, 0, False)
    for name, a, b in zip(("x", "w_t", "w_s", "b_t", "b_s", "w_rs", "b_rs"), got, ref):
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        assert torch.isfinite(a).all() and rel <= K1_BWD_REL[dtype], (name, rel)
    assert not got[5][..., 96:].any() and not got[6][96:].any()


@pytest.mark.cuda
def test_residual_glu_backward_refuses_what_it_does_not_take(cuda_device):
    """K1-bwd takes half <= 128 and R + S <= 256, or f32 at C = half = R = 256 with S = 256 or skip-free: under
    autograd at STCN's width in bf16, or at a width between, it raises (no plain fallback on the card)."""
    cases = [(torch.bfloat16, 256, 256, 256, True), (torch.bfloat16, 256, 256, 256, False),
             (torch.float32, 256, 256, 128, True), (torch.float32, 192, 192, 192, False)]
    for dtype, C, half, S, need_skip in cases:
        args = [t.requires_grad_(True) for t in glu_inputs(1, 40, C, half, S, dtype, cuda_device)]
        o, s = residual_glu(*args, dilation=2, skip_size=10, need_skip=need_skip)
        with pytest.raises(NotImplementedError, match="residual_glu_bwd kernel takes"):
            (o.float().sum() + (s.float().sum() if s is not None else 0)).backward()


def stack_inputs(B, T_in, C, L, dtype, device, seed=0):
    """A stack's input and ``L`` blocks' stacked weights (ops/wavenet_stack.py:pack_blocks' layout), U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) as the model draws them, and the dilations 1, 2, 4, ..."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(*shape, generator=g) * 2 - 1) / fan_in**0.5).to(device, dtype)

    x = torch.randn(B, T_in, C, generator=g).to(device, dtype)
    params = (u(L, 2, C, C, fan_in=2 * C), u(L, 2, C, C, fan_in=2 * C), u(L, C, fan_in=2 * C), u(L, C, fan_in=2 * C),
              u(L, 1, C, 2 * C, fan_in=C), u(L, 2 * C, fan_in=C))
    return x, params, [2**i for i in range(L)]


def k1_chain(x, params, dilations, skip_size, acc=None):
    """The stack as the chain of K1 launches, the skips summed in f32 in block order: ``(out, summed, skips)``."""
    o, summed, skips = x, acc, []
    for l, d in enumerate(dilations):
        o, s = residual_glu(o, *(p[l] for p in params), dilation=d, skip_size=skip_size)
        skips.append(s)
        summed = s.float() if summed is None else summed + s
    return o, summed, skips


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "C,B,T_in,L,skip,accumulate",
    [
        (96, 2, 1300, 10, 200, False),  # a flagship stack, ragged tiles at both ends of every layer
        (96, 2, 1024, 10, 1, True),  # a generation window: one output row, one skip row, added into a sum
        (96, 3, 700, 3, 5, True),  # a short stack of three blocks
    ],
)
def test_wavenet_stack_kernel_matches_the_k1_chain_and_its_twin(cuda_device, dtype, C, B, T_in, L, skip, accumulate):
    """P2/P3 against the chain of K1 launches within K1's limits (f32 the FMA order; bf16 the same roundings,
    the same products), and no further from the twin (which rounds after every op) than twice the chain is,
    with K1's tolerance as the floor; the taps are the chain's skips."""
    x, params, dilations = stack_inputs(B, T_in, C, L, dtype, cuda_device)
    acc = torch.randn(B, skip, C, device=cuda_device) if accumulate else None
    cuda.reset_launch_counts()
    with torch.no_grad():
        out, summed, taps = stack_ops.wavenet_stack(x, params, dilations, skip, (0, L - 1),
                                                    acc.clone() if accumulate else None)
        torch.cuda.synchronize()
        assert cuda.launch_counts()["wavenet_stack"] == 1
        ref_out, ref_sum, ref_skips = k1_chain(x, params, dilations, skip, acc)
        twin_out, twin_sum, _ = stack_ops.wavenet_stack_plain(x, params, dilations, skip, (), acc)
    assert out.shape == ref_out.shape and summed.shape == ref_sum.shape and summed.dtype == torch.float32
    torch.testing.assert_close(out, ref_out, **K1_TOL[dtype])
    torch.testing.assert_close(summed, ref_sum, **K1_TOL[dtype])
    for got, ref in zip(taps, (ref_skips[0], ref_skips[-1])):
        torch.testing.assert_close(got, ref, **K1_TOL[dtype])
    for got, ref, twin in ((out, ref_out, twin_out), (summed, ref_sum, twin_sum)):
        chain_err = (ref.float() - twin.float()).abs().max().item()
        assert (got.float() - twin.float()).abs().max().item() <= max(2 * chain_err, K1_TOL[dtype]["atol"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wavenet_stack_save_mode_is_a_plain_launch(cuda_device, dtype):
    """The save mode writes every block's input (the chain's block outputs) and the same bits as a plain launch."""
    x, params, dilations = stack_inputs(2, 1300, 96, 10, dtype, cuda_device, seed=1)
    with torch.no_grad():
        plain = stack_ops._launch(x, params, dilations, 100, (0, 5), None, save=False)
        saved = stack_ops._launch(x, params, dilations, 100, (0, 5), None, save=True)
        o = x
        for l, d in enumerate(dilations[:-1]):
            o, _ = residual_glu(o, *(p[l] for p in params), dilation=d, skip_size=100)
            torch.testing.assert_close(saved[2][l + 1], o, **K1_TOL[dtype])
    assert plain[2] is None and len(saved[2]) == 10 and saved[2][0] is x
    for a, b in ((plain[0], saved[0]), (plain[1], saved[1]), *zip(plain[3], saved[3])):
        assert torch.equal(a, b)


def stack_gradients_against_the_k1_chain(device, dtype, L, T_in, taps):
    """Two chained stacks of ``L`` blocks through WaveNetStackFunction, taps ``taps[0]`` of the first and ``taps[1]``
    of the second, an output gradient on every output, the second adding into the first's sum, against autograd of
    the K1 chain: the input's gradient within K1's limits, the weight and bias gradients by their relative norm, as
    K1-bwd's are held (f32 1e-5, bf16 2e-2)."""
    x, p1, dilations = stack_inputs(2, T_in, 96, L, dtype, device, seed=2)
    _, p2, _ = stack_inputs(2, T_in, 96, L, dtype, device, seed=3)
    g = torch.Generator(device=device).manual_seed(4)
    skip, T_out = 50, T_in - 2 * sum(dilations)
    g_out = torch.randn(2, T_out, 96, generator=g, device=device).to(dtype)
    g_sum = torch.randn(2, skip, 96, generator=g, device=device)
    g_taps = [torch.randn(2, skip, 96, generator=g, device=device).to(dtype) for _ in range(2)]

    def leaves():
        return [t.detach().clone().requires_grad_(True) for t in (x, *p1, *p2)]

    fused = leaves()
    cuda.reset_launch_counts()
    o, summed, (t_a,) = stack_ops.wavenet_stack(fused[0], fused[1:7], dilations, skip, (taps[0],))
    o, summed, (t_b,) = stack_ops.wavenet_stack(o, fused[7:], dilations, skip, (taps[1],), summed)
    torch.autograd.backward([o, summed, t_a, t_b], [g_out, g_sum, *g_taps])
    counts = cuda.launch_counts()
    expected = {name: 2 * L for name in WG_BWD} if dtype == torch.bfloat16 else {"residual_glu_bwd": 2 * L}
    assert counts["wavenet_stack"] == 2 and bwd_launches(counts) == expected and counts["residual_glu"] == 0
    chain = leaves()
    o, s1, skips1 = k1_chain(chain[0], chain[1:7], dilations, skip)
    o, summed, skips2 = k1_chain(o, chain[7:], dilations, skip, s1)
    torch.autograd.backward([o, summed, skips1[taps[0]], skips2[taps[1]]], [g_out, g_sum, *g_taps])
    torch.testing.assert_close(fused[0].grad, chain[0].grad, **K1_TOL[dtype])
    for a, b in zip(fused[1:], chain[1:]):
        rel = ((a.grad.double() - b.grad.double()).norm() / b.grad.double().norm()).item()
        assert rel <= (1e-5 if dtype == torch.float32 else 2e-2), rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wavenet_stack_gradients_match_the_k1_chain(cuda_device, dtype):
    """Through WaveNetStackFunction (the kernel in save mode, ten blocks' backward in reverse: in bf16 the warpgroup
    route's four kernels a block, in f32 K1-bwd) against autograd of the K1 chain
    (:func:`stack_gradients_against_the_k1_chain`), taps 0 and 5."""
    stack_gradients_against_the_k1_chain(cuda_device, dtype, 10, 2200, (0, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 2, 3])
def test_short_bf16_stack_gradients_match_the_k1_chain(cuda_device, L):
    """bf16 stacks of 1, 2 and 3 blocks (the warpgroup chain with no buffer for a block's dx between blocks, and with
    its two buffers used once and in turn) against autograd of the K1 chain
    (:func:`stack_gradients_against_the_k1_chain`), the first and the last block tapped."""
    stack_gradients_against_the_k1_chain(cuda_device, torch.bfloat16, L, 300, (0, L - 1))


@pytest.mark.cuda
def test_wavenet_stack_kernel_refuses_what_it_does_not_take(cuda_device):
    """Widths other than C = half = R = S = 96, other dtypes, more than 16 blocks, too few rows for the skip:
    it raises (no plain fallback on the card)."""
    x, params, dilations = stack_inputs(1, 300, 96, 3, torch.float32, cuda_device)
    with pytest.raises(NotImplementedError):
        stack_ops.wavenet_stack(*stack_inputs(1, 300, 64, 3, torch.float32, cuda_device), 10)
    with pytest.raises(TypeError):
        stack_ops.wavenet_stack(x.double(), [p.double() for p in params], dilations, 10)
    with pytest.raises(ValueError):
        stack_ops.wavenet_stack(x, params, dilations, 300 - 7 + 1)
    with pytest.raises(ValueError):
        stack_ops.wavenet_stack(*stack_inputs(1, 300, 96, 17, torch.float32, cuda_device)[:2], [1] * 17, 10)
    with pytest.raises(ValueError):
        stack_ops.wavenet_stack(x, params, dilations, 10, acc=torch.zeros(1, 10, 96, device=cuda_device).bfloat16())


def stcn_case(device, n, history=True, B=2, **kwargs):
    """An STCN with random weights, its primes over a history (or zeros), the prior noise and the uniforms."""
    model = STCN(device=device, **kwargs)
    weights.load_jax_params(model, weights.random_jax_params(model, 5))
    g = torch.Generator(device=device).manual_seed(6)
    hist = torch.rand(B, 200, generator=g, device=device) * 2 - 1 if history else None
    with torch.no_grad():
        window = model._window(B, hist)
        enc_tails, dec_tails, d0 = model._prime(window)
    eps = torch.randn(n, B, sum(model.latent_size), generator=g, device=device)
    keys = variational.FrameKeys(None, device, (torch.rand(n, B, 10, generator=g, device=device),
                                                torch.rand(n, B, 1, generator=g, device=device)))
    return model, window, enc_tails, dec_tails, d0, eps, keys


@pytest.mark.cuda
@pytest.mark.parametrize("history", [True, False])
@pytest.mark.parametrize("width", ["stcn", "small"])
def test_stcn_decode_kernel_matches_plain_loop(cuda_device, width, history):
    """K12 fed the prior's noise and the uniforms against the plain loop fed the kernel's frames
    (teacher forcing): every frame's z and DMoL parameters within the order of the sums (1e-5
    absolute plus 1e-5 relative), frame 0 from the encoder prime's columns (the d-column mode)."""
    n = 12
    kwargs = {} if width == "stcn" else dict(n_layers=3, latent_size=(8, 4, 4), res_channels=16)
    model, window, enc_tails, dec_tails, d0, eps, keys = stcn_case(cuda_device, n, history, **kwargs)
    cuda.reset_launch_counts()
    with torch.no_grad():
        got, z, params = STCNDecoder(model, enc_tails, dec_tails).run(window[:, -1, 0], d0, n, eps, keys, record=True)
        torch.cuda.synchronize()
        assert cuda.launch_counts()["stcn_decode"] == 1
        ref, z_ref, params_ref = model._generate_fast_plain(window[:, -1:], d0, enc_tails, dec_tails, n, eps, keys,
                                                            forced=got)
    assert got.shape == (2, n) and torch.isfinite(got).all() and got.abs().max() <= 1
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(params, params_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def within(got, ref, atol, rtol):
    """The largest excess of |got - ref| over atol + rtol |ref| (<= 0: within), and the largest difference."""
    err = (got - ref).abs()
    return (err - atol - rtol * ref.abs()).max().item(), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 300])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_stcn_decode_kernel_over_a_generation_at_the_run_spec_width(cuda_device, B, n):
    """K12 at benchmarks.txt:26's width (C = 256, 5 x 5 encoder blocks, z = [256, 128, 64, 32, 16]), one launch for
    all n frames, against the plain loop: teacher-forced (every frame's z, DMoL parameters and sample) and running
    free, each within the order of the sums (1e-5 + 1e-5 |twin|); two launches give the same bits."""
    model, window, enc_tails, dec_tails, d0, eps, keys = stcn_case(cuda_device, n, B=B)
    outs = []
    for _ in range(2):
        cuda.reset_launch_counts()
        with torch.no_grad():
            outs.append(STCNDecoder(model, enc_tails, dec_tails).run(window[:, -1, 0], d0, n, eps, keys, record=True))
        assert cuda.launch_counts()["stcn_decode"] == 1
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    got, z, params = outs[0]
    with torch.no_grad():
        forced = model._generate_fast_plain(window[:, -1:], d0, enc_tails, dec_tails, n, eps, keys, forced=got)
        free = model._generate_fast_plain(window[:, -1:], d0, enc_tails, dec_tails, n, eps, keys)
    assert got.shape == (B, n) and torch.isfinite(got).all() and got.abs().max() <= 1
    for label, a, ref in (("z", z, forced[1]), ("params", params, forced[2]), ("frames", got, forced[0]),
                          ("free-running frames", got, free[0])):
        excess, err = within(a, ref, 1e-5, 1e-5)
        assert excess <= 0, f"{label}: max err {err}"


@pytest.mark.cuda
def test_stcn_decode_kernel_refuses_a_batch_it_does_not_take_and_raises_on_a_timeout(cuda_device, monkeypatch):
    model, window, enc_tails, dec_tails, d0, eps, keys = stcn_case(cuda_device, 4, B=9, n_layers=2,
                                                                     latent_size=(8, 4), res_channels=16)
    with pytest.raises(ValueError):
        STCNDecoder(model, enc_tails, dec_tails)  # nine rows
    model, window, enc_tails, dec_tails, d0, eps, keys = stcn_case(cuda_device, 4)
    with monkeypatch.context() as patch, pytest.raises(RuntimeError, match="gave up"):
        patch.setattr(generation, "WAIT_LIMIT_NS", 1)  # a 1 ns wait limit: the first wait that must wait gives up
        STCNDecoder(model, enc_tails, dec_tails).run(window[:, -1, 0], d0, 4, eps, keys)
    with torch.no_grad():  # the card is still usable
        got = STCNDecoder(model, enc_tails, dec_tails).run(window[:, -1, 0], d0, 4, eps, keys)
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_stcn_generate_on_the_card_launches_k12_and_matches_the_windowed_path(cuda_device):
    """One Philox key a generation: K12 and the windowed path (K1 x 6 and K3 a frame) draw the same
    numbers for the same frame, with the same prior noise (f32, 1e-5); the primes launch K1 6 times."""
    model = STCN(n_layers=2, latent_size=(8, 4), res_channels=16, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 7))
    eps = torch.randn(10, 2, 12, device=cuda_device)
    cuda.reset_launch_counts()
    (fast, _), _ = model.generate(2, 10, generator=torch.Generator(device=cuda_device).manual_seed(4), eps=eps)
    counts = cuda.launch_counts()
    assert counts["stcn_decode"] == 1 and counts["residual_glu"] == 6 and counts["dmol_sample"] == 0
    (naive, _), _ = model.generate(2, 10, fast=False, generator=torch.Generator(device=cuda_device).manual_seed(4),
                                   eps=eps)
    torch.testing.assert_close(fast, naive, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_stcn_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    model, window, enc_tails, dec_tails, d0, eps, keys = stcn_case(cuda_device, 4, n_layers=2, latent_size=(8, 4),
                                                                     res_channels=16)
    with pytest.raises(ValueError):
        STCNDecoder(model, enc_tails[:-1], dec_tails)  # a block without its buffer
    decoder = STCNDecoder(model, enc_tails, dec_tails)
    with pytest.raises(ValueError):
        decoder.run(window[:, -1, 0], d0, 5, eps, keys)  # more frames than rows of noise
    for kwargs in (dict(bf16=True), dict(top_down=False), dict(dense=False), dict(res_channels=264),
                   dict(latent_size=(8, 6))):  # ... a width that is not a multiple of 4
        other = STCN(device=cuda_device, **{"n_layers": 2, "latent_size": (8, 4), "res_channels": 16, **kwargs})
        with pytest.raises(ValueError):
            STCNDecoder(other, enc_tails, dec_tails)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bins", [256, 65536])
def test_dmol_kernel_matches_twin_on_strided_head_output(cuda_device, num_bins):
    """The kernel reads the head's strided slices; the edges of the ladder are in
    the inputs (y = +-1, log_scale = -7 far from the target)."""
    g = torch.Generator().manual_seed(1)
    B, T, M = 3, 1000, 10
    params = torch.randn(B, T, 3 * M, generator=g).to(cuda_device)
    logits = params[..., :M]
    locs = params[..., M : 2 * M].reshape(B, T, 1, M)
    log_scales = torch.clamp_min(params[..., 2 * M :].reshape(B, T, 1, M) - 3, -7.0)
    y = (torch.rand(B, T, 1, generator=g) * 2 - 1).to(cuda_device)
    y[0, :100] = -1.0
    y[0, 100:200] = 1.0
    log_scales[1, :200] = -7.0
    cuda.reset_launch_counts()
    got = likelihoods.dmol_log_prob(y, logits, locs, log_scales, num_bins=num_bins)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["dmol_log_prob"] == 1
    ref = likelihoods.discretized_logistic_mixture_ll(y, logits, locs, log_scales, num_bins=num_bins)
    bound = likelihoods.dmol_f32_error_bound(y, logits, locs, log_scales, num_bins=num_bins)
    assert got.shape == (B, T) and torch.isfinite(got).all()
    err = (got - ref).abs().double()
    assert (err <= bound).all(), f"max err {err.max().item()}"


# K1-bwd against autograd of the twin, relative to each gradient's norm. f32: FMA order
# against cuBLAS's and sums over all rows in another order (1e-5). bf16: the twin rounds
# every op of the forward and the backward to bf16 (2^-8 relative each), the kernel once
# at each store; a handful of such roundings on a gradient's path (2e-2).
K1_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _glu_grads(fn, args, dilation, skip, seed=1):
    leaves = [t.detach().requires_grad_(True) for t in args]
    o, s = fn(*leaves, dilation=dilation, skip_size=skip)
    g = torch.Generator(device=o.device).manual_seed(seed)
    d_o = torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
    d_s = torch.randn(s.shape, generator=g, device=o.device).to(o.dtype)
    torch.autograd.backward([o, s], [d_o, d_s])
    return [leaf.grad for leaf in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,T_in,C,half,S,dilation,skip",
    [
        (2, 100, 96, 96, 96, 1, 99),  # tensor-core widths (bf16), skip == T_out
        (3, 700, 96, 96, 96, 512, 150),  # the largest dilation, a short tail of skip rows
        (1, 77, 40, 24, 16, 3, 10),  # generic widths: the FMA path in both dtypes
        (2, 40, 8, 128, 248, 5, 35),  # the limits: half = 128, R + S = 256
        (3, 301, 32, 32, 32, 7, 100),  # the second tensor-core width, a ragged tile
    ],
)
def test_residual_glu_backward_kernel_matches_autograd_of_twin(cuda_device, dtype, B, T_in, C, half, S, dilation, skip):
    args = glu_inputs(B, T_in, C, half, S, dtype, cuda_device)
    cuda.reset_launch_counts()
    got = _glu_grads(residual_glu, args, dilation, skip)
    torch.cuda.synchronize()
    wg = dtype == torch.bfloat16 and C == half == S == 96  # the warpgroup route's four kernels
    assert bwd_launches(cuda.launch_counts()) == ({name: 1 for name in WG_BWD} if wg else {"residual_glu_bwd": 1})
    ref = _glu_grads(residual_glu_plain, args, dilation, skip)
    for name, a, b in zip(("x", "w_t", "w_s", "b_t", "b_s", "w_rs", "b_rs"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.isfinite(a).all(), name
        rel = ((a.double() - b.double()).norm() / b.double().norm()).item()
        assert rel <= K1_BWD_REL[dtype], (name, rel)


WG_BWD = ("glu_bwd_pass_a", "glu_bwd_wgrad", "glu_bwd_reduce", "glu_bwd_pass_b")


def bwd_launches(counts):
    """The launches of K1-bwd's kernels in ``counts`` that are not 0."""
    return {k: v for k, v in counts.items() if v and (k in WG_BWD or k == "residual_glu_bwd")}


@pytest.mark.cuda
@pytest.mark.parametrize("n,layout", [(96, "a_k_major"), (96, "a_m_major"), (192, "a_k_major"), (192, "a_m_major"),
                                      (192, "a_registers")])
def test_wgmma_tile_matches_a_plain_product(cuda_device, n, layout):
    """The warpgroup tile alone, in each operand layout the kernels use (A from registers at N = 192 only, the stack's
    [r | s] product), against the product of the same bf16 values in f32 (f32 accumulation both: the order of the
    sums, 1e-5 of the largest |D|), at K = 16 (one k-step), 64 and 192."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    for K in (16, 64, 192):
        trans_a = layout == "a_m_major"
        a = torch.randn((K, 64) if trans_a else (64, K), generator=g, device=cuda_device).bfloat16()
        b = torch.randn(K, n, generator=g, device=cuda_device).bfloat16()
        cuda.reset_launch_counts()
        d = wgmma_tile.wgmma_tile(a, b, trans_a, layout == "a_registers")
        torch.cuda.synchronize()
        assert cuda.launch_counts()["wgmma_tile"] == 1
        ref = wgmma_tile.wgmma_tile_plain(a, b, trans_a)
        assert (d - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), (K, layout)


def _wg_case(B, T_in, dilation, skip, device, seed=0):
    x, *w = glu_inputs(B, T_in, 96, 96, 96, torch.bfloat16, device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    d_o = torch.randn(B, T_in - dilation, 96, generator=g, device=device).bfloat16()
    d_s = torch.randn(B, skip, 96, generator=g, device=device).bfloat16()
    return x, w[:5], d_o, d_s


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T_in,dilation,skip",
    [
        (8, 2600, 64, 2536),  # the step's rows in miniature: the skip over every output row
        (2, 700, 512, 150),  # a dilation longer than a tile, a skip window that starts inside one
        (1, 301, 7, 1),  # B = 1, one skip row, a ragged last tile
        (3, 100, 4, 37),  # T_out = 96: one full tile and a part a row
        (2, 65, 1, 64),  # T_out = 64: exactly one tile, no rows past it
    ],
)
def test_residual_glu_backward_wg_route_matches_its_twin(cuda_device, B, T_in, dilation, skip):
    """K1-bwd's warpgroup route (four launches, no other) against its twin on the same bf16 inputs, both held to the
    twin in float64: each gradient's relative-norm error at most twice the bf16 twin's plus 1e-3 (the kernels round
    d_pre and act once, as the twin does; the sums run in another order). Two runs give the same bits. As a chain
    of one given a block's slots of stacked gradients (``wg_chain_backward``), it writes that block's and no other's,
    the same bits."""
    x, w, d_o, d_s = _wg_case(B, T_in, dilation, skip, cuda_device)
    cuda.reset_launch_counts()
    got = residual_glu_backward(x, *w, d_o=d_o, d_s=d_s, dilation=dilation, skip_size=skip)
    torch.cuda.synchronize()
    assert bwd_launches(cuda.launch_counts()) == {name: 1 for name in WG_BWD}
    again = residual_glu_backward(x, *w, d_o=d_o, d_s=d_s, dilation=dilation, skip_size=skip)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    slots = [torch.full((3, *t.shape), float("nan"), dtype=t.dtype, device=cuda_device) for t in w]
    slots.append(torch.full((3, 192), float("nan"), dtype=torch.bfloat16, device=cuda_device))
    dx = wg_chain_backward([x], [t.unsqueeze(0) for t in w], d_o, [d_s], [dilation], skip, [t[1:2] for t in slots])
    assert torch.equal(dx, got[0]) and all(torch.equal(t[1], g) for t, g in zip(slots, got[1:]))
    assert all(t[0].isnan().all() and t[2].isnan().all() for t in slots)
    twin = residual_glu_backward_plain(x, *w, d_o=d_o, d_s=d_s, dilation=dilation, skip_size=skip)
    ref = residual_glu_backward_plain(x.double(), *(t.double() for t in w), d_o=d_o.double(), d_s=d_s.double(),
                                      dilation=dilation, skip_size=skip)
    for name, k, t, r in zip(("x", "w_t", "w_s", "b_t", "b_s", "w_rs", "b_rs"), got, twin, ref):
        assert k.shape == r.shape and k.dtype == torch.bfloat16 and torch.isfinite(k).all(), name
        err_k, err_t = ((k.double() - r).norm() / r.norm()).item(), ((t.double() - r).norm() / r.norm()).item()
        assert err_k <= 2 * err_t + 1e-3, (name, err_k, err_t)


@pytest.mark.cuda
def test_residual_glu_backward_wg_route_refuses_what_it_does_not_take(cuda_device):
    """Gradient slots of the wrong shape, dtype or layout, and a skip window longer than the output: it raises.
    Skip-free at C = 96 and f32 keep K1-bwd (no warpgroup launch)."""
    x, w, d_o, d_s = _wg_case(1, 200, 4, 50, cuda_device)
    weights_ = [t.unsqueeze(0) for t in w]
    good = [torch.empty_like(t) for t in weights_] + [torch.empty(1, 192, dtype=torch.bfloat16, device=cuda_device)]
    for bad in ([t.float() for t in good], good[:5] + [good[0]],
                [good[0].transpose(2, 3).contiguous().transpose(2, 3)] + good[1:]):
        with pytest.raises(ValueError):
            wg_chain_backward([x], weights_, d_o, [d_s], [4], 50, bad)
    with pytest.raises(ValueError):
        residual_glu_backward(x, *w, d_o=d_o, d_s=torch.zeros(1, 197, 96, device=cuda_device).bfloat16(), dilation=4,
                              skip_size=197)
    for dtype, need_skip in ((torch.bfloat16, False), (torch.float32, True)):
        cuda.reset_launch_counts()
        args = [t.to(dtype) for t in (x, *w)]
        residual_glu_backward(*args, d_o=d_o.to(dtype), d_s=d_s.to(dtype), dilation=4, skip_size=50,
                              need_skip=need_skip)
        torch.cuda.synchronize()
        assert bwd_launches(cuda.launch_counts()) == {"residual_glu_bwd": 1}


@pytest.mark.cuda
def test_dmol_backward_kernel_matches_autograd_of_twin(cuda_device):
    """Gradients of the head's output through K2, against autograd of the f32 twin,
    both held to the float64 twin: the kernel's error may be at most 2x the f32
    twin's plus 1e-6, outside components whose branch of the ladder flips between
    float32 and float64 (cdf_delta within rounding of its 1e-5 threshold)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, T, M, num_bins = 3, 2000, 10, 2**16
    head = torch.randn(B, T, 3 * M, generator=g, device=cuda_device) * 0.5
    y = torch.rand(B, T, 1, generator=g, device=cuda_device) * 2 - 1
    y[0, :200], y[0, 200:400] = -1.0, 1.0
    weight = torch.rand(B, T, generator=g, device=cuda_device) + 0.5

    def grad(fn, dtype):
        h = head.detach().to(dtype).requires_grad_(True)
        logits, locs = h[..., :M], h[..., M : 2 * M].reshape(B, T, 1, M)
        log_scales = torch.clamp_min(h[..., 2 * M :].reshape(B, T, 1, M) * 4 - 3, -7.0)
        (fn(y.to(dtype), logits, locs, log_scales, num_bins=num_bins) * weight.to(dtype)).sum().backward()
        return h.grad.double()

    cuda.reset_launch_counts()
    got = grad(likelihoods.dmol_log_prob, torch.float32)
    assert cuda.launch_counts()["dmol_log_prob_bwd"] == 1
    twin = grad(likelihoods.discretized_logistic_mixture_ll, torch.float32)
    ref = grad(likelihoods.discretized_logistic_mixture_ll, torch.float64)
    flips = likelihoods.dmol_branch_flips(y, head[..., M : 2 * M].reshape(B, T, 1, M),
                                          torch.clamp_min(head[..., 2 * M :].reshape(B, T, 1, M) * 4 - 3, -7.0),
                                          num_bins)
    keep = ~flips[..., None]
    err_k, err_t = ((got - ref).abs() * keep).amax(), ((twin - ref).abs() * keep).amax()
    assert torch.isfinite(got).all() and err_k <= 2 * err_t + 1e-6, (err_k.item(), err_t.item())


@pytest.mark.cuda
def test_dmol_sampler_kernel_with_supplied_uniforms_equals_twin(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, T, M = 2, 3000, 10
    head = torch.randn(B, T, 3 * M, generator=g, device=cuda_device)
    logits, locs = head[..., :M], head[..., M : 2 * M].reshape(B, T, 1, M)  # strided, as the head gives them
    log_scales = torch.clamp_min(head[..., 2 * M :].reshape(B, T, 1, M) - 3, -7.0)
    uniforms = (torch.rand(B, T, M, generator=g, device=cuda_device), torch.rand(B, T, 1, generator=g, device=cuda_device))
    cuda.reset_launch_counts()
    sample, mode = variational.dmol_sample_and_mode(None, logits, locs, log_scales, uniforms=uniforms)
    assert cuda.launch_counts()["dmol_sample"] == 1
    ref = variational.rsample_discretized_logistic_mixture(None, logits, locs, log_scales, uniforms=uniforms)
    assert torch.equal(sample, ref) and torch.equal(mode, variational.dmol_mode(logits, locs))


@pytest.mark.cuda
def test_dmol_sampler_kernel_own_stream_by_distribution(cuda_device):
    """Component frequencies against softmax(logits) (chi-square, 9 dof, p = 1e-3)
    over 1M frames; a fresh generator state draws fresh numbers."""
    N, M = 1 << 20, 10
    logits = torch.tensor([0.5, -1.0, 2.0, 0.0, 1.0, -0.3, 0.7, -2.0, 1.5, 0.2], device=cuda_device)
    locs = (torch.arange(M, dtype=torch.float32, device=cuda_device) / 10).expand(N, 1, M).contiguous()
    log_scales = torch.full((N, 1, M), -9.0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    s1, _ = variational.dmol_sample_and_mode(gen, logits.expand(N, M).contiguous(), locs, log_scales)
    s2, _ = variational.dmol_sample_and_mode(gen, logits.expand(N, M).contiguous(), locs, log_scales)
    assert not torch.equal(s1, s2)
    counts = torch.bincount(torch.round(s1[:, 0] * 10).clamp(0, M - 1).long(), minlength=M).double()
    p = torch.softmax(logits.double(), 0)
    assert ((counts - N * p) ** 2 / (N * p)).sum().item() < 27.877


@pytest.mark.cuda
def test_training_through_the_kernels_has_gradients(cuda_device):
    """On CUDA tensors the loss carries a gradient through K1-bwd and K2-bwd (the
    forward kernels alone left it without one): the fused stacks forward (P2, one
    launch a stack), K1-bwd's warpgroup route (four kernels) a block backward."""
    model = WaveNet(n_layers=3, n_stacks=2, res_channels=96, num_mix=3, num_bins=256, bf16=True, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    x = torch.rand(2, 300, device=cuda_device) * 2 - 1
    cuda.reset_launch_counts()
    loss, _, _ = model(x, torch.tensor([300, 211], device=cuda_device))
    loss.backward()
    counts = cuda.launch_counts()
    assert counts["wavenet_stack"] == 2 and bwd_launches(counts) == {name: 6 for name in WG_BWD}
    assert counts["residual_glu"] == 0 and counts["dmol_log_prob"] == counts["dmol_log_prob_bwd"] == counts["dmol_sample"] == 1
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_wavenet_at_a_width_the_stack_kernel_does_not_take_trains_and_generates(cuda_device, bf16):
    """The driver's default --res_channels 64 is no width of the fused stack: the model keeps one K1 launch a block
    in the forward and the windowed generation, K1-bwd in the backward, and never calls the stack kernel."""
    model = WaveNet(n_layers=3, n_stacks=2, res_channels=64, num_mix=3, num_bins=256, bf16=bf16, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 1))
    assert not model.res_stack.fused
    x = torch.rand(2, 300, device=cuda_device) * 2 - 1
    cuda.reset_launch_counts()
    loss, _, _ = model(x, torch.tensor([300, 211], device=cuda_device))
    loss.backward()
    counts = cuda.launch_counts()
    assert counts["residual_glu"] == counts["residual_glu_bwd"] == 6 and counts["wavenet_stack"] == 0
    assert torch.isfinite(loss) and all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    cuda.reset_launch_counts()
    frames = model.generate(2, 4, fast=False, generator=torch.Generator(device=cuda_device).manual_seed(2))
    counts = cuda.launch_counts()
    assert frames.shape == (2, 4) and torch.isfinite(frames).all() and frames.abs().max() <= 1
    assert counts["residual_glu"] == 6 * 4 and counts["wavenet_stack"] == 0


@pytest.mark.cuda
def test_kernel_wrappers_refuse_targets_that_want_a_gradient(cuda_device):
    y = torch.zeros(4, 1, device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError):
        likelihoods.dmol_log_prob(y, torch.zeros(4, 2, device=cuda_device), torch.zeros(4, 1, 2, device=cuda_device),
                                  torch.zeros(4, 1, 2, device=cuda_device), num_bins=256)


def decode_case(device, C, bf16, n_frames, seed=0, B=2, n_stacks=2, **kwargs):
    """A WaveNet of ``n_stacks`` 10-block stacks at width ``C``, primed on a uniform-noise
    history, and its uniforms: ``(model, keys, x_last, pred0, tails)``."""
    model = WaveNet(n_layers=10, n_stacks=n_stacks, res_channels=C, num_mix=10, num_bins=2**16, bf16=bf16,
                    device=device, **kwargs)
    weights.load_jax_params(model, weights.random_jax_params(model, seed))
    g = torch.Generator(device=device).manual_seed(seed)
    uniforms = (torch.rand(n_frames, B, 10, generator=g, device=device), torch.rand(n_frames, B, 1, generator=g, device=device))
    keys = variational.FrameKeys(None, device, uniforms)
    x = torch.rand(B, model.receptive_field, 1, generator=g, device=device) * 2 - 1
    with torch.no_grad():
        tails, pred0 = model._prime(x, keys)
    return model, keys, x[:, -1:], pred0, tails


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("C", [96, 32])
def test_wavenet_decode_kernel_matches_plain_loop(cuda_device, C, bf16):
    """K4 with supplied uniforms against the plain loop fed the kernel's own frames
    (teacher forcing: each frame from the same history, so differences do not
    compound). f32: the order of the sums (1e-5). bf16: both round where JAX rounds;
    a one-ulp difference after a dot's other summation order, amplified by the gate,
    stays within the JAX suite's 5e-2. bf16 at C = 96 runs the resident route (one
    launch a generation), the rest the per-frame route (one a frame)."""
    n = 48
    model, keys, x_last, pred0, tails = decode_case(cuda_device, C, bf16, n)
    cuda.reset_launch_counts()
    with torch.no_grad():
        got = WaveNetDecoder(model, tails).run(x_last.reshape(-1), pred0.reshape(-1), n, keys)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        resident = bf16 and C == 96
        assert (counts["wavenet_decode_resident"], counts["wavenet_decode"]) == ((1, 0) if resident else (0, n - 1))
        ref = model._generate_fast_plain(x_last, pred0, tails, n, keys, forced=got)
    assert got.shape == (2, n) and torch.isfinite(got).all() and got.abs().max() <= 1
    torch.testing.assert_close(got, ref, rtol=0, atol=5e-2 if bf16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16,C,B", [(True, 96, 1), (True, 96, 2), (True, 96, 8), (False, 32, 2)])
def test_wavenet_decode_kernel_past_every_buffer_wrap(cuda_device, bf16, C, B):
    """K4 over 1100 frames of a 5 x 10-block WaveNet (dilations 1 .. 512, so every buffer wraps at least twice)
    against the plain loop fed the kernel's frames, at the tolerances above: the resident route (bf16, C = 96) at
    B = 1, 2 and 8, the per-frame route at C = 32 in f32. Two runs give the same bits."""
    n = 1100
    model, keys, x_last, pred0, tails = decode_case(cuda_device, C, bf16, n, B=B, n_stacks=5)
    with torch.no_grad():
        runs = [WaveNetDecoder(model, tails).run(x_last.reshape(-1), pred0.reshape(-1), n, keys) for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        ref = model._generate_fast_plain(x_last, pred0, tails, n, keys, forced=runs[0])
    assert runs[0].shape == (B, n) and torch.isfinite(runs[0]).all() and runs[0].abs().max() <= 1
    torch.testing.assert_close(runs[0], ref, rtol=0, atol=5e-2 if bf16 else 1e-5)


@pytest.mark.cuda
def test_wavenet_decode_resident_route_refuses_nine_rows_and_raises_on_a_timeout(cuda_device, monkeypatch):
    model, keys, x_last, pred0, tails = decode_case(cuda_device, 96, True, 8, B=9)
    with pytest.raises(ValueError):
        WaveNetDecoder(model, tails)
    model, keys, x_last, pred0, tails = decode_case(cuda_device, 96, True, 8)
    with monkeypatch.context() as patch, pytest.raises(RuntimeError, match="gave up"):
        patch.setattr(generation, "WAIT_LIMIT_NS", 1)  # a 1 ns wait limit: the first wait that must wait gives up
        WaveNetDecoder(model, tails).run(x_last.reshape(-1), pred0.reshape(-1), 8, keys)
    with torch.no_grad():  # the card is still usable
        got = WaveNetDecoder(model, tails).run(x_last.reshape(-1), pred0.reshape(-1), 8, keys)
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_wavenet_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    model, keys, x_last, pred0, tails = decode_case(cuda_device, 32, False, 8)
    with pytest.raises(ValueError):
        WaveNetDecoder(model, tails[:-1])  # a block without its buffer
    with pytest.raises(ValueError):
        WaveNetDecoder(model, [t[:, :1] for t in tails])  # buffers shorter than their dilation
    decoder = WaveNetDecoder(model, tails)
    with pytest.raises(ValueError):
        decoder.run(x_last.reshape(-1), pred0.reshape(-1), 9, keys)  # more frames than rows of uniforms
    for C, kwargs in ((264, {}), (8, dict(n_stack_frames=2))):  # C above the kernel's limit; two frames a step
        other = WaveNet(n_layers=2, n_stacks=1, res_channels=C, num_mix=2, device=cuda_device, **kwargs)
        with pytest.raises(ValueError):
            WaveNetDecoder(other, [torch.zeros(2, d, C, device=cuda_device) for d in (1, 2)])


@pytest.mark.cuda
def test_generate_on_the_card_launches_k4_and_matches_the_windowed_path(cuda_device):
    """One Philox key a generation, stepped by the frame: K4 and the windowed path (the
    stacks, P3, and K3 a frame) draw the same numbers for the same frame (f32, 1e-5)."""
    model, *_ = decode_case(cuda_device, 32, False, 1)
    cuda.reset_launch_counts()
    fast = model.generate(2, 12, generator=torch.Generator(device=cuda_device).manual_seed(4))
    counts = cuda.launch_counts()
    assert counts["wavenet_decode"] == 11 and counts["residual_glu"] == 20 and counts["dmol_sample"] == 1
    naive = model.generate(2, 12, fast=False, generator=torch.Generator(device=cuda_device).manual_seed(4))
    torch.testing.assert_close(fast, naive, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_dmol_rsample_on_the_card_runs_k3_and_refuses_a_gradient(cuda_device):
    head = DiscretizedLogisticMixtureDense(8, y_dim=1, num_mix=4, device=cuda_device)
    h = torch.randn(6, 8, device=cuda_device)
    cuda.reset_launch_counts()
    with torch.no_grad():
        sample = head.rsample(None, head(h))
    assert cuda.launch_counts()["dmol_sample"] == 1 and sample.shape == (6, 1)
    with pytest.raises(ValueError):
        head.rsample(None, head(h))  # the head's parameters want a gradient; K3 has none
    g = torch.Generator(device=cuda_device).manual_seed(0)
    u = (torch.rand(6, 4, generator=g, device=cuda_device), torch.rand(6, 1, generator=g, device=cuda_device))
    with torch.no_grad():
        params = head(h)
        assert torch.equal(head.rsample(None, params, uniforms=u),
                           variational.rsample_discretized_logistic_mixture(None, *params, uniforms=u))


def _k5_inputs(B, T, H, device, ragged=True, state=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    bound = 1 / math.sqrt(H)
    xw = torch.randn(B, T, 4 * H, generator=g) * 0.7
    w_hh, b_hh = ((torch.rand(*shape, generator=g) * 2 - 1) * bound for shape in ((H, 4 * H), (4 * H,)))
    lengths = torch.randint(1, T + 1, (B,), generator=g) if ragged else torch.full((B,), T)
    mask = (torch.arange(T)[None] < lengths[:, None]).float()
    h0, c0 = ((torch.randn(B, H, generator=g) * 0.5) if state else torch.zeros(B, H) for _ in range(2))
    return [t.to(device) for t in (xw, w_hh, b_hh, mask, h0, c0)]


K5_SHAPES = [
    (10, 120, 256, True, False),  # the benchmark's width, ragged
    (3, 50, 32, False, True),  # a small H, a given state
    (2, 1, 256, False, True),  # one step, as generation launches it
    (40, 30, 256, True, True),  # more sequences than resident clusters: several a cluster
    (5, 20, 8, True, False),  # the smallest H, one unit a CTA
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,ragged,state", K5_SHAPES)
def test_lstm_recurrence_kernel_matches_twin(cuda_device, dtype, B, T, H, ragged, state):
    """K5 against its twin. f32: the products' summation order only, free-running (1e-5).
    bf16: both round where JAX rounds, so one twin step from the kernel's carried state at
    every t (teacher forcing) differs only where the dots' order flips a rounding: within
    about two bf16 ulps (2^-9 absolute plus 2^-7 relative)."""
    a = _k5_inputs(B, T, H, cuda_device, ragged, state)
    a = [t if i == 3 else t.to(dtype) for i, t in enumerate(a)]
    cuda.reset_launch_counts()
    with torch.no_grad():
        got = recurrent.lstm_recurrence(*a)
        out, h_n, c_n, gates, h_prev, c_prev = recurrent._forward(*a, save=True)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["lstm_recurrence"] == 2
    assert all(torch.equal(x, y) for x, y in zip(got, (out, h_n, c_n)))
    xw, w_hh, b_hh, mask, _, _ = a
    if dtype == torch.float32:
        for x, y in zip(got, recurrent.lstm_recurrence_plain(*a)):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
    i, f, g, o = (xw + h_prev @ w_hh + b_hh).chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    m = mask.to(dtype)[..., None]
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=2.0**-9, rtol=2.0**-7)
    torch.testing.assert_close(gates.float(), torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                                                         torch.sigmoid(o)], dim=-1).float(), **tol)
    torch.testing.assert_close(out.float(), (h_new * m).float(), **tol)
    torch.testing.assert_close(c_n.float(), (m * c_new + (1 - m) * c_prev)[:, -1].float(), **tol)
    if ragged:
        assert not out[mask == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,ragged,state", K5_SHAPES)
def test_lstm_recurrence_backward_kernel_matches_autograd_of_twin(cuda_device, B, T, H, ragged, state):
    """K5-bwd (and the dW_hh, db_hh products) against autograd of the twin in f32, relative
    to each gradient's norm: the sums over T steps in another order (1e-5)."""
    a = _k5_inputs(B, T, H, cuda_device, ragged, state, seed=1)
    w_out = torch.randn(B, T, H, generator=torch.Generator().manual_seed(2)).to(cuda_device)

    def grads(fn):
        leaves = [t if i == 3 else t.detach().requires_grad_(True) for i, t in enumerate(a)]
        out, h_n, c_n = fn(*leaves)
        ((out * w_out).sum() + 0.3 * h_n.sum() - 0.7 * c_n.sum()).backward()
        return [leaves[i].grad for i in (0, 1, 2, 4, 5)]

    cuda.reset_launch_counts()
    got = grads(recurrent.lstm_recurrence)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["lstm_recurrence_bwd"] == 1
    for x, y in zip(got, grads(recurrent.lstm_recurrence_plain)):
        assert ((x - y).norm() / y.norm().clamp_min(1e-30)).item() <= 1e-5


@pytest.mark.cuda
def test_lstm_recurrence_kernel_refuses_what_it_does_not_take(cuda_device):
    a = _k5_inputs(2, 5, 264, cuda_device)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        recurrent.lstm_recurrence(*a)
    a = _k5_inputs(2, 5, 32, cuda_device)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        recurrent.lstm_recurrence(a[0].bfloat16(), *a[1:])
    with pytest.raises(ValueError, match="one CUDA device"):
        recurrent.lstm_recurrence(*a[:4], a[4].cpu(), a[5])


@pytest.mark.cuda
def test_lstm_audio_on_the_card_launches_k5(cuda_device):
    """A small LSTMAudio on the card: the forward launches K5 once a layer, the backward
    K5-bwd once a layer, a generation K5 once a stack a layer, and the forward's loss
    equals the plain path's."""
    model = LSTMAudio(stack_size=8, hidden_size=32, num_layers=2, num_mix=3, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    x = torch.rand(3, 200, generator=torch.Generator().manual_seed(0)).to(cuda_device) * 2 - 1
    x_sl = torch.tensor([200, 150, 61], device=cuda_device)
    cuda.reset_launch_counts()
    loss, _, _ = model(x, x_sl)
    loss.backward()
    counts = cuda.launch_counts()
    assert counts["lstm_recurrence"] == 2 and counts["lstm_recurrence_bwd"] == 2 and counts["dmol_log_prob_bwd"] == 1
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    with mock.patch.object(recurrent, "lstm_recurrence", recurrent.lstm_recurrence_plain), torch.no_grad():
        plain_loss, _, _ = model(x, x_sl)
    torch.testing.assert_close(loss.detach(), plain_loss, rtol=1e-5, atol=0)
    cuda.reset_launch_counts()
    (gen, _), _ = model.generate(2, 6, generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert gen.shape == (2, 48) and cuda.launch_counts()["lstm_recurrence"] == 12
    assert cuda.launch_counts()["dmol_sample"] == 6


# (B, T', X, H, Z, R, inference, residual_posterior, condition_h_on_x, use_mode)
K8_CASES = [
    (3, 20, 256, 256, 256, 512, True, True, True, False),  # the s=64 spec's width
    (11, 9, 16, 16, 4, 32, True, False, True, False),  # more rows than a stage's pass of 8
    (2, 16, 32, 32, 8, 64, True, True, False, False),  # GRUCell(phi) alone
    (2, 1, 256, 256, 256, 512, False, True, True, False),  # a generation step, sampled
    (2, 1, 256, 256, 256, 512, False, True, True, True),  # a generation step at the mode
    # widths that no grid divides evenly: 1-2 MLP units, 2-3 GRU units and 0-1 latent units a CTA
    (4, 12, 64, 200, 16, 300, True, True, True, False),
]


def _k8_inputs(B, T, X, H, Z, R, cond, device, seed=0, orthogonal=False):
    """K8's 28 weights (U(+-1/sqrt(fan_in)); ``w_hh`` orthogonal, ``W W^T = I``, as the VRNN's
    ``GRUCell`` draws it, under ``orthogonal``), x, h0 and the noise."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return (torch.rand(*shape, generator=g) * 2 - 1) / fan_in**0.5

    def mlp(d_in, n):
        out = []
        for i in range(n):
            fan = d_in if i == 0 else H
            out += [u(fan, H, fan_in=fan), u(H, fan_in=fan)]
        return out

    w = (mlp(R, 3) + [u(H, 2 * Z, fan_in=H), u(2 * Z, fan_in=H)] + mlp(R + X, 3) + [u(H, 2 * Z, fan_in=H),
                                                                                   u(2 * Z, fan_in=H)]
         + mlp(Z, 4) + [u(X + H if cond else H, 3 * R, fan_in=R), u(3 * R, fan_in=R), u(R, 3 * R, fan_in=R),
                        u(3 * R, fan_in=R)])
    if orthogonal:
        q, r = torch.linalg.qr(torch.randn(3 * R, R, generator=g, dtype=torch.float64))
        w[26] = (q * torch.sign(torch.diagonal(r))).T.float()
    x = torch.randn(B, T, X, generator=g) * 0.5
    h0 = torch.randn(B, R, generator=g) * 0.3
    eps = torch.randn(B, T, Z, generator=g)
    return [t.to(device) for t in w], x.to(device), h0.to(device), eps.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,X,H,Z,R,inference,residual,cond,use_mode", K8_CASES)
def test_vrnn_cell_kernel_matches_twin(cuda_device, B, T, X, H, Z, R, inference, residual, cond, use_mode):
    """K8 against its twin, free-running over every step in f32: the products' summation
    order only (the chain does not amplify it), 1e-5 absolute plus 1e-5 relative."""
    _k8_against_twin(cuda_device, B, T, X, H, Z, R, inference, residual, cond, use_mode)


# the VRNN's GRU w_hh as the model has it (orthogonal): the spec width over 200 steps, uneven widths
# over 12, a generation step
K8_ORTHOGONAL_CASES = [
    (3, 200, 256, 256, 256, 512, True, True, True, False),
    (4, 12, 64, 200, 16, 300, True, True, True, False),
    (2, 1, 256, 256, 256, 512, False, True, True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,X,H,Z,R,inference,residual,cond,use_mode", K8_ORTHOGONAL_CASES)
def test_vrnn_cell_kernel_matches_twin_with_orthogonal_w_hh(cuda_device, B, T, X, H, Z, R, inference, residual, cond,
                                                            use_mode):
    """K8 against its twin with an orthogonal ``w_hh``, at the same tolerance."""
    _k8_against_twin(cuda_device, B, T, X, H, Z, R, inference, residual, cond, use_mode, orthogonal=True)


def _k8_against_twin(cuda_device, B, T, X, H, Z, R, inference, residual, cond, use_mode, orthogonal=False):
    w, x, h0, eps = _k8_inputs(B, T, X, H, Z, R, cond, cuda_device, orthogonal=orthogonal)
    kwargs = dict(inference=inference, residual_posterior=residual, condition_h_on_x=cond, use_mode=use_mode,
                  sd_beta=0.6931478, sd_epsilon=1e-6)
    cuda.reset_launch_counts()
    with torch.no_grad():
        got = vrnn_ops.vrnn_cell(w, x, h0, eps, **kwargs)
        torch.cuda.synchronize()
        assert cuda.launch_counts()["vrnn_cell"] == 1
        ref = vrnn_ops.vrnn_cell_plain(w, x, h0, eps, **kwargs)
    for name, a, b in zip(got._fields, got, ref):
        if b is None:
            assert a is None and not inference
            continue
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.cuda
def test_vrnn_cell_kernel_trace_accounts_for_the_loop(cuda_device):
    """The kernel's trace: the same outputs with it as without; its phases, non-negative, sum to
    the loop's cycles but for the few outside any phase."""
    w, x, h0, eps = _k8_inputs(3, 30, 64, 64, 16, 128, True, cuda_device)
    kwargs = dict(inference=True, residual_posterior=True, condition_h_on_x=True, sd_beta=0.6931478,
                  sd_epsilon=1e-6)
    trace = torch.zeros(vrnn_ops.trace_size(), dtype=torch.int64, device=cuda_device)
    with torch.no_grad():
        plain = vrnn_ops.vrnn_cell(w, x, h0, eps, **kwargs)
        traced = vrnn_ops.vrnn_cell(w, x, h0, eps, trace=trace, **kwargs)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    cycles = trace.cpu()
    assert (cycles >= 0).all() and 0.95 * cycles[-2] <= cycles[:-2].sum() <= cycles[-2] and cycles[-1] > 0
    assert vrnn_ops.read_trace(trace).shape == (9, 4)


@pytest.mark.cuda
def test_vrnn_cell_kernel_refuses_what_it_does_not_take(cuda_device):
    w, x, h0, eps = _k8_inputs(2, 3, 32, 32, 8, 64, True, cuda_device)
    kwargs = dict(inference=True, residual_posterior=True, condition_h_on_x=True, sd_beta=0.6931478,
                  sd_epsilon=1e-6)
    cuda.reset_launch_counts()
    got = _cell_input_grads(vrnn_ops.vrnn_cell, w, x, h0, eps, kwargs)
    counts = cuda.launch_counts()
    assert (counts["vrnn_cell"], counts["vrnn_cell_bwd"]) == (1, 1)
    for a, b in zip(got, _cell_input_grads(vrnn_ops.vrnn_cell_plain, w, x, h0, eps, kwargs)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="inference mode only"):
        vrnn_ops.vrnn_cell(w, x.requires_grad_(True), h0, eps, **dict(kwargs, inference=False))
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            vrnn_ops.vrnn_cell(w, x.double(), h0, eps, **kwargs)
        with pytest.raises(ValueError, match="eps"):
            vrnn_ops.vrnn_cell(w, x, h0, eps[:, :2], **kwargs)
        # at the spec's width each CTA keeps B x 12 floats of h W_hh in shared memory beside its ~70 KB
        # of weights and 32 KB of staged inputs: 4096 rows (192 KB more) overflow the 227 KB a CTA can have
        w, x, h0, eps = _k8_inputs(4096, 1, 256, 256, 256, 512, True, cuda_device)
        with pytest.raises(RuntimeError, match="do not fit"):
            vrnn_ops.vrnn_cell(w, x, h0, eps, **kwargs)


@pytest.mark.cuda
def test_vrnn_audio_on_the_card_launches_k8(cuda_device):
    """A small VRNNAudio on the card: a forward launches K8, K2 and K3 once each and its loss
    equals the plain path's (same noise); a generation launches K8 and K3 once a stack; a
    forward with a gradient launches K8 (save mode) and its backward K8-bwd once each, and
    the gradients match the plain path's (relative norm 1e-4: f32 sums in another order
    through 25 steps of the chain)."""
    model = VRNNAudio(input_size=8, hidden_size=32, latent_size=8, residual_posterior=True, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    x = torch.rand(3, 200, generator=torch.Generator().manual_seed(0)).to(cuda_device) * 2 - 1
    x_sl = torch.tensor([200, 150, 61], device=cuda_device)
    eps = torch.randn(3, 25, 8, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    cuda.reset_launch_counts()
    with torch.no_grad():
        loss, _, out = model(x, x_sl, eps=eps)
        counts = cuda.launch_counts()
        with mock.patch.object(vrnn_ops, "vrnn_cell", vrnn_ops.vrnn_cell_plain):
            plain_loss, _, plain_out = model(x, x_sl, eps=eps)
    assert (counts["vrnn_cell"], counts["dmol_log_prob"], counts["dmol_sample"]) == (1, 1, 1)
    torch.testing.assert_close(loss, plain_loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(out.h_n, plain_out.h_n, rtol=1e-5, atol=1e-5)
    grads = {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        cuda.reset_launch_counts()
        with mock.patch.object(vrnn_ops, "vrnn_cell", vrnn_ops.vrnn_cell_plain if path == "plain" else vrnn_ops.vrnn_cell):
            model(x, x_sl, eps=eps)[0].backward()
        counts = cuda.launch_counts()
        assert (counts["vrnn_cell"], counts["vrnn_cell_bwd"]) == ((1, 1) if path == "kernel" else (0, 0))
        grads[path] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for n, g in grads["plain"].items():
        assert ((grads["kernel"][n] - g).norm() / g.norm().clamp_min(1e-30)).item() <= 1e-4, n
    cuda.reset_launch_counts()
    (gen, _), _ = model.generate(2, 6, generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert gen.shape == (2, 48, 1) and torch.isfinite(gen).all()
    assert cuda.launch_counts()["vrnn_cell"] == 6 and cuda.launch_counts()["dmol_sample"] == 6


def _cell_input_grads(fn, w, x, h0, eps, kwargs):
    """The gradients of ``sum(outputs * g)`` (g fixed, from a seed) by the 28 weights, x and h0."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (*w, x, h0)]
    outs = fn(leaves[:-2], leaves[-2], leaves[-1], eps, **kwargs)
    g = torch.Generator(device=x.device).manual_seed(7)
    loss = sum((o * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs if o is not None)
    return torch.autograd.grad(loss, leaves)


def _chain_grads(w, x, h0, eps, g_out, dtype, residual, cond, kernel):
    """At K8-bwd's boundary: the gradients of ``sum(outputs * g_out)`` by xpost, xg (None
    without ``condition_h_on_x``), h0 and the 28 kernel weights, through ``VRNNCellFunction``
    (the kernels) or autograd of the plain chain, in ``dtype``."""
    kw = [t.to(dtype) for t in w]
    xpost, xg, kernel_weights = vrnn_ops.hoist(kw, x.to(dtype), True, cond)
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in (xpost, xg, h0.to(dtype), *kernel_weights)]
    args = dict(residual_posterior=residual, sd_beta=0.6931478, sd_epsilon=1e-6)
    if kernel:
        outs = vrnn_ops.VRNNCellFunction.apply(residual, 0.6931478, 1e-6, leaves[0], leaves[1], leaves[2],
                                               eps.to(dtype), *leaves[3:])
    else:
        outs = vrnn_ops.vrnn_chain_plain(leaves[3:], leaves[0], leaves[1], leaves[2], eps.to(dtype), inference=True,
                                         **args)[0]
    loss = sum((o * g.to(dtype)).sum() for o, g in zip(outs, g_out))
    live = [t for t in leaves if t is not None]
    return [None if t is None else gr for t, gr in zip(leaves, _fill(torch.autograd.grad(loss, live), leaves))]


def _fill(grads, leaves):
    it = iter(grads)
    return [None if t is None else next(it) for t in leaves]


# (B, T', residual_posterior, condition_h_on_x) at uneven widths (X = 64, H = 200, R = 300, Z = 16)
K8_BWD_CASES = [(1, 24, True, True), (8, 24, True, True), (19, 24, True, True), (8, 16, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,residual,cond", K8_BWD_CASES)
def test_vrnn_cell_bwd_kernel_matches_f64_twin(cuda_device, B, T, residual, cond):
    """K8-bwd (through ``VRNNCellFunction``: K8 in save mode, one K8-bwd launch, the weight
    gradients) and autograd of the f32 twin, both against autograd of the f64 twin, with an
    orthogonal ``w_hh``: every gradient's largest error, relative to its largest value, no more
    than twice the f32 twin's plus 1e-6 (about 16 f32 ulps of the largest value: where the twin
    happens to round as f64 does, the kernel's other summation order still costs a few ulps)."""
    X, H, Z, R = 64, 200, 16, 300
    w, x, h0, eps = _k8_inputs(B, T, X, H, Z, R, cond, cuda_device, seed=B, orthogonal=True)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    g_out = [torch.randn(B, T, n, generator=g, device=cuda_device) for n in (R, Z, H, Z, Z, Z, Z)]
    cuda.reset_launch_counts()
    got = _chain_grads(w, x, h0, eps, g_out, torch.float32, residual, cond, kernel=True)
    counts = cuda.launch_counts()
    assert (counts["vrnn_cell"], counts["vrnn_cell_bwd"]) == (1, 1)
    twin = _chain_grads(w, x, h0, eps, g_out, torch.float32, residual, cond, kernel=False)
    ref = _chain_grads(w, x, h0, eps, g_out, torch.float64, residual, cond, kernel=False)
    assert (got[1] is None) == (not cond)
    for i, (a, b, r) in enumerate(zip(got, twin, ref)):
        if r is None:
            continue
        scale = r.abs().max().clamp_min(1e-30)
        err_k, err_t = ((a.double() - r).abs().max() / scale).item(), ((b.double() - r).abs().max() / scale).item()
        assert torch.isfinite(a).all() and err_k <= 2 * err_t + 1e-6, (i, err_k, err_t)


@pytest.mark.cuda
def test_free_nats_takes_a_host_budget_on_the_card(cuda_device):
    """``discount_free_nats`` on a CUDA KL with the budget a float32 host scalar (as the train step's
    annealers hand it over): the budget stays on the host (no copy to the card), the values are
    ``max(kld, budget)`` and a tie's gradient is split 0.5/0.5, as on the CPU."""
    kld = torch.tensor([[[0.1, 0.25, 0.4, 0.25]]], device=cuda_device, requires_grad=True)
    out = variational.discount_free_nats(kld, torch.tensor(1.0), shared_dims=-1)
    out.sum().backward()
    torch.testing.assert_close(out.detach().cpu(), torch.tensor([[[0.25, 0.25, 0.4, 0.25]]]))
    torch.testing.assert_close(kld.grad.cpu(), torch.tensor([[[0.0, 0.5, 1.0, 0.5]]]))


# (B, T, H, mask, a given h0): the SRNN test pass's width with its d GRU's mask and its a GRU's flipped one,
# more rows than a pass of 8 over uneven parts, H = 32 with a zero-length row, a generation step
K7_CASES = [
    (6, 200, 512, "ragged", False),
    (6, 200, 512, "flipped", True),
    (11, 30, 300, "flipped", True),
    (3, 40, 32, "ragged", True),
    (2, 1, 512, None, True),
]


def _k7_inputs(B, T, H, mask, given, device, seed=0):
    """xw, W_hh, b_hh (U(+-1/sqrt(H)) as the GRU draws them), the mask (row 0 full, the last row of
    length 0 where B > 2, the others ragged; flipped: its zeros leading) and h0."""
    g = torch.Generator().manual_seed(seed)
    bound = H**-0.5
    w_hh, b_hh = ((torch.rand(*s, generator=g) * 2 - 1) * bound for s in ((H, 3 * H), (3 * H,)))
    xw = torch.randn(B, T, 3 * H, generator=g) * 0.5
    m = None
    if mask is not None:
        lengths = torch.randint(1, T + 1, (B,), generator=g)
        lengths[0] = T
        if B > 2:
            lengths[-1] = 0
        m = (torch.arange(T)[None, :] < lengths[:, None]).float()
        m = m.flip(1) if mask == "flipped" else m
    h0 = torch.randn(B, H, generator=g) * 0.3 if given else torch.zeros(B, H)
    return [None if t is None else t.to(device) for t in (xw, w_hh, b_hh, m, h0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,mask,given", K7_CASES)
def test_gru_recurrence_kernel_matches_twin(cuda_device, B, T, H, mask, given):
    """K7 against its twin, free-running over every step in f32: the products' summation order
    only (the chain does not amplify it), 1e-5 absolute plus 1e-5 relative; a row masked
    throughout keeps h0 and outputs zeros."""
    xw, w_hh, b_hh, m, h0 = _k7_inputs(B, T, H, mask, given, cuda_device)
    cuda.reset_launch_counts()
    with torch.no_grad():
        out, h_n = recurrent.gru_recurrence(xw, w_hh, b_hh, m, h0)
        torch.cuda.synchronize()
        assert cuda.launch_counts()["gru_recurrence"] == 1
        ref_out, ref_h_n = recurrent.gru_recurrence_plain(xw, w_hh, b_hh, m, h0)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h_n, ref_h_n, atol=1e-5, rtol=1e-5)
    if m is not None and B > 2:
        assert torch.equal(h_n[-1], h0[-1]) and not out[-1].any()


@pytest.mark.cuda
def test_gru_recurrence_kernel_refuses_what_it_does_not_take(cuda_device):
    xw, w_hh, b_hh, m, h0 = _k7_inputs(2, 3, 32, "ragged", True, cuda_device)
    with torch.no_grad():
        _, _, saved = recurrent.gru_recurrence_save(xw, w_hh, b_hh, m, h0)
        with pytest.raises(ValueError, match="save buffer"):
            recurrent.gru_recurrence_backward(w_hh, m, saved[..., :-1], None, None)
        with pytest.raises(ValueError, match="float32"):
            recurrent.gru_recurrence_backward(w_hh.double(), m, saved, None, None)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            recurrent.gru_recurrence(xw.double(), w_hh, b_hh, m, h0)
        with pytest.raises(ValueError, match="h0"):
            recurrent.gru_recurrence(xw, w_hh, b_hh, m, h0[:1])
        # a CTA keeps the r, z, n columns of its ~H/132 units (3 H^2 / 132 floats): at H = 2048, 16 units
        # a CTA, 384 KB, more than the 227 KB a CTA can have
        xw, w_hh, b_hh, m, h0 = _k7_inputs(1, 1, 2048, None, False, cuda_device)
        with pytest.raises(RuntimeError, match="does not fit"):
            recurrent.gru_recurrence(xw, w_hh, b_hh, m, h0)


# (B, T', H, Z, inference, residual_posterior, use_mode)
K9_CASES = [
    (6, 100, 256, 256, True, True, False),  # the s=64 z=256 spec's width
    (6, 50, 256, 256, True, False, False),
    (11, 9, 16, 4, True, True, False),  # more rows than a stage's pass of 8
    (4, 12, 200, 16, True, True, False),  # widths that no grid divides evenly
    (2, 1, 256, 256, False, True, False),  # a generation step, sampled
    (2, 1, 256, 256, False, True, True),  # a generation step at the mode
    (2, 64, 256, 256, False, True, False),  # a prior rollout of 64 steps
]


def _k9_inputs(B, T, H, Z, device, seed=0):
    """K9's 14 kernel weights (U(+-1/sqrt(fan_in)), the first layers' fan-in R + Z with R = 2H),
    the hoisted xp and xq, z0 and the noise."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return (torch.rand(*shape, generator=g) * 2 - 1) / fan_in**0.5

    def net():
        fan = 2 * H + Z
        return [u(Z, H, fan_in=fan), u(H, H, fan_in=H), u(H, fan_in=H), u(H, H, fan_in=H), u(H, fan_in=H),
                u(H, 2 * Z, fan_in=H), u(2 * Z, fan_in=H)]

    w = net() + net()
    xp, xq = (torch.randn(B, T, H, generator=g) * 0.5 for _ in range(2))
    z0 = torch.randn(B, Z, generator=g) * 0.5
    eps = torch.randn(B, T, Z, generator=g)
    return [t.to(device) for t in w], xp.to(device), xq.to(device), z0.to(device), eps.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Z,inference,residual,use_mode", K9_CASES)
def test_srnn_chain_kernel_matches_twin(cuda_device, B, T, H, Z, inference, residual, use_mode):
    """K9 against its twin, free-running over every step in f32: 1e-5 absolute plus 1e-5
    relative (the products' summation order only)."""
    w, xp, xq, z0, eps = _k9_inputs(B, T, H, Z, cuda_device)
    kwargs = dict(inference=inference, residual_posterior=residual, use_mode=use_mode, sd_beta=0.6931478,
                  sd_epsilon=1e-6)
    xq = xq if inference else None
    eps = None if use_mode else eps
    cuda.reset_launch_counts()
    with torch.no_grad():
        got = srnn_ops.srnn_chain(w, xp, xq, z0, eps, **kwargs)
        torch.cuda.synchronize()
        assert cuda.launch_counts()["srnn_chain"] == 1
        ref = srnn_ops.srnn_chain_plain(w, xp, xq, z0, eps, **kwargs)
    for name, a, b in zip(got._fields, got, ref):
        if b is None:
            assert a is None and not inference
            continue
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.cuda
def test_srnn_chain_kernel_trace_and_refusals(cuda_device):
    """The same outputs with the trace as without, its phases summing to the loop's cycles but for
    the few outside any phase; a gradient, float64 and a wrong noise shape raise."""
    w, xp, xq, z0, eps = _k9_inputs(3, 30, 64, 16, cuda_device)
    kwargs = dict(inference=True, residual_posterior=True, sd_beta=0.6931478, sd_epsilon=1e-6)
    trace = torch.zeros(srnn_ops.trace_size(), dtype=torch.int64, device=cuda_device)
    with torch.no_grad():
        plain = srnn_ops.srnn_chain(w, xp, xq, z0, eps, **kwargs)
        traced = srnn_ops.srnn_chain(w, xp, xq, z0, eps, trace=trace, **kwargs)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    cycles = trace.cpu()
    assert (cycles >= 0).all() and 0.95 * cycles[-2] <= cycles[:-2].sum() <= cycles[-2] and cycles[-1] > 0
    assert srnn_ops.read_trace(trace).shape == (4, 4)
    with pytest.raises(NotImplementedError, match="inference mode only"):
        srnn_ops.srnn_chain(w, xp.requires_grad_(True), None, z0, eps, **dict(kwargs, inference=False))
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            srnn_ops.srnn_chain(w, xp.double(), xq, z0, eps, **kwargs)
        with pytest.raises(ValueError, match="eps"):
            srnn_ops.srnn_chain(w, xp, xq, z0, eps[:, :2], **kwargs)


@pytest.mark.cuda
def test_srnn_audio_on_the_card_launches_k7_and_k9(cuda_device):
    """A small SRNNAudio on the card: a forward launches K7 twice (the d and a GRUs), K9, K2 and K3
    once each, and its loss equals the plain path's (same noise); a forward with a gradient launches
    K7 (save mode) twice and K9 (save mode) once, its backward K7-bwd twice and K9-bwd once, and the
    gradients match the plain path's (relative norm 1e-4: f32 sums in another order through 25 steps
    of three chains); a generation launches K7, K9 and K3 once a stack."""
    model = SRNNAudio(input_size=8, hidden_size=32, latent_size=8, residual_posterior=True, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    x = torch.rand(3, 200, generator=torch.Generator().manual_seed(0)).to(cuda_device) * 2 - 1
    x_sl = torch.tensor([200, 150, 61], device=cuda_device)
    eps = torch.randn(3, 25, 8, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    cuda.reset_launch_counts()
    with torch.no_grad():
        loss, _, out = model(x, x_sl, eps=eps)
        counts = cuda.launch_counts()
        with mock.patch.object(srnn_ops, "srnn_chain", srnn_ops.srnn_chain_plain), \
                mock.patch.object(recurrent, "gru_recurrence", recurrent.gru_recurrence_plain):
            plain_loss, _, plain_out = model(x, x_sl, eps=eps)
    assert (counts["gru_recurrence"], counts["srnn_chain"], counts["dmol_log_prob"], counts["dmol_sample"]) == (2, 1, 1, 1)
    torch.testing.assert_close(loss, plain_loss, rtol=1e-5, atol=0)
    for name in ("d_n", "a_n", "z_n"):
        torch.testing.assert_close(getattr(out, name), getattr(plain_out, name), rtol=1e-5, atol=1e-5, msg=name)
    grads = {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        cuda.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if path == "plain":
                stack.enter_context(mock.patch.object(srnn_ops, "srnn_chain", srnn_ops.srnn_chain_plain))
                stack.enter_context(mock.patch.object(recurrent, "gru_recurrence", recurrent.gru_recurrence_plain))
            model(x, x_sl, eps=eps)[0].backward()
        counts = cuda.launch_counts()
        launched = tuple(counts[k] for k in ("gru_recurrence", "gru_recurrence_bwd", "srnn_chain", "srnn_chain_bwd"))
        assert launched == ((2, 2, 1, 1) if path == "kernel" else (0, 0, 0, 0)), (path, counts)
        grads[path] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for n, g in grads["plain"].items():
        assert ((grads["kernel"][n] - g).norm() / g.norm().clamp_min(1e-30)).item() <= 1e-4, n
    cuda.reset_launch_counts()
    (gen, _), _ = model.generate(2, 6, generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert gen.shape == (2, 48, 1) and torch.isfinite(gen).all()
    counts = cuda.launch_counts()
    assert (counts["gru_recurrence"], counts["srnn_chain"], counts["dmol_sample"]) == (6, 6, 6)


def _held_to_f64(got, twin, ref):
    """Each gradient's largest error, relative to its largest value: the kernels' no more than twice
    the f32 twin's plus 1e-6 (about 16 f32 ulps of the largest value: where the twin happens to round
    as f64 does, the kernel's other summation order still costs a few ulps), as K8-bwd is held."""
    for i, (a, b, r) in enumerate(zip(got, twin, ref)):
        scale = r.abs().max().clamp_min(1e-30)
        err_k, err_t = ((a.double() - r).abs().max() / scale).item(), ((b.double() - r).abs().max() / scale).item()
        assert torch.isfinite(a).all() and err_k <= 2 * err_t + 1e-6, (i, err_k, err_t)


def _k7_grads(xw, w_hh, b_hh, m, h0, g_out, dtype, kernel):
    """The gradients of ``sum(out * g_out[0]) + sum(h_n * g_out[1])`` by xw, w_hh, b_hh and h0:
    through ``gru_recurrence`` (K7 in save mode and K7-bwd) or autograd of the twin in ``dtype``."""
    leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in (xw, w_hh, b_hh, h0)]
    fn = recurrent.gru_recurrence if kernel else recurrent.gru_recurrence_plain
    outs = fn(leaves[0], leaves[1], leaves[2], None if m is None else m.to(dtype), leaves[3])
    return torch.autograd.grad(sum((o * g.to(dtype)).sum() for o, g in zip(outs, g_out)), leaves)


# (B, T, H, mask, a given h0): the SRNN train step's width with the d GRU's mask and the a GRU's flipped one,
# uneven parts over more rows than a pass of 8, a single row without a mask
K7_BWD_CASES = [
    (19, 40, 512, "ragged", False),
    (19, 40, 512, "flipped", True),
    (11, 30, 200, "flipped", True),
    (1, 25, 512, None, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,mask,given", K7_BWD_CASES)
def test_gru_recurrence_bwd_kernel_matches_f64_twin(cuda_device, B, T, H, mask, given):
    """K7-bwd (through ``GRURecurrenceFunction``: K7 in save mode, one K7-bwd launch, the weight
    gradients) and autograd of the f32 twin, both against autograd of the f64 twin, with a random
    gradient of ``h_n``."""
    xw, w_hh, b_hh, m, h0 = _k7_inputs(B, T, H, mask, given, cuda_device, seed=B)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    g_out = [torch.randn(B, T, H, generator=g, device=cuda_device), torch.randn(B, H, generator=g, device=cuda_device)]
    cuda.reset_launch_counts()
    got = _k7_grads(xw, w_hh, b_hh, m, h0, g_out, torch.float32, kernel=True)
    counts = cuda.launch_counts()
    assert (counts["gru_recurrence"], counts["gru_recurrence_bwd"]) == (1, 1)
    twin = _k7_grads(xw, w_hh, b_hh, m, h0, g_out, torch.float32, kernel=False)
    ref = _k7_grads(xw, w_hh, b_hh, m, h0, g_out, torch.float64, kernel=False)
    _held_to_f64(got, twin, ref)


@pytest.mark.cuda
def test_gru_and_srnn_chain_save_modes_keep_the_outputs(cuda_device):
    """K7 and K9 in save mode: the same output bits as without, and saved values equal to their
    twins' (the products' summation order only: 1e-5 absolute plus 1e-5 relative)."""
    xw, w_hh, b_hh, m, h0 = _k7_inputs(11, 30, 200, "flipped", True, cuda_device)
    with torch.no_grad():
        plain = recurrent.gru_recurrence(xw, w_hh, b_hh, m, h0)
        out, h_n, saved = recurrent.gru_recurrence_save(xw, w_hh, b_hh, m, h0)
        ref = recurrent._gru_chain_plain(xw, w_hh, b_hh, m, h0, save=True)
    assert torch.equal(out, plain[0]) and torch.equal(h_n, plain[1])
    torch.testing.assert_close(saved, ref[2], atol=1e-5, rtol=1e-5)
    w, xp, xq, z0, eps = _k9_inputs(11, 9, 200, 16, cuda_device)
    kwargs = dict(residual_posterior=True, sd_beta=0.6931478, sd_epsilon=1e-6)
    with torch.no_grad():
        plain = srnn_ops.srnn_chain(w, xp, xq, z0, eps, inference=True, **kwargs)
        outs, saved = srnn_ops.srnn_chain_save(w, xp, xq, z0, eps, **kwargs)
        ref = srnn_ops._chain_plain(w, xp, xq, z0, eps, inference=True, use_mode=False, save=True, **kwargs)
    assert all(torch.equal(a, b) for a, b in zip(outs, plain))
    torch.testing.assert_close(saved, ref[1], atol=1e-5, rtol=1e-5)


def _k9_grads(w, xp, xq, z0, eps, g_out, dtype, residual, kernel):
    """The gradients of ``sum(outputs * g_out)`` (an output whose ``g_out`` is None left out) by xp,
    xq, z0 and the 14 kernel weights: through ``srnn_chain`` (K9 in save mode and K9-bwd) or
    autograd of the twin in ``dtype``."""
    leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in (xp, xq, z0, *w)]
    fn = srnn_ops.srnn_chain if kernel else srnn_ops.srnn_chain_plain
    outs = fn(leaves[3:], leaves[0], leaves[1], leaves[2], eps.to(dtype), inference=True, residual_posterior=residual,
              sd_beta=0.6931478, sd_epsilon=1e-6)
    return torch.autograd.grad(sum((o * g.to(dtype)).sum() for o, g in zip(outs, g_out) if g is not None), leaves)


# (B, T', H, Z, residual_posterior, the outputs without a gradient): the spec's width at the train step's
# rows, uneven widths over more rows than a pass of 8, a single row
K9_BWD_CASES = [
    (19, 30, 256, 256, True, ()),
    (19, 20, 256, 256, False, ()),
    (11, 9, 200, 16, True, (0, 2)),
    (1, 24, 64, 16, True, (1, 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Z,residual,no_grad", K9_BWD_CASES)
def test_srnn_chain_bwd_kernel_matches_f64_twin(cuda_device, B, T, H, Z, residual, no_grad):
    """K9-bwd (through ``SRNNChainFunction``: K9 in save mode, one K9-bwd launch, the weight
    gradients) and autograd of the f32 twin, both against autograd of the f64 twin; outputs
    without a gradient reach the kernel as null pointers."""
    w, xp, xq, z0, eps = _k9_inputs(B, T, H, Z, cuda_device, seed=B)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    g_out = [None if i in no_grad else torch.randn(B, T, Z, generator=g, device=cuda_device) for i in range(5)]
    cuda.reset_launch_counts()
    got = _k9_grads(w, xp, xq, z0, eps, g_out, torch.float32, residual, kernel=True)
    counts = cuda.launch_counts()
    assert (counts["srnn_chain"], counts["srnn_chain_bwd"]) == (1, 1)
    twin = _k9_grads(w, xp, xq, z0, eps, g_out, torch.float32, residual, kernel=False)
    ref = _k9_grads(w, xp, xq, z0, eps, g_out, torch.float64, residual, kernel=False)
    _held_to_f64(got, twin, ref)


@pytest.mark.cuda
def test_gru_and_srnn_chain_bwd_traces_account_for_the_loop(cuda_device):
    """K7-bwd's and K9-bwd's traces: the same gradients with the trace as without, the phases summing
    to the loop's cycles but for the few outside any phase."""
    xw, w_hh, b_hh, m, h0 = _k7_inputs(11, 30, 200, "flipped", True, cuda_device)
    w, xp, xq, z0, eps = _k9_inputs(11, 9, 200, 16, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    with torch.no_grad():
        _, _, saved7 = recurrent.gru_recurrence_save(xw, w_hh, b_hh, m, h0)
        d_out = torch.randn(11, 30, 200, generator=g, device=cuda_device)
        kw = dict(residual_posterior=True, sd_beta=0.6931478)
        outs, saved9 = srnn_ops.srnn_chain_save(w, xp, xq, z0, eps, sd_epsilon=1e-6, **kw)
        grads9 = [torch.randn(o.shape, generator=g, device=cuda_device) for o in outs]
        for size, run in ((recurrent.gru_bwd_trace_size(),
                           lambda tr: recurrent.gru_recurrence_backward(w_hh, m, saved7, d_out, None, trace=tr)),
                          (srnn_ops.trace_size(),
                           lambda tr: srnn_ops.srnn_chain_backward(w, eps, saved9, grads9, trace=tr, **kw))):
            trace = torch.zeros(size, dtype=torch.int64, device=cuda_device)
            assert all(torch.equal(a, b) for a, b in zip(run(None), run(trace)))
            cycles = trace.cpu()
            assert (cycles >= 0).all() and 0.95 * cycles[-2] <= cycles[:-2].sum() <= cycles[-2] and cycles[-1] > 0


# B, T', H, Z, inference, residual, precision, use_mode, resets every n steps (0: none)
K10_CASES = [
    (5, 300, 192, 128, True, False, True, False, 0),  # the :33 width, the precision-weighted posterior
    (3, 40, 96, 96, True, True, False, False, 16),  # the default width 96, residual, with resets
    (11, 25, 64, 8, True, False, False, False, 4),  # two passes of 8 rows, a plain posterior, resets
    (2, 64, 192, 128, False, False, True, False, 0),  # a prior rollout, sampled
    (2, 10, 192, 128, False, False, True, True, 0),  # a prior rollout at the mode
]


def _k10_inputs(B, T, H, Z, device, seed=0):
    """K10's 20 kernel weights (U(+-1/sqrt(fan_in))), the hoisted xg and xq, z0, h0 and the noise."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return (torch.rand(*shape, generator=g) * 2 - 1) / fan_in**0.5

    w = [u(Z, H, fan_in=Z), u(H, 3 * H, fan_in=H), u(3 * H, fan_in=H), u(H, 3 * H, fan_in=H), u(3 * H, fan_in=H)]
    for first in (True, False):
        layers = [t for _ in range(3) for t in (u(H, H, fan_in=H), u(H, fan_in=H))]
        if not first:
            del layers[1]  # the posterior's first bias is in xq
        w += layers + [u(H, 2 * Z, fan_in=H), u(2 * Z, fan_in=H)]
    xg, xq = (torch.randn(B, T, H, generator=g) * 0.5 for _ in range(2))
    z0, h0 = torch.randn(B, Z, generator=g) * 0.5, torch.randn(B, H, generator=g) * 0.5
    eps = torch.randn(B, T, Z, generator=g)
    return [t.to(device) for t in w], xg.to(device), xq.to(device), z0.to(device), h0.to(device), eps.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Z,inference,residual,precision,use_mode,every", K10_CASES)
def test_rssm_chain_kernel_matches_twin(cuda_device, B, T, H, Z, inference, residual, precision, use_mode, every):
    """K10 against its twin, free-running over every step in f32: 1e-4 absolute plus 1e-5 relative (the products'
    summation order, re-entering the chain every step), one launch."""
    w, xg, xq, z0, h0, eps = _k10_inputs(B, T, H, Z, cuda_device)
    resets = torch.arange(T, device=cuda_device) % every == 0 if every else None
    kwargs = dict(inference=inference, residual_posterior=residual, precision_posterior=precision, use_mode=use_mode,
                  sd_beta=0.6931478, sd_epsilon=1e-6)
    xq = xq if inference else None
    eps = None if use_mode else eps
    cuda.reset_launch_counts()
    with torch.no_grad():
        got = rssm_ops.rssm_chain(w, xg, xq, z0, h0, eps, resets, **kwargs)
        torch.cuda.synchronize()
        assert cuda.launch_counts()["rssm_chain"] == 1
        ref = rssm_ops.rssm_chain_plain(w, xg, xq, z0, h0, eps, resets, **kwargs)
    for name, a, b in zip(got._fields, got, ref):
        if b is None:
            assert a is None and not inference
            continue
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5, msg=name)


@pytest.mark.cuda
def test_rssm_chain_kernel_refusals(cuda_device):
    """A gradient in prior mode, float64, a wrong noise or reset shape and an unstaged width raise before a
    launch."""
    w, xg, xq, z0, h0, eps = _k10_inputs(2, 6, 32, 8, cuda_device)
    kwargs = dict(inference=True, residual_posterior=False, precision_posterior=True, sd_beta=0.69, sd_epsilon=1e-6)
    with pytest.raises(NotImplementedError, match="inference mode only"):
        rssm_ops.rssm_chain(w, xg.clone().requires_grad_(True), None, z0, h0, eps,
                            **{**kwargs, "inference": False})
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="float32"):
            rssm_ops.rssm_chain(w, xg.double(), xq, z0, h0, eps, **kwargs)
        with pytest.raises(ValueError, match="eps"):
            rssm_ops.rssm_chain(w, xg, xq, z0, h0, eps[:, :2], **kwargs)
        with pytest.raises(ValueError, match="resets"):
            rssm_ops.rssm_chain(w, xg, xq, z0, h0, eps, torch.ones(3, dtype=torch.bool, device=cuda_device), **kwargs)


# B, N_in, C, stride, dilation, transposed
K11_CASES = [
    (5, 1133, 768, 4, 1, False),  # an encoder block of the :33 width
    (3, 300, 32, 4, 1, True),  # a decoder block
    (2, 257, 64, 1, 3, False),  # dilated, unstrided
    (2, 70, 36, 2, 2, True),  # transposed, dilated, C not a multiple of 32
    (4, 9000, 16, 4, 1, False),  # many statistics tiles, narrow
]


def _k11_inputs(B, N, C, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, N, C, generator=g) * 1.5 + 0.3
    p = [1 + 0.2 * torch.randn(C, generator=g), 0.2 * torch.randn(C, generator=g),
         torch.randn(5, 1, C, generator=g) * 0.4, 0.2 * torch.randn(C, generator=g),
         1 + 0.2 * torch.randn(C, generator=g), 0.2 * torch.randn(C, generator=g)]
    return u.to(device), [t.to(device) for t in p]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,stride,dilation,transposed", K11_CASES)
def test_depthwise_norm_kernel_matches_twin(cuda_device, B, N, C, stride, dilation, transposed):
    """K11 against its f64 twin within 5e-5, as ``chip_smoke.py`` holds the blocks of a whole test pass: the kernel
    sums its statistics in double, while the f32 twin's fast variance, summed in f32, may itself lie further than
    1e-5 from the f64 twin over many rows."""
    u, p = _k11_inputs(B, N, C, cuda_device)
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)
    cuda.reset_launch_counts()
    with torch.no_grad():
        got = depthwise.depthwise_norm(u, *p, **kw)
        torch.cuda.synchronize()
        assert cuda.launch_counts()["depthwise_norm"] == 1
        ref = depthwise.depthwise_norm_plain(u, *p, **kw)
        ref64 = depthwise.depthwise_norm_plain(u.double(), *(t.double() for t in p), **kw)
    assert got.shape == ref.shape == (B, depthwise.output_length(N, 5, stride, dilation, transposed), C)
    assert (got.double() - ref64).abs().max() <= 5e-5


@pytest.mark.cuda
def test_depthwise_norm_kernel_refusals(cuda_device):
    """float64 (with a gradient too), a width that is not a multiple of 4 and too few rows raise before a
    launch."""
    u, p = _k11_inputs(1, 40, 16, cuda_device)
    with pytest.raises(NotImplementedError, match="float32"):
        depthwise.depthwise_norm(u.double().requires_grad_(True), *p, stride=4, dilation=1, transposed=False)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="float32"):
            depthwise.depthwise_norm(u.double(), *p, stride=4, dilation=1, transposed=False)
        with pytest.raises(NotImplementedError, match="multiple of 4"):
            depthwise.depthwise_norm(u[..., :6], *(t[..., :6] for t in p), stride=4, dilation=1, transposed=False)
        with pytest.raises(ValueError, match="fewer"):
            depthwise.depthwise_norm(u[:, :3], *p, stride=4, dilation=1, transposed=False)


@pytest.mark.cuda
def test_cwvae_audio_on_the_card_launches_k10_and_k11(cuda_device):
    """A two-level CWVAEAudio on the card: a forward launches K10 twice (a level), K11 twelve times (3 encoder and 3
    decoder blocks a level), K2 and K3 once each, and its loss equals the plain path's with the same noise (f32,
    rtol 1e-5); a generation at the mode launches K10 twice and no K3; under a gradient the backward launches
    K10-bwd twice and K11-bwd twelve times."""
    model = CWVAEAudio(z_size=8, h_size=16, strides=(16, 4), precision_posterior=True, num_mix=3, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.rand(2, 4096, generator=g, device=cuda_device) * 2 - 1) * 0.5
    x_sl = torch.tensor([4096, 3001], device=cuda_device)
    eps = [torch.randn(2, 256, 8, generator=g, device=cuda_device), torch.randn(2, 64, 8, generator=g, device=cuda_device)]
    cuda.reset_launch_counts()
    with torch.no_grad():
        loss, _, _ = model(x, x_sl, eps=eps)
        counts = cuda.launch_counts()
        assert (counts["rssm_chain"], counts["depthwise_norm"], counts["dmol_log_prob"], counts["dmol_sample"]) == (
            2, 12, 1, 1)
    model_cpu = CWVAEAudio(z_size=8, h_size=16, strides=(16, 4), precision_posterior=True, num_mix=3)
    weights.load_jax_params(model_cpu, weights.random_jax_params(model_cpu, 0))
    with torch.no_grad():
        plain, _, _ = model_cpu(x.cpu(), x_sl.cpu(), eps=[e.cpu() for e in eps])
    torch.testing.assert_close(loss.cpu(), plain, rtol=1e-5, atol=0)
    cuda.reset_launch_counts()
    (gen, _), _ = model.generate(2, 1024, use_mode_observations=True, generator=g)
    counts = cuda.launch_counts()
    assert gen.shape == (2, 1024, 1) and counts["rssm_chain"] == 2 and counts["dmol_sample"] == 0
    cuda.reset_launch_counts()
    loss, _, _ = model(x, x_sl, eps=eps)
    loss.backward()
    counts = cuda.launch_counts()
    assert (counts["rssm_chain_bwd"], counts["depthwise_norm_bwd"], counts["dmol_log_prob_bwd"]) == (2, 12, 1)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def _k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, dtype, kernel, **kw):
    """The gradients of ``sum(outputs * g_out)`` (an output whose ``g_out`` is None left out) by xg, xq, z0, h0 and
    the 20 kernel weights: through ``rssm_chain`` (K10 in save mode and K10-bwd) or autograd of the twin in
    ``dtype``."""
    leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in (xg, xq, z0, h0, *w)]
    fn = rssm_ops.rssm_chain if kernel else rssm_ops.rssm_chain_plain
    outs = fn(leaves[4:], *leaves[:4], eps.to(dtype), resets, inference=True, **kw)
    grads = torch.autograd.grad(sum((o * g.to(dtype)).sum() for o, g in zip(outs, g_out) if g is not None), leaves,
                                allow_unused=True)
    return [torch.zeros_like(t) if g_ is None else g_ for g_, t in zip(grads, leaves)]


# (B, T', H, Z, residual, precision, reset every, the outputs without a gradient (z, h, q_mu, q_sd, p_mu, p_sd)):
# the :33 width at the train step's rows, a small width with some gradients absent, resets
K10_BWD_CASES = [
    (5, 60, 192, 128, False, True, 0, ()),
    (3, 25, 32, 16, True, False, 0, (1, 3)),
    (11, 20, 64, 8, False, True, 4, (0, 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Z,residual,precision,every,no_grad", K10_BWD_CASES)
def test_rssm_chain_bwd_kernel_matches_f64_twin(cuda_device, B, T, H, Z, residual, precision, every, no_grad):
    """K10-bwd (through ``RSSMChainFunction``: K10 in save mode, one K10-bwd launch, the weight gradients) and
    autograd of the f32 twin, both against autograd of the f64 twin; outputs without a gradient reach the kernel as
    null pointers, and no gradient crosses a reset. Then K10-bwd alone against its f64 twin on the same saved
    tensors, within 1e-4 of the largest gradient."""
    w, xg, xq, z0, h0, eps = _k10_inputs(B, T, H, Z, cuda_device, seed=B)
    resets = torch.arange(T, device=cuda_device) % every == 0 if every else None
    g = torch.Generator(device=cuda_device).manual_seed(B)
    widths = (Z, H, Z, Z, Z, Z)
    g_out = [None if i in no_grad else torch.randn(B, T, n, generator=g, device=cuda_device)
             for i, n in enumerate(widths)]
    kw = dict(residual_posterior=residual, precision_posterior=precision, sd_beta=0.6931478, sd_epsilon=1e-6)
    cuda.reset_launch_counts()
    got = _k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, torch.float32, True, **kw)
    counts = cuda.launch_counts()
    assert (counts["rssm_chain"], counts["rssm_chain_bwd"]) == (1, 1)
    twin = _k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, torch.float32, False, **kw)
    ref = _k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, torch.float64, False, **kw)
    _held_to_f64(got, twin, ref)
    with torch.no_grad():
        outs, saved = rssm_ops.rssm_chain_save(w, xg, xq, z0, h0, eps, resets, **kw)
        alone = rssm_ops.rssm_chain_backward(w, eps, saved, outs.h, h0, resets, g_out, **kw)
        ref_alone = rssm_ops.rssm_chain_backward_plain([t.double() for t in w], eps.double(), saved.double(),
                                                       outs.h.double(), h0.double(), resets,
                                                       [None if t is None else t.double() for t in g_out], **kw)
    for a, r in zip(alone, ref_alone):
        assert (a.double() - r).abs().max() <= 1e-4 * r.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
def test_rssm_chain_save_mode_keeps_the_outputs(cuda_device):
    """K10 in save mode: the same output bits as without, and saved values equal to its twin's (the products'
    summation order only: 1e-5 absolute plus 1e-5 relative, one step from the kernel's own carry)."""
    B, T, H, Z = 5, 40, 192, 128
    w, xg, xq, z0, h0, eps = _k10_inputs(B, T, H, Z, cuda_device)
    kw = dict(residual_posterior=False, precision_posterior=True, sd_beta=0.6931478, sd_epsilon=1e-6)
    with torch.no_grad():
        plain = rssm_ops.rssm_chain(w, xg, xq, z0, h0, eps, inference=True, **kw)
        outs, saved = rssm_ops.rssm_chain_save(w, xg, xq, z0, h0, eps, **kw)
        z_prev = torch.cat([z0[:, None], outs.z[:, :-1]], dim=1).reshape(B * T, 1, Z)
        h_prev = torch.cat([h0[:, None], outs.h[:, :-1]], dim=1).reshape(B * T, 1, H)
        flat = [t.reshape(B * T, 1, -1) for t in (xg, xq, eps)]
        _, ref = rssm_ops._chain_plain(w, flat[0], flat[1], z_prev[:, 0], h_prev[:, 0], flat[2], None, inference=True,
                                       use_mode=False, save=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(outs, plain))
    torch.testing.assert_close(saved, ref.reshape(B, T, -1), atol=1e-5, rtol=1e-5)


# B, N_in, C, stride, dilation, transposed, an all-padding row
K11_BWD_CASES = [
    (5, 1133, 768, 4, 1, False, False),  # an encoder block of the :33 width
    (5, 70, 768, 4, 1, True, True),  # a decoder block of the :33 width, one row all padding
    (2, 257, 64, 1, 3, False, True),  # dilated, unstrided, one row all padding
    (3, 70, 36, 2, 2, True, False),  # transposed, dilated, C not a multiple of 32
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,stride,dilation,transposed,padding_row", K11_BWD_CASES)
def test_depthwise_norm_bwd_kernel_matches_f64_twin(cuda_device, B, N, C, stride, dilation, transposed, padding_row):
    """K11 in save mode keeps its output bits; K11-bwd (through ``DepthwiseNormFunction``: one K11 in save mode, one
    K11-bwd) and autograd of the f32 twin, both against autograd of the f64 twin, as K10-bwd is held; an
    all-padding row (constant u, no output gradient) gets a gradient of exactly 0; K11-bwd alone against its f64
    twin on the kernel's saved statistics within 1e-4 of each largest gradient."""
    u, p = _k11_inputs(B, N, C, cuda_device)
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    dz = torch.randn(B, depthwise.output_length(N, 5, stride, dilation, transposed), C, generator=g,
                     device=cuda_device)
    if padding_row:
        u[1] = u[1, :1]
        dz[1] = 0.0
    with torch.no_grad():
        plain = depthwise.depthwise_norm(u, *p, **kw)
        z, stats = depthwise.depthwise_norm_save(u, *p, **kw)
    assert torch.equal(z, plain)

    def grads(dtype, fn):
        leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in (u, *p)]
        return torch.autograd.grad((fn(*leaves, **kw) * dz.to(dtype)).sum(), leaves)

    cuda.reset_launch_counts()
    got = grads(torch.float32, depthwise.depthwise_norm)
    counts = cuda.launch_counts()
    assert (counts["depthwise_norm"], counts["depthwise_norm_bwd"]) == (1, 1)
    _held_to_f64(got, grads(torch.float32, depthwise.depthwise_norm_plain),
                 grads(torch.float64, depthwise.depthwise_norm_plain))
    if padding_row:
        assert not got[0][1].abs().any()
    with torch.no_grad():
        alone = depthwise.depthwise_norm_backward(dz, u, *p[:5], stats, **kw)
        ref = depthwise.depthwise_norm_backward_plain(dz.double(), u.double(), *(t.double() for t in p[:5]),
                                                      stats.double(), **kw)
    for a, r in zip(alone, ref):
        assert (a.double() - r).abs().max() <= 1e-4 * r.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
def test_cwvae_train_step_on_the_card_launches_each_kernel(cuda_device):
    """One train step of a one-level CWVAEAudio (strides [64], the run specs' 3 blocks of stride 4 a coder) through
    the driver's ``train``: K10, K10-bwd, K2, K2-bwd and K3 once, K11 and K11-bwd six times, and finite
    parameters."""
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import clockwork_audio

    args = clockwork_audio.build_args("--hidden_size 16 --latent_size 8 --strides 64 --num_mix 3 --epochs 1 "
                                      "--metric_fetch_lag 0 --seed 0".split())
    model = clockwork_audio.build_model(args, device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    g = torch.Generator().manual_seed(0)
    utterances = [(i, (torch.rand(n, generator=g) - 0.5).numpy()) for i, n in enumerate((4000, 3100))]
    cuda.reset_launch_counts()
    clockwork_audio.train(model, args, [utterances], Tracker(), device=cuda_device)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    assert {k: v for k, v in counts.items() if v} == dict(rssm_chain=1, rssm_chain_bwd=1, depthwise_norm=6,
                                                          depthwise_norm_bwd=6, dmol_log_prob=1, dmol_log_prob_bwd=1,
                                                          dmol_sample=1)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def _k6_inputs(B, T, H, device, lengths=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    bound = 1 / math.sqrt(H)
    xw = torch.randn(B, T, 8 * H, generator=g) * 0.7
    w_hh, b_hh = ((torch.rand(*shape, generator=g) * 2 - 1) * bound for shape in ((2, H, 4 * H), (2, 4 * H)))
    lengths = torch.randint(0, T + 1, (B,), generator=g) if lengths is None else torch.tensor(lengths)
    mask = (torch.arange(T)[None] < lengths[:, None]).float()
    return [t.to(device) for t in (xw, w_hh, b_hh, mask)]


K6_SHAPES = [
    (38, 60, 256, None),  # a train batch's rows at the probe's width, ragged with rows of length 0
    (5, 40, 256, (40, 1, 0, 39, 17)),  # very different lengths, one row all padding
    (120, 20, 256, None),  # an eval batch's rows: more clusters than are resident, in waves
    (3, 33, 32, (33, 20, 2)),  # a small H
    (4, 12, 8, (12, 12, 5, 0)),  # the smallest H, one unit a CTA
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,lengths", K6_SHAPES)
def test_bilstm_recurrence_kernel_matches_twin(cuda_device, B, T, H, lengths):
    """K6 against its twin, free-running over T steps in f32: the products' summation order only (1e-5,
    K5's limit); its save mode's outputs bitwise equal to a plain launch's, the saved gates and state
    those of one twin step from the saved state; zeros past each length in both directions."""
    a = _k6_inputs(B, T, H, cuda_device, lengths)
    cuda.reset_launch_counts()
    with torch.no_grad():
        got = recurrent.bilstm_recurrence(*a)
        out, gates, h_prev, c_prev = recurrent.bilstm_recurrence_save(*a)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["bilstm_recurrence"] == 2 and torch.equal(got, out)
    torch.testing.assert_close(got, recurrent.bilstm_recurrence_plain(*a), atol=1e-5, rtol=0)
    xw, w_hh, b_hh, mask = a
    assert not got[mask == 0].any()
    for d in range(2):
        sl = slice(d * H, (d + 1) * H)
        pre = xw[..., d * 4 * H:(d + 1) * 4 * H] + h_prev[..., sl] @ w_hh[d] + b_hh[d]
        i, f, g, o = pre.chunk(4, dim=-1)
        act = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], dim=-1)
        m = mask[..., None]
        torch.testing.assert_close(gates[..., d * 4 * H:(d + 1) * 4 * H] * m, act * m, atol=1e-5, rtol=0)
        c_new = torch.sigmoid(f) * c_prev[..., sl] + torch.sigmoid(i) * torch.tanh(g)
        torch.testing.assert_close(out[..., sl], torch.sigmoid(o) * torch.tanh(c_new) * m, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_bilstm_direction_zero_is_k5_and_direction_one_is_k5_reversed(cuda_device):
    """Each direction of K6 is K5's recurrence: direction 0 over the sequence, bit for bit (both are
    ``csrc/lstm_common.cuh``'s kernel in f32, one cluster a group of rows), direction 1 over each row's
    reversed valid frames (the padding, which it reads first, holds its zero state)."""
    B, T, H = 6, 50, 256
    xw, w_hh, b_hh, mask = _k6_inputs(B, T, H, cuda_device, (50, 31, 1, 0, 49, 12))
    zeros = torch.zeros(B, H, device=cuda_device)
    with torch.no_grad():
        out = recurrent.bilstm_recurrence(xw, w_hh, b_hh, mask)
        fwd = recurrent.lstm_recurrence(xw[..., :4 * H], w_hh[0], b_hh[0], mask, zeros, zeros)[0]
        lengths = mask.sum(1).long().tolist()
        rev = torch.zeros_like(xw[..., 4 * H:])
        for b, n in enumerate(lengths):
            rev[b, :n] = xw[b, :n, 4 * H:].flip(0)
        bwd = recurrent.lstm_recurrence(rev, w_hh[1], b_hh[1], mask, zeros, zeros)[0]
    assert torch.equal(out[..., :H], fwd)
    for b, n in enumerate(lengths):
        torch.testing.assert_close(out[b, :n, H:], bwd[b, :n].flip(0), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,lengths", K6_SHAPES)
def test_bilstm_recurrence_backward_kernel_matches_f64_twin(cuda_device, B, T, H, lengths):
    """K6-bwd (through BiLSTMRecurrenceFunction, with the dW_hh and db_hh products) and autograd of the f32
    twin, both held to autograd of the f64 twin: each gradient's largest error within twice the f32 twin's
    plus 1e-6 of its largest value; an all-padding row's gradient exactly 0."""
    a = _k6_inputs(B, T, H, cuda_device, lengths, seed=1)
    d_out = torch.randn(B, T, 2 * H, generator=torch.Generator().manual_seed(2)).to(cuda_device)

    def grads(fn, dtype):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in a[:3]]
        return torch.autograd.grad((fn(*leaves, a[3]) * d_out.to(dtype)).sum(), leaves)

    cuda.reset_launch_counts()
    got = grads(recurrent.bilstm_recurrence, torch.float32)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["bilstm_recurrence"] == 1 and cuda.launch_counts()["bilstm_recurrence_bwd"] == 1
    twin = grads(recurrent.bilstm_recurrence_plain, torch.float32)
    ref = grads(recurrent.bilstm_recurrence_plain, torch.float64)
    for x, y, r in zip(got, twin, ref):
        scale = r.abs().max()
        assert (x.double() - r).abs().max() <= 2 * (y.double() - r).abs().max() + 1e-6 * scale
    empty = (a[3].sum(1) == 0).nonzero().flatten()
    assert not got[0][empty].any()


@pytest.mark.cuda
def test_bilstm_recurrence_kernel_refuses_what_it_does_not_take(cuda_device):
    a = _k6_inputs(2, 5, 264, cuda_device)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        recurrent.bilstm_recurrence(*a)
    a = _k6_inputs(2, 5, 32, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        recurrent.bilstm_recurrence(a[0].bfloat16(), *a[1:])
    with pytest.raises(ValueError, match="one CUDA device"):
        recurrent.bilstm_recurrence(a[0], a[1].cpu(), *a[2:])
    with pytest.raises(ValueError, match=r"w_hh \(2, 32, 128\)"):
        recurrent.bilstm_recurrence(a[0], a[1][0], *a[2:])
    with pytest.raises(ValueError, match="float32 tensors on one CUDA device"):
        out, gates, h_prev, c_prev = recurrent.bilstm_recurrence_save(*a)
        recurrent.bilstm_recurrence_backward(a[1], a[3], gates.double(), c_prev, out)


@pytest.mark.cuda
def test_simple_lstm_asr_on_the_card_launches_k6(cuda_device):
    """A small bidirectional probe on the card: a forward and backward launch K6 and K6-bwd once a layer and
    K13 and K13-bwd once, and its loss and gradients equal the plain path's."""
    model = SimpleLSTMASR(vocab=tuple("%abcdefg"), input_size=12, hidden_size=32, num_layers=2, bidirectional=True,
                          device=cuda_device)
    weights.load_jax_params(model, weights.random_jax_params(model, 0))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 40, 12, generator=g).to(cuda_device)
    x_sl = torch.tensor([40, 23, 9], device=cuda_device)
    y = torch.randint(1, 8, (3, 6), generator=g).to(cuda_device)
    y_sl = torch.tensor([6, 4, 2], device=cuda_device)
    cuda.reset_launch_counts()
    loss, _, _ = model(x, x_sl, y, y_sl)
    loss.backward()
    counts = cuda.launch_counts()
    assert counts["bilstm_recurrence"] == 2 and counts["bilstm_recurrence_bwd"] == 2
    assert counts["ctc_loss"] == 1 and counts["ctc_loss_bwd"] == 1
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    with mock.patch.object(recurrent, "bilstm_recurrence", recurrent.bilstm_recurrence_plain), \
            mock.patch.object(ctc, "ctc_loss", ctc.ctc_loss_plain):
        plain_loss, _, _ = model(x, x_sl, y, y_sl)
        plain_loss.backward()
    torch.testing.assert_close(loss.detach(), plain_loss.detach(), rtol=1e-5, atol=0)
    for n, p in model.named_parameters():
        assert ((grads[n] - p.grad).norm() / p.grad.norm().clamp_min(1e-30)).item() <= 1e-4, n


def _ctc_inputs(B, T, K, N, device, seed=0):
    """Logits, frames, right-padded labels (runs of repeats among them) and label counts; the last rows: one
    whose labels cannot fit its frames, one with no frames and no labels, one with frames and no labels."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, T, K, generator=g) * 2
    z_sl = torch.randint(T // 2, T + 1, (B,), generator=g)
    y_sl = torch.minimum(torch.randint(1, N + 1, (B,), generator=g), z_sl // 3)
    y = torch.randint(1, K, (B, N), generator=g)
    y[:, 1:4] = y[:, :1]
    z_sl[-3], y_sl[-3] = 3, min(N, 6)
    z_sl[-2], y_sl[-2] = 0, 0
    y_sl[-1] = 0
    y[torch.arange(N)[None] >= y_sl[:, None]] = 0
    return [t.to(device) for t in (logits, z_sl, y, y_sl)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,K,N", [(38, 220, 65, 48), (5, 40, 7, 16), (3, 9, 65, 1), (5, 700, 65, 300),
                                     (4, 200, 9, 1023), (3, 1100, 65, 48)])
def test_ctc_loss_kernel_matches_twin(cuda_device, B, T, K, N):
    """K13 against its twin (optax's recursion in plain PyTorch): the per-example losses within 1e-5
    relative, the infeasible row's finite score and the empty row's -0.0 included; the gradient of the
    logits through K13-bwd and autograd of the f32 twin both held to autograd of the f64 twin (twice the
    f32 twin's largest error plus 1e-6 of the largest value); rows past their frames get no gradient. K13-bwd's
    gradient of the log-probabilities is held the same way to the f64 alpha-beta twin (``ctc_alpha_beta_plain``,
    ``ctc_loss_grad_plain``), with the f32 alpha-beta twin as the yardstick; save mode's losses bitwise equal
    the plain launch's. N + 1 > 128 takes several warps a row (N = 1023, the most, eight); T = 1100 many
    frames."""
    logits, z_sl, y, y_sl = _ctc_inputs(B, T, K, N, cuda_device)
    weights = torch.linspace(0.5, 1.5, B, device=cuda_device)

    def run(fn, dtype):
        lg = logits.detach().to(dtype).requires_grad_(True)
        loss = fn(lg, z_sl, y, y_sl)
        (grad,) = torch.autograd.grad((loss * weights.to(dtype)).sum(), lg)
        return loss.detach(), grad

    cuda.reset_launch_counts()
    got, g_got = run(ctc.ctc_loss, torch.float32)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["ctc_loss"] == 1 and cuda.launch_counts()["ctc_loss_bwd"] == 1
    twin, g_twin = run(ctc.ctc_loss_plain, torch.float32)
    ref, g_ref = run(ctc.ctc_loss_plain, torch.float64)
    assert torch.isfinite(got).all() and torch.isfinite(g_got).all()
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)
    if B > 3:
        assert got[-3] > 9e4 and torch.signbit(got[-2]) and got[-2] == 0
    scale = g_ref.abs().max()
    assert (g_got.double() - g_ref).abs().max() <= 2 * (g_twin.double() - g_ref).abs().max() + 1e-6 * scale
    frames = torch.arange(T, device=cuda_device)[None] < z_sl[:, None]
    assert not g_got[~frames].any()
    with torch.no_grad():
        assert torch.equal(ctc.ctc_loss(logits, z_sl, y, y_sl), got)
        lp = torch.log_softmax(logits, -1)

    leaf = lp.detach().requires_grad_(True)
    (d_lp,) = torch.autograd.grad((ctc.CTCLossFunction.apply(leaf, y, z_sl, y_sl, 0) * weights).sum(), leaf)
    d_ref, d_f32 = (ctc.ctc_loss_grad_plain(*ctc.ctc_alpha_beta_plain(lp.to(dt), z_sl, y, y_sl), y, z_sl, weights, K)
                    for dt in (torch.float64, torch.float32))
    d_scale = d_ref.abs().max()
    assert (d_lp.double() - d_ref).abs().max() <= 2 * (d_f32.double() - d_ref).abs().max() + 1e-6 * d_scale


@pytest.mark.cuda
def test_ctc_loss_kernel_refuses_what_it_does_not_take(cuda_device):
    logits, z_sl, y, y_sl = _ctc_inputs(4, 10, 7, 4, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ctc.ctc_loss(logits.double(), z_sl, y, y_sl)
    with pytest.raises(ValueError, match="one CUDA device"):
        ctc.ctc_loss(logits, z_sl.cpu(), y, y_sl)
    with pytest.raises(ValueError, match="1 to 1023 label columns"):
        ctc.ctc_loss(logits, z_sl, torch.ones(4, 1024, dtype=torch.int64, device=cuda_device), y_sl)
    with pytest.raises(ValueError, match="at most 4096 classes"):
        ctc.ctc_loss(torch.zeros(4, 10, 4097, device=cuda_device), z_sl, y, y_sl)
    with pytest.raises(ValueError, match="logits"):
        ctc.ctc_loss(logits[0], z_sl, y, y_sl)
