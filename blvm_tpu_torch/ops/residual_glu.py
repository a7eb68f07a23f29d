"""K1: the k=2 residual-GLU block (port of the cut Pallas kernel
``1788a18^:blvm_tpu/ops/pallas/wavenet_block.py`` and its custom VJP, the block of
``blvm_tpu/models/wavenet/modules.py:146-202``).

:func:`residual_glu_plain` is the plain twin, op for op the JAX block.
:func:`residual_glu` is the entry point: for CPU tensors the twin (autograd gives its
gradient); for CUDA tensors the forward kernel ``csrc/residual_glu.cu`` and, under
autograd, :class:`ResidualGLUFunction`, whose backward is :func:`residual_glu_backward`
(``csrc/residual_glu_bwd.cu`` and the weight-gradient GEMMs), or it raises.
:func:`residual_glu_backward` is also the fused stack's backward, block by block
(``ops/wavenet_stack.py``). In bf16 at C = half = R = S = 96 with the skip (WaveNet's run specs) it is the warpgroup
route, four kernels that also take the weight and bias gradients and write them into the caller's slots;
:func:`residual_glu_backward_plain` is its twin, split as its kernels split it.
"""

import functools
import math

import torch

from blvm_tpu_torch.ops import cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K1's limits (csrc/residual_glu.cu): MAX_C, MAX_HALF, MAX_RS (the widest accumulators, STCN's C = 256)
K1_MAX_CHANNELS, K1_MAX_HALF, K1_MAX_RES_PLUS_SKIP = 256, 256, 512
# K1-bwd's (csrc/residual_glu_bwd.cu): half <= 128 and R + S <= 256 (the WaveNet widths), or in f32 STCN's
# C = half = R = 256 with S = 256 or skip-free (the register-tiled path); both with or without the skip
K1_BWD_MAX_HALF, K1_BWD_MAX_RES_PLUS_SKIP, K1_BWD_TILED_WIDTH = 128, 256, 256
# the warpgroup route's width (csrc/residual_glu_bwd.cu, namespace wg): bf16, C = half = R = S, with the skip
K1_BWD_WG_WIDTH = 96
_WG_TILE = 64  # rows a tile of its passes and a chunk of its weight-gradient split
WG_PART_FLOATS = 3 * ((96 + 48) * 128 + 128)  # one split's f32 partials (csrc: 3 x PART)


def residual_glu_plain(x, gate_kernel_t, gate_kernel_s, gate_bias_t, gate_bias_s, rs_kernel, rs_bias,
                       dilation: int, skip_size: int, need_skip: bool = True):
    """The k=2 residual-GLU block as plain PyTorch, op for op the JAX block
    (``blvm_tpu/models/wavenet/modules.py:146-202``), rounding to the compute
    dtype of ``x`` after every op as JAX does.

    Args:
        x: (B, T_in, C) in the compute dtype; the kernels and biases in it too.
        gate_kernel_t, gate_kernel_s: (2, C, half); gate_bias_t, gate_bias_s: (half,).
        rs_kernel: (1, half, R + S); rs_bias: (R + S,). ``R == C``.
        need_skip: False contracts only the R residual columns of ``rs_kernel`` and
            returns no skip, as JAX's ``need_skip=False`` block does.
    Returns ``o`` (B, T_in - dilation, R) and ``s`` (B, skip_size, S), or None without the skip.
    """
    d = dilation
    L = x.shape[1] - d

    def branch(kernel, bias):
        y0 = x @ kernel[0]
        y1 = x @ kernel[1]
        return y0[:, :L] + y1[:, d:] + bias

    act = torch.tanh(branch(gate_kernel_t, gate_bias_t)) * torch.sigmoid(branch(gate_kernel_s, gate_bias_s))
    R = x.shape[-1]
    if need_skip:
        rs = act @ rs_kernel[0] + rs_bias
        r, s = rs[..., :R], rs[..., R:][:, -skip_size:]
    else:
        r, s = act @ rs_kernel[0, :, :R] + rs_bias[:R], None
    return (r + x[:, -L:]) * _inv_std(x.dtype), s


def residual_glu(x, gate_kernel_t, gate_kernel_s, gate_bias_t, gate_bias_s, rs_kernel, rs_bias,
                 dilation: int, skip_size: int, need_skip: bool = True):
    """K1: one k=2 residual-GLU block, same contract as :func:`residual_glu_plain`.

    CPU tensors run the plain twin (autograd gives its gradient). CUDA tensors
    go through :class:`ResidualGLUFunction`: the hand-written forward kernel
    ``csrc/residual_glu.cu`` and, under autograd, the backward kernel
    ``csrc/residual_glu_bwd.cu`` (f32 accumulation, one rounding to the compute
    dtype at the store), each with the skip or in its skip-free mode, or raise
    for what they do not take.
    """
    args = (x, gate_kernel_t, gate_kernel_s, gate_bias_t, gate_bias_s, rs_kernel, rs_bias)
    if not x.is_cuda:
        return residual_glu_plain(*args, dilation=dilation, skip_size=skip_size, need_skip=need_skip)

    B, T_in, C = x.shape
    half = gate_kernel_t.shape[-1]
    RS = rs_kernel.shape[-1]
    S = RS - C if need_skip else 0
    T_out = T_in - dilation
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype or t.device != x.device for t in args):
        raise TypeError("residual_glu kernel: all tensors must share x's device and dtype (float32 or bfloat16)")
    expected = [(2, C, half), (2, C, half), (half,), (half,), (1, half, RS), (RS,)]
    if [tuple(t.shape) for t in args[1:]] != expected:
        raise ValueError(f"residual_glu kernel: weight shapes {[tuple(t.shape) for t in args[1:]]}, expected {expected}")
    if C > K1_MAX_CHANNELS or half > K1_MAX_HALF or C + S > K1_MAX_RES_PLUS_SKIP or (need_skip and S < 1):
        raise ValueError(
            f"residual_glu kernel takes C <= {K1_MAX_CHANNELS}, half <= {K1_MAX_HALF}, "
            f"R + S <= {K1_MAX_RES_PLUS_SKIP} and, with the skip, S >= 1; got C={C}, half={half}, R+S={C + S}"
        )
    if dilation < 1 or T_out < 1 or (need_skip and not 1 <= skip_size <= T_out) or not 1 <= B <= 65535:
        raise ValueError(f"residual_glu kernel: bad geometry B={B}, T_in={T_in}, dilation={dilation}, skip_size={skip_size}")
    o, s = ResidualGLUFunction.apply(*args, dilation, skip_size, need_skip)
    return o, (s if need_skip else None)


class ResidualGLUFunction(torch.autograd.Function):
    """K1 under autograd. ``forward`` launches the forward kernel and saves only
    ``x`` and the (cast) weights, as the cut Pallas kernel's custom VJP saved
    ``(x, wg, bg, w1, b1)``; ``backward`` is :func:`residual_glu_backward` (the
    K1-bwd kernel and the weight-gradient GEMMs). Without the skip the second
    output is an empty ``(B, 0, 0)`` tensor. Arguments were checked by
    :func:`residual_glu`."""

    @staticmethod
    def forward(ctx, x, w_t, w_s, b_t, b_s, w_rs, b_rs, dilation: int, skip_size: int, need_skip: bool = True):
        args = [t.contiguous() for t in (x, w_t, w_s, b_t, b_s, w_rs, b_rs)]
        x = args[0]
        B, T_in, C = x.shape
        half, RS = w_t.shape[-1], w_rs.shape[-1]
        S = RS - C if need_skip else 0
        o = torch.empty((B, T_in - dilation, C), dtype=x.dtype, device=x.device)
        s = torch.empty((B, skip_size, S) if need_skip else (B, 0, 0), dtype=x.dtype, device=x.device)
        lib = cuda.library()
        cuda.count_launch("residual_glu")
        err = lib.blvm_residual_glu(
            *(t.data_ptr() for t in args), o.data_ptr(), s.data_ptr(),
            B, T_in, C, half, C, S, RS, dilation, skip_size, _DTYPE_CODES[x.dtype], cuda.stream_handle(x),
        )
        cuda.check(err, "residual_glu")
        ctx.save_for_backward(*args[:6])
        ctx.geometry = (dilation, skip_size, need_skip)
        return o, s

    @staticmethod
    def backward(ctx, d_o, d_s):
        dilation, skip_size, need_skip = ctx.geometry
        return (*residual_glu_backward(*ctx.saved_tensors, d_o=d_o, d_s=d_s, dilation=dilation, skip_size=skip_size,
                                       need_skip=need_skip), None, None, None)


def wg_route(x: torch.Tensor, half: int, S: int, need_skip: bool) -> bool:
    """Whether :func:`residual_glu_backward` takes the warpgroup route for this block."""
    return x.dtype == torch.bfloat16 and need_skip and x.shape[-1] == half == S == K1_BWD_WG_WIDTH


def residual_glu_backward(x, w_t, w_s, b_t, b_s, w_rs, *, d_o, d_s, dilation: int, skip_size: int,
                          need_skip: bool = True):
    """The gradient of one k=2 residual-GLU block from its input and weights and the gradients of its outputs:
    ``(dx, d_w_t, d_w_s, d_b_t, d_b_s, d_w_rs, d_b_rs)``, each in its input's dtype. The backward of
    :class:`ResidualGLUFunction` and, in f32, block after block of the fused stack's ``WaveNetStackFunction``.

    bf16 at C = half = R = S = 96 with the skip (:func:`wg_route`): the warpgroup route, four kernels and no other
    launch: pass A (the gate recomputed; ``d_pre`` and ``act``), the weight gradients' f32 partials split over the
    rows, their reduction in fixed order into the slots, pass B (``dx``); its twin is
    :func:`residual_glu_backward_plain`. Otherwise the K1-bwd kernel, which recomputes the gate (two passes: ``d_pre``
    and ``act``, then ``dx``), and the weight and bias gradients, sums over all ``B * L`` rows, as plain products on
    its outputs (cuBLAS, f32 accumulation), as the JAX backward left them to XLA. That kernel takes half <= 128 and
    R + S <= 256 in f32 and bf16 (the WaveNet widths), and STCN's C = half = R = 256 in f32
    (``K1_BWD_TILED_WIDTH``); both with the skip and skip-free. It raises for other widths (bf16 at C = 256 among
    them: no STCN run spec sets ``--bf16``). Without the skip the skip columns of ``rs_kernel`` and ``rs_bias`` get
    a zero gradient, as JAX's column slice ``rs_kernel[0, :, :R]`` gives them. CUDA tensors only (on the CPU
    autograd of :func:`residual_glu_plain` gives the gradient)."""
    B, T_in, C = x.shape
    half, rs_ld = w_t.shape[-1], w_rs.shape[-1]
    S = rs_ld - C if need_skip else 0
    if wg_route(x, half, S, need_skip):
        return _backward_wg(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, dilation, skip_size)
    tiled = C == half == K1_BWD_TILED_WIDTH and S in (0, C)
    if not (tiled and x.dtype == torch.float32) and (half > K1_BWD_MAX_HALF or C + S > K1_BWD_MAX_RES_PLUS_SKIP):
        raise NotImplementedError(
            f"residual_glu_bwd kernel takes half <= {K1_BWD_MAX_HALF} and R + S <= {K1_BWD_MAX_RES_PLUS_SKIP}, or "
            f"float32 at C = half = R = {K1_BWD_TILED_WIDTH} with S = {K1_BWD_TILED_WIDTH} or skip-free; got "
            f"C={C}, half={half}, R+S={C + S}, {x.dtype}")
    L = T_in - dilation
    # the kernel reads 16-byte rows: a view that starts off that alignment is copied (fresh tensors are aligned)
    x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s = _aligned(x, w_t, w_s, b_t, b_s, w_rs, d_o.to(x.dtype), d_s.to(x.dtype))
    d_pre = torch.empty((B, L, 2 * half), dtype=x.dtype, device=x.device)
    act = torch.empty((B, L, half), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    lib = cuda.library()
    cuda.count_launch("residual_glu_bwd")
    err = lib.blvm_residual_glu_bwd(
        *(t.data_ptr() for t in (x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act, dx)),
        B, T_in, C, half, C, S, rs_ld, dilation, skip_size, _DTYPE_CODES[x.dtype], cuda.stream_handle(x),
    )
    cuda.check(err, "residual_glu_bwd")

    # weight and bias gradients: sums over all B * L rows, as GEMMs (a column sum is a
    # product with a row of ones: one pass with f32 accumulation, where PyTorch's
    # reduction over the long axis took ~4x longer on the card)
    def col_sum(rows):
        return (torch.ones(1, rows.shape[0], dtype=rows.dtype, device=rows.device) @ rows)[0]

    d_pre_rows = d_pre.reshape(-1, 2 * half)
    d_w0 = x[:, :L].reshape(-1, C).T @ d_pre_rows  # (C, 2 half): [tanh | sigmoid] branch, tap 0
    d_w1 = x[:, dilation:].reshape(-1, C).T @ d_pre_rows  # tap 1
    d_w_t = torch.stack([d_w0[:, :half], d_w1[:, :half]])
    d_w_s = torch.stack([d_w0[:, half:], d_w1[:, half:]])
    d_b = col_sum(d_pre_rows)
    # the residual half of d_rs is dO sqrt(1/2): the constant (in x's dtype, as the forward
    # multiplies by it) scales the small products instead of all of dO
    inv_std = _inv_std(x.dtype)
    d_o_rows = d_o.reshape(-1, C)
    d_w_rs = [(act.reshape(-1, half).T @ d_o_rows) * inv_std]
    d_b_rs = [col_sum(d_o_rows) * inv_std]
    if need_skip:
        d_s_rows = d_s.reshape(-1, S)
        d_w_rs.append(act[:, L - skip_size :].reshape(-1, half).T @ d_s_rows)
        d_b_rs.append(col_sum(d_s_rows))
    else:  # the skip columns took no part in the skip-free forward
        d_w_rs.append(x.new_zeros((half, rs_ld - C)))
        d_b_rs.append(x.new_zeros(rs_ld - C))
    return dx, d_w_t, d_w_s, d_b[:half], d_b[half:], torch.cat(d_w_rs, dim=1)[None], torch.cat(d_b_rs)


def _aligned(*tensors):
    """Each tensor contiguous and starting on a 16-byte boundary (a view that starts off it is copied)."""
    return tuple(t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)
                 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wg_splits(device: torch.device, B: int, L: int) -> int:
    """How many CTAs the warpgroup route's weight-gradient kernel splits a block's ``B * L`` output rows over, for each
    of its 3 row blocks of the gradients: two CTAs an SM in all, at most one a 64-row chunk."""
    return max(1, min(-(-2 * _sm_count(device.index or 0) // 3), B * -(-L // _WG_TILE)))


def _backward_wg(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, dilation, skip_size):
    """The warpgroup route of :func:`residual_glu_backward` for one block: a chain of one
    (:func:`wg_chain_backward`)."""
    weights = [t.unsqueeze(0) for t in _aligned(w_t, w_s, b_t, b_s, w_rs)]
    slots = [torch.empty_like(t) for t in weights] + [x.new_empty((1, 2 * x.shape[-1]))]
    x, d_o, d_s = _aligned(x, d_o.to(x.dtype), d_s.to(x.dtype))
    dx = wg_chain_backward([x], weights, d_o, [d_s], [dilation], skip_size, slots)
    return (dx, *(t[0] for t in slots))


def wg_chain_backward(inputs, weights, d_out, d_skips, dilations, skip_size: int, slots) -> torch.Tensor:
    """The warpgroup route over a chain of blocks (a fused stack's), the last block first: block ``l``'s input is
    ``inputs[l]`` (B, T_l, C), T_{l+1} = T_l - ``dilations[l]``, its weights entry ``l`` of the five stacked
    ``weights`` (w_t, w_s, b_t, b_s, w_rs as :func:`~blvm_tpu_torch.ops.wavenet_stack.pack_blocks` stacks them), its dO
    block ``l + 1``'s dx (block L - 1's: ``d_out``), its dS ``d_skips[l]`` (B, skip_size, C); its weight and bias
    gradients go into entry ``l`` of the six stacked ``slots`` (w_t, w_s, b_t, b_s, w_rs, rs_bias). Returns block 0's
    dx. Four launches a block and no other work on the card: the buffers between the kernels are made once for the
    chain and the blocks' arguments are addresses, so that the host's part of a block stays small (a fused stack's
    backward ran host-bound with a Python call a block). bf16 at C = half = R = S = 96; checked once for the chain."""
    L, x0 = len(dilations), inputs[0]
    B, T0, C = x0.shape
    dev, dt = x0.device, x0.dtype
    lengths = [T0]
    for d in dilations:
        lengths.append(lengths[-1] - d)
    shapes = [(L, 2, C, C), (L, 2, C, C), (L, C), (L, C), (L, 1, C, 2 * C)]
    tensors = [*inputs, *weights, d_out, *d_skips, *slots]
    if (len(inputs) != L or len(d_skips) != L or [tuple(t.shape) for t in weights] != shapes
            or [tuple(t.shape) for t in slots] != shapes + [(L, 2 * C)]
            or any(tuple(t.shape) != (B, n, C) for t, n in zip(inputs, lengths)) or tuple(d_out.shape) != (B, lengths[L], C)
            or any(tuple(t.shape) != (B, skip_size, C) for t in d_skips)):
        raise ValueError(f"residual_glu_bwd: a chain of {L} blocks of (B, T, C) = ({B}, {T0}, {C}): the inputs, weights, "
                         f"cotangents or gradient slots have other shapes")
    if min(dilations) < 1 or lengths[L] < 1 or not 1 <= skip_size <= lengths[L] or not 1 <= B <= 65535:
        raise ValueError(f"residual_glu_bwd: bad geometry B={B}, T_in={T0}, dilations={list(dilations)}, "
                         f"skip_size={skip_size}")
    if any(t.dtype != dt or t.device != dev or not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("residual_glu_bwd: every tensor of the chain must be contiguous, 16-byte aligned and of x's "
                         "dtype and device")
    rows = B * lengths[1]  # block 0's output rows, the chain's most
    d_pre = torch.empty(rows * 2 * C, dtype=dt, device=dev)
    act = torch.empty(rows * C, dtype=dt, device=dev)
    part = torch.empty(wg_splits(dev, B, lengths[1]) * WG_PART_FLOATS, dtype=torch.float32, device=dev)
    between = [torch.empty(rows * C, dtype=dt, device=dev) for _ in range(2 if L > 1 else 0)]  # blocks' dx, in turn
    dx = torch.empty_like(x0)
    lib, stream = cuda.library(), cuda.stream_handle(x0)
    w_ptr = [(t.data_ptr(), t.stride(0) * t.element_size()) for t in weights]
    g_ptr = [(t.data_ptr(), t.stride(0) * t.element_size()) for t in slots]
    pre, ac, pa = d_pre.data_ptr(), act.data_ptr(), part.data_ptr()
    d_o = d_out.data_ptr()
    for l in reversed(range(L)):
        x_l, d_s, T_in, d = inputs[l].data_ptr(), d_skips[l].data_ptr(), lengths[l], dilations[l]
        w_t, w_s, b_t, b_s, w_rs = (base + l * step for base, step in w_ptr)
        d_x = dx.data_ptr() if l == 0 else between[l % 2].data_ptr()
        n_split = wg_splits(dev, B, lengths[l + 1])
        cuda.count_launch("glu_bwd_pass_a")
        cuda.check(lib.blvm_glu_bwd_pass_a(x_l, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, pre, ac, B, T_in, d, skip_size,
                                           stream), "glu_bwd_pass_a")
        cuda.count_launch("glu_bwd_wgrad")
        cuda.check(lib.blvm_glu_bwd_wgrad(x_l, d_o, d_s, pre, ac, pa, B, T_in, d, skip_size, n_split, stream),
                   "glu_bwd_wgrad")
        cuda.count_launch("glu_bwd_reduce")
        cuda.check(lib.blvm_glu_bwd_reduce(pa, *(base + l * step for base, step in g_ptr), n_split, stream),
                   "glu_bwd_reduce")
        cuda.count_launch("glu_bwd_pass_b")
        cuda.check(lib.blvm_glu_bwd_pass_b(w_t, w_s, pre, d_o, d_x, B, T_in, d, stream), "glu_bwd_pass_b")
        d_o = d_x
    return dx


# ---- the twin of the warpgroup route, split as its kernels split it ----------------------------------------------

def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def glu_bwd_pass_a_plain(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, dilation: int, skip_size: int, need_skip: bool = True):
    """Pass A: ``(d_pre, act)``, ``d_pre = [d_pre_t | d_pre_s]`` (B, L, 2 half) and the gated activation (B, L,
    half), from the gate recomputed and ``d_act = dO W_r^T sqrt(1/2) + dS W_s^T`` (dS over the last ``skip_size``
    rows), products in at least f32, rounded once to x's dtype."""
    acc = _acc_dtype(x.dtype)
    B, T_in, C = x.shape
    half, L = w_t.shape[-1], T_in - dilation
    xa = x.to(acc)
    pre = (xa[:, :L] @ torch.cat([w_t[0], w_s[0]], 1).to(acc) + xa[:, dilation:] @ torch.cat([w_t[1], w_s[1]], 1).to(acc))
    th = torch.tanh(pre[..., :half] + b_t.to(acc))
    sg = torch.sigmoid(pre[..., half:] + b_s.to(acc))
    w_rs = w_rs[0].to(acc)
    d_act = (d_o.to(acc) @ w_rs[:, :C].T) * _inv_std(x.dtype).to(acc)
    if need_skip:
        d_act[:, L - skip_size :] += d_s.to(acc) @ w_rs[:, C:].T
    d_pre = torch.cat([d_act * sg * (1 - th * th), d_act * th * (sg * (1 - sg))], -1)
    return d_pre.to(x.dtype), (th * sg).to(x.dtype)


def glu_bwd_weight_grads_plain(x, d_pre, act, d_o, d_s, dilation: int, skip_size: int, rs_ld: int,
                               need_skip: bool = True):
    """The weight and bias gradients ``(d_w_t, d_w_s, d_b_t, d_b_s, d_w_rs, d_b_rs)`` in flax layout: sums over all
    ``B * L`` rows in at least f32, dO's share scaled by sqrt(1/2) after its sum, rounded once to x's dtype; the
    skip columns zero without the skip."""
    acc = _acc_dtype(x.dtype)
    B, T_in, C = x.shape
    L, half = d_pre.shape[1], act.shape[-1]
    rows = torch.cat([x[:, :L], x[:, dilation:]], -1).to(acc).reshape(-1, 2 * C)
    dp = d_pre.to(acc).reshape(-1, 2 * half)
    d_w_gate = rows.T @ dp  # (2C, 2 half): rows [tap 0 | tap 1], columns [tanh | sigmoid]
    d_b = dp.sum(0)
    inv_std = _inv_std(x.dtype).to(acc)
    act_a, d_o_a = act.to(acc), d_o.to(acc)
    d_w_r = (act_a.reshape(-1, half).T @ d_o_a.reshape(-1, C)) * inv_std
    d_b_r = d_o_a.reshape(-1, C).sum(0) * inv_std
    if need_skip:
        d_s_a = d_s.to(acc)
        d_w_k = act_a[:, L - skip_size :].reshape(-1, half).T @ d_s_a.reshape(-1, rs_ld - C)
        d_b_k = d_s_a.reshape(-1, rs_ld - C).sum(0)
    else:
        d_w_k, d_b_k = d_w_r.new_zeros((half, rs_ld - C)), d_w_r.new_zeros(rs_ld - C)
    grads = (torch.stack([d_w_gate[:C, :half], d_w_gate[C:, :half]]), torch.stack([d_w_gate[:C, half:],
                                                                                   d_w_gate[C:, half:]]),
             d_b[:half], d_b[half:], torch.cat([d_w_r, d_w_k], 1)[None], torch.cat([d_b_r, d_b_k]))
    return tuple(g.to(x.dtype) for g in grads)


def glu_bwd_pass_b_plain(w_t, w_s, d_pre, d_o, dilation: int, T_in: int):
    """Pass B: ``dx[r] = d_pre[r] W0^T + d_pre[r - d] W1^T + dO[r - d] sqrt(1/2)`` (B, T_in, C), products in at least
    f32, rounded once to d_pre's dtype."""
    acc = _acc_dtype(d_pre.dtype)
    B, L, _ = d_pre.shape
    C = w_t.shape[1]
    dp = d_pre.to(acc)
    dx = torch.zeros((B, T_in, C), dtype=acc, device=d_pre.device)
    dx[:, :L] += dp @ torch.cat([w_t[0], w_s[0]], 1).to(acc).T
    dx[:, dilation:] += dp @ torch.cat([w_t[1], w_s[1]], 1).to(acc).T + d_o.to(acc) * _inv_std(d_pre.dtype).to(acc)
    return dx.to(d_pre.dtype)


def residual_glu_backward_plain(x, w_t, w_s, b_t, b_s, w_rs, *, d_o, d_s, dilation: int, skip_size: int,
                                need_skip: bool = True):
    """The twin of the warpgroup route, :func:`residual_glu_backward`'s contract, split as its kernels split it:
    pass A, the weight gradients from its rounded ``d_pre`` and ``act``, pass B. In float64 it is the exact gradient
    (autograd of :func:`residual_glu_plain`)."""
    d_pre, act = glu_bwd_pass_a_plain(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, dilation, skip_size, need_skip)
    grads = glu_bwd_weight_grads_plain(x, d_pre, act, d_o, d_s, dilation, skip_size, w_rs.shape[-1], need_skip)
    return (glu_bwd_pass_b_plain(w_t, w_s, d_pre, d_o, dilation, x.shape[1]), *grads)


def _inv_std(dtype):
    """sqrt(1/2) in ``dtype``, the constant the forward multiplies by (JAX's takes x's dtype)."""
    return torch.tensor(math.sqrt(0.5), dtype=dtype)
