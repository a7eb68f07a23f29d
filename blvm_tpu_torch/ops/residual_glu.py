"""K1: the k=2 residual-GLU block (port of the cut Pallas kernel
``1788a18^:blvm_tpu/ops/pallas/wavenet_block.py`` and its custom VJP, the block of
``blvm_tpu/models/wavenet/modules.py:146-202``).

:func:`residual_glu_plain` is the plain twin, op for op the JAX block.
:func:`residual_glu` is the entry point: for CPU tensors the twin (autograd gives its
gradient); for CUDA tensors the forward kernel ``csrc/residual_glu.cu`` and, under
autograd, :class:`ResidualGLUFunction`, whose backward is :func:`residual_glu_backward`
(``csrc/residual_glu_bwd.cu`` and the weight-gradient GEMMs), or it raises.
:func:`residual_glu_backward` is also the fused stack's backward, block by block
(``ops/wavenet_stack.py``).
"""

import math

import torch

from blvm_tpu_torch.ops import cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K1's limits (csrc/residual_glu.cu): MAX_C, MAX_HALF, MAX_RS (the widest accumulators, STCN's C = 256)
K1_MAX_CHANNELS, K1_MAX_HALF, K1_MAX_RES_PLUS_SKIP = 256, 256, 512
# K1-bwd's (csrc/residual_glu_bwd.cu): half <= 128 and R + S <= 256 (the WaveNet widths), or in f32 STCN's
# C = half = R = 256 with S = 256 or skip-free (the register-tiled path); both with or without the skip
K1_BWD_MAX_HALF, K1_BWD_MAX_RES_PLUS_SKIP, K1_BWD_TILED_WIDTH = 128, 256, 256


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
    inv_std = torch.tensor(math.sqrt(0.5), dtype=x.dtype)  # the JAX constant takes x's dtype
    return (r + x[:, -L:]) * inv_std, s


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


def residual_glu_backward(x, w_t, w_s, b_t, b_s, w_rs, *, d_o, d_s, dilation: int, skip_size: int,
                          need_skip: bool = True):
    """The gradient of one k=2 residual-GLU block from its input and weights and the gradients of its outputs:
    ``(dx, d_w_t, d_w_s, d_b_t, d_b_s, d_w_rs, d_b_rs)``, each in its input's dtype. The backward of
    :class:`ResidualGLUFunction` and, block after block, of the fused stack's ``WaveNetStackFunction``.

    The K1-bwd kernel, which recomputes the gate (two passes: ``d_pre`` and ``act``, then ``dx``),
    and the weight and bias gradients, sums over all ``B * L`` rows, as plain products on its outputs (cuBLAS, f32
    accumulation), as the JAX backward left them to XLA. The kernel takes half <= 128 and
    R + S <= 256 in f32 and bf16 (the WaveNet widths), and STCN's C = half = R = 256 in f32
    (``K1_BWD_TILED_WIDTH``); both with the skip and skip-free. It raises for other widths (bf16 at C = 256
    among them: no STCN run spec sets ``--bf16``). Without the skip the skip columns of ``rs_kernel`` and
    ``rs_bias`` get a zero gradient, as JAX's column slice ``rs_kernel[0, :, :R]`` gives them. CUDA tensors only
    (on the CPU autograd of :func:`residual_glu_plain` gives the gradient)."""
    B, T_in, C = x.shape
    half, rs_ld = w_t.shape[-1], w_rs.shape[-1]
    S = rs_ld - C if need_skip else 0
    tiled = C == half == K1_BWD_TILED_WIDTH and S in (0, C)
    if not (tiled and x.dtype == torch.float32) and (half > K1_BWD_MAX_HALF or C + S > K1_BWD_MAX_RES_PLUS_SKIP):
        raise NotImplementedError(
            f"residual_glu_bwd kernel takes half <= {K1_BWD_MAX_HALF} and R + S <= {K1_BWD_MAX_RES_PLUS_SKIP}, or "
            f"float32 at C = half = R = {K1_BWD_TILED_WIDTH} with S = {K1_BWD_TILED_WIDTH} or skip-free; got "
            f"C={C}, half={half}, R+S={C + S}, {x.dtype}")
    L = T_in - dilation
    # the kernel reads 16-byte rows: a view that starts off that alignment is copied (fresh tensors are aligned)
    x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (x, w_t, w_s, b_t, b_s, w_rs, d_o.to(x.dtype).contiguous(), d_s.to(x.dtype).contiguous()))
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
    inv_std = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
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
