"""WaveNet building blocks, channels-last (port of ``blvm_tpu/models/wavenet/modules.py``).

Layout is (B, T, C) at every public function, as in the JAX package. Dilated
convs are VALID; the model left-pads the receptive field once. Parameters keep
the flax names and layouts (WIO conv kernels ``(k, C_in, C_out)``, the separate
``gate_kernel_t`` / ``gate_kernel_s`` branches and the joint ``rs_kernel``), so a
JAX parameter tree loads without transposes (:mod:`blvm_tpu_torch.weights`).

The residual-GLU block's k=2 path is :func:`residual_glu`: the K1 kernels
(``csrc/residual_glu.cu`` forward, ``csrc/residual_glu_bwd.cu`` backward) for
CUDA tensors, its plain twin :func:`residual_glu_plain` for CPU tensors.
"""

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from blvm_tpu_torch.modules.common import Dense, torch_uniform_
from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.conv_arithmetic import compute_conv_attributes

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
    ``(x, wg, bg, w1, b1)``; ``backward`` launches the backward kernel, which
    recomputes the gate from them (two passes: ``d_pre`` and ``act``, then
    ``dx``), and takes the weight and bias gradients, sums over all ``B * L``
    rows, as plain products on its outputs (cuBLAS, f32 accumulation), as the
    JAX backward left them to XLA. The backward kernel takes half <= 128 and
    R + S <= 256 in f32 and bf16 (the WaveNet widths), and STCN's C = half = R =
    256 in f32 (``K1_BWD_TILED_WIDTH``); both with the skip and skip-free. It
    raises for other widths (bf16 at C = 256 among them: no STCN run spec sets
    ``--bf16``). Without the skip the second output is an empty ``(B, 0, 0)``
    tensor, and the skip columns of ``rs_kernel`` and ``rs_bias`` get a zero
    gradient, as JAX's column slice ``rs_kernel[0, :, :R]`` gives them. Arguments
    were checked by :func:`residual_glu`."""

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
        x, w_t, w_s, b_t, b_s, w_rs = ctx.saved_tensors
        dilation, skip_size, need_skip = ctx.geometry
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
        return (dx, d_w_t, d_w_s, d_b[:half], d_b[half:], torch.cat(d_w_rs, dim=1)[None], torch.cat(d_b_rs),
                None, None, None)


class Conv1d(nn.Module):
    """VALID 1-D conv over (B, T, C) with a WIO kernel ``(k, C_in, C_out)``.

    ``dtype`` is the compute dtype; parameters stay f32 and are cast at use.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 1, dilation: int = 1,
                 use_bias: bool = True, dtype=None, device=None):
        super().__init__()
        self.dilation, self.dtype = dilation, dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.kernel.shape[0] * self.kernel.shape[1]
        torch_uniform_(self.kernel, fan_in, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel
        if self.dtype is not None:
            x, kernel = x.to(self.dtype), kernel.to(self.dtype)
        if kernel.shape[0] == 1:
            y = x @ kernel[0]
        else:
            # (k, C_in, C_out) -> torch's (C_out, C_in, k) over channels-first input
            y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), dilation=self.dilation).transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class CausalConv1d(nn.Module):
    """Causal conv: ``y[t]`` depends on ``x[:t]`` (not ``x[t]``), by dropping the
    last input frame before a VALID conv; the caller left-pads the receptive field."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1, device=None):
        super().__init__()
        self.Conv1d_0 = Conv1d(in_features, features, kernel_size=kernel_size, device=device)

    def forward(self, x: torch.Tensor, pad_causal: bool = True) -> torch.Tensor:
        if pad_causal:
            x = x[:, :-1]
        return self.Conv1d_0(x)


class Conv1dResidualGLU(nn.Module):
    """Dilated conv -> gated tanh -> 1x1 (res + skip) -> scaled residual add.

    ``fuse_gate_dots`` (a TPU-only ablation) is accepted and ignored.
    """

    def __init__(self, res_channels: int, skip_channels: Optional[int] = None, gate_channels: Optional[int] = None,
                 kernel_size: int = 2, dilation: int = 1, use_bias: bool = True, dtype=None,
                 fuse_gate_dots: bool = False, need_skip: bool = True, in_features: Optional[int] = None,
                 device=None):
        super().__init__()
        C_in = in_features or res_channels
        self.res_channels = res_channels
        self.skip_channels = skip_channels or res_channels
        half = (gate_channels or 2 * res_channels) // 2
        self.kernel_size, self.dilation, self.dtype, self.need_skip = kernel_size, dilation, dtype, need_skip
        RS = res_channels + self.skip_channels
        self.gate_kernel_t = nn.Parameter(torch.empty(kernel_size, C_in, half, device=device))
        self.gate_kernel_s = nn.Parameter(torch.empty(kernel_size, C_in, half, device=device))
        self.gate_bias_t = nn.Parameter(torch.empty(half, device=device))
        self.gate_bias_s = nn.Parameter(torch.empty(half, device=device))
        self.rs_kernel = nn.Parameter(torch.empty(1, half, RS, device=device))
        self.rs_bias = nn.Parameter(torch.empty(RS, device=device)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        k, C_in, half = self.gate_kernel_t.shape
        for p in (self.gate_kernel_t, self.gate_kernel_s, self.gate_bias_t, self.gate_bias_s):
            torch_uniform_(p, k * C_in, generator)
        torch_uniform_(self.rs_kernel, half, generator)
        if self.rs_bias is not None:
            torch_uniform_(self.rs_bias, half, generator)

    def forward(self, x: torch.Tensor, skip_size: int, need_skip: Optional[bool] = None):
        """``(o, s)``; ``need_skip`` (default: the block's own) False returns ``s = None``
        and contracts only the residual columns, as the JAX block does."""
        need_skip = self.need_skip if need_skip is None else need_skip
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        w_t, w_s, w_rs = (p.to(dtype) for p in (self.gate_kernel_t, self.gate_kernel_s, self.rs_kernel))
        b_t, b_s = self.gate_bias_t.to(dtype), self.gate_bias_s.to(dtype)
        b_rs = self.rs_bias.to(dtype) if self.rs_bias is not None else torch.zeros(w_rs.shape[-1], dtype=dtype,
                                                                                   device=x.device)
        if self.kernel_size == 2:
            return residual_glu(x, w_t, w_s, b_t, b_s, w_rs, b_rs, dilation=self.dilation, skip_size=skip_size,
                                need_skip=need_skip)
        if x.is_cuda:
            raise ValueError(f"no kernel takes a residual-GLU block of kernel_size {self.kernel_size} on the card")

        def branch(kernel, bias):
            y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), dilation=self.dilation).transpose(1, 2)
            return y + bias

        act = torch.tanh(branch(w_t, b_t)) * torch.sigmoid(branch(w_s, b_s))
        R = self.res_channels
        if need_skip:
            rs = act @ w_rs[0] + b_rs
            r, s = rs[..., :R], rs[..., R:][:, -skip_size:]
        else:
            r, s = act @ w_rs[0, :, :R] + b_rs[:R], None
        inv_std = torch.tensor(math.sqrt(0.5), dtype=dtype)
        return (r + x[:, -r.shape[1] :]) * inv_std, s


class ResidualStack(nn.Module):
    """``n_stacks`` repeats of ``n_layers`` residual blocks with dilations
    ``1, base, base*2, ...``, skips collected from every block. Starts with a
    1x1 ``in_transform`` conv (``Conv1d_0``), as the reference always does.

    ``remat`` and ``fuse_gate_dots`` (XLA scheduling knobs) are accepted and ignored.
    """

    def __init__(self, n_layers: int, n_stacks: int, res_channels: int, skip_channels: Optional[int] = None,
                 gate_channels: Optional[int] = None, kernel_size: int = 2, base_dilation: int = 2,
                 remat: bool = False, dtype=None, fuse_gate_dots: bool = False, in_features: Optional[int] = None,
                 device=None):
        super().__init__()
        self.n_layers, self.n_stacks, self.kernel_size, self.base_dilation = n_layers, n_stacks, kernel_size, base_dilation
        self.Conv1d_0 = Conv1d(in_features or res_channels, res_channels, kernel_size=1, dtype=dtype, device=device)
        self.blocks: List[Conv1dResidualGLU] = []
        for i, dilation in enumerate(self.build_dilations(n_layers, n_stacks, base_dilation)):
            block = Conv1dResidualGLU(res_channels, skip_channels, gate_channels, kernel_size, dilation,
                                      dtype=dtype, device=device)
            self.add_module(f"Conv1dResidualGLU_{i}", block)
            self.blocks.append(block)

    @staticmethod
    def build_dilations(n_layers: int, n_stacks: int, base_dilation: int) -> Sequence[int]:
        if base_dilation > 1:
            return [1, *[base_dilation * 2**i for i in range(0, n_layers - 1)]] * n_stacks
        return [1] * n_layers * n_stacks

    @staticmethod
    def compute_receptive_fields(n_layers: int, n_stacks: int, kernel_size: int, base_dilation: int):
        n = n_layers * n_stacks
        dilations = [1, *[base_dilation * 2**i for i in range(0, n_layers - 1)]] * n_stacks
        attrs = compute_conv_attributes([kernel_size] * n, [0] * n, [1] * n, dilations, return_all=True)
        return [a.receptive_field for a in attrs]

    @property
    def receptive_field(self) -> int:
        return self.compute_receptive_fields(self.n_layers, self.n_stacks, self.kernel_size, self.base_dilation)[-1]

    def forward(self, x: torch.Tensor, skip_size: int, collect_tails: bool = False,
                skip_mask: Optional[Sequence[bool]] = None):
        """Returns the per-block skips, each (B, skip_size, S), in block order.

        ``collect_tails`` (priming fast generation): also return each block's history
        tail, the last ``dilation`` frames of its input, whose final column is
        time-aligned with the stack's final output column; they seed the circular
        buffers of ``WaveNet.generate``'s and ``STCN.generate``'s frame loops. Returns
        ``(skips, tails)``.

        ``skip_mask`` (one bool per block, default all True): a block marked False runs
        without its skip (K1's skip-free mode on the card) and puts None in its place,
        as JAX's ``ResidualStack`` does for STCN, which reads every n-th skip only. The
        stack's last residual output is read by no caller, so the blocks after the last
        one whose skip is read reach no output and do not run (their places hold None), as
        XLA drops them from JAX's traced loop: a one-level STCN runs block 0 alone. With
        ``collect_tails`` every block runs, since the fast frame loop steps every block
        from its tail."""
        o = self.Conv1d_0(x)
        skips, tails = [], []
        if skip_mask is None:
            skip_mask = [True] * len(self.blocks)
        n_run = len(self.blocks) if collect_tails else max((i + 1 for i, m in enumerate(skip_mask) if m), default=0)
        for block, need_skip in zip(self.blocks[:n_run], skip_mask):
            if collect_tails:
                tails.append(o[:, -block.dilation :])
            o, s = block(o, skip_size, need_skip=need_skip)
            skips.append(s)
        skips += [None] * (len(self.blocks) - n_run)
        return (skips, tails) if collect_tails else skips


class PointwiseTransform(nn.Module):
    """Output head: ReLU -> Dense -> ReLU over (B, T, C)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, out_features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.Dense_0(torch.relu(x)))
