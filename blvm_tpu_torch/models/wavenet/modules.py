"""WaveNet building blocks, channels-last (port of ``blvm_tpu/models/wavenet/modules.py``).

Layout is (B, T, C) at every public function, as in the JAX package. Dilated
convs are VALID; the model left-pads the receptive field once. Parameters keep
the flax names and layouts (WIO conv kernels ``(k, C_in, C_out)``, the separate
``gate_kernel_t`` / ``gate_kernel_s`` branches and the joint ``rs_kernel``), so a
JAX parameter tree loads without transposes (:mod:`blvm_tpu_torch.weights`).

The residual-GLU block's k=2 path is :func:`residual_glu` (K1, ``ops/residual_glu.py``):
the K1 kernels for CUDA tensors, its plain twin :func:`residual_glu_plain` for CPU
tensors. A WaveNet's stacks, where every skip is read, run a stack at a time through
``ops/wavenet_stack.py`` (P2/P3, :meth:`ResidualStack.forward_summed`).
"""

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from blvm_tpu_torch.modules.common import Dense, torch_uniform_
from blvm_tpu_torch.ops import wavenet_stack as stack_ops
from blvm_tpu_torch.ops.conv_arithmetic import compute_conv_attributes
from blvm_tpu_torch.ops.residual_glu import residual_glu, residual_glu_plain  # noqa: F401 (re-exported)


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

    @property
    def fused(self) -> bool:
        """Whether :meth:`forward_summed` runs each stack as one fused call (P2/P3, ``ops/wavenet_stack.py``):
        k = 2 blocks with skip = res = gate / 2 at a width the kernel is built for
        (``wavenet_stack.KERNEL_WIDTHS``) and at most ``wavenet_stack.MAX_LAYERS`` blocks a stack. The
        configuration alone decides; a stack that is not fused runs one K1 call a block (:meth:`forward`)."""
        block = self.blocks[0]
        half = block.gate_kernel_t.shape[-1]
        return (self.kernel_size == 2 and block.skip_channels == block.res_channels == half
                and block.res_channels in stack_ops.KERNEL_WIDTHS and self.n_layers <= stack_ops.MAX_LAYERS)

    def forward_summed(self, x: torch.Tensor, skip_size: int, taps: Sequence[int] = ()):
        """Every block's skip read, no tails (a :attr:`fused` stack): ``(summed, tapped)``, the float32 sum
        (float64 for a float64 stack) of the blocks' skips in block order, ``(B, skip_size, S)``, and the skips of
        the blocks whose indices ``taps`` lists, in its order. One :func:`wavenet_stack` call a stack, each adding
        into the sum of the stacks before it; a gradient of a tap adds to its block's skip gradient."""
        o = self.Conv1d_0(x)
        o = o.to(self.blocks[0].dtype or o.dtype)
        summed, tapped = None, {}
        for first in range(0, len(self.blocks), self.n_layers):
            blocks = self.blocks[first : first + self.n_layers]
            local = [i - first for i in taps if first <= i < first + len(blocks)]
            o, summed, skips = stack_ops.wavenet_stack(o, stack_ops.pack_blocks(blocks, o.dtype),
                                                       [b.dilation for b in blocks], skip_size, local, summed)
            tapped.update(zip((first + i for i in local), skips))
        return summed, [tapped[i] for i in taps]

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
