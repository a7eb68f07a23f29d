"""K11: the depthwise chain of a CW-VAE coder block (the part of ``blvm_tpu/models/clockwork_vae/conv_coders.py``
``BlockSeparable`` / ``_DepthwiseSeparable``, ``:70-88`` and ``:121-134``, between the block's two 1x1 products), and
K11-bwd, its backward.

From the expanded block input ``u = x W1 + b1`` ``(B, N_in, C)``: ReLU, the per-channel GroupNorm, the depthwise
conv (strided and dilated for the encoder, transposed for the decoder), + bias, ReLU and the second per-channel
GroupNorm, whose output feeds the block's pointwise 1x1. :func:`depthwise_norm_plain` is the plain twin, op for
op the JAX block; :func:`depthwise_norm_backward_plain` the twin of K11-bwd, op for op as JAX's autodiff
differentiates the block. :func:`depthwise_norm` is the entry point: for CPU tensors the twin, for CUDA tensors one
call of ``csrc/depthwise_norm.cu`` (its five passes on the caller's stream, counted as one launch of K11), float32
only. Where a gradient is needed it runs :class:`DepthwiseNormFunction`: the forward also hands back both
GroupNorms' statistics (:func:`depthwise_norm_save`; K11's save mode on the card), the backward is one
:func:`depthwise_norm_backward` (K11-bwd, ``csrc/depthwise_norm_bwd.cu``, on the card; six passes counted as one
launch), which recomputes ``g`` and ``y`` from ``u``.
"""

import torch

from typing import Tuple

from blvm_tpu_torch.modules.convolutions import (
    GROUP_NORM_EPSILON,
    depthwise_conv1d,
    depthwise_conv_transpose1d,
    group_norm_channels,
)
from blvm_tpu_torch.ops import cuda

# the kernel's row tiles (csrc/depthwise_norm.cu): at most the rows a statistics block sums and the output rows a conv
# block computes, and the blocks a pass aims at an SM, which shorter inputs get by smaller tiles; K11-bwd's passes
# (csrc/depthwise_norm_bwd.cu) take at most GRAD_ROWS rows a block, fewer partials of the taps' sums
STATS_ROWS, CONV_ROWS, GRAD_ROWS, BLOCKS_PER_SM, MAX_TAPS = 256, 128, 512, 4, 8


def tile_rows(rows: int, batch: int, most: int, target_blocks: int) -> int:
    """Rows a block of a K11 pass takes: enough blocks for the card (``target_blocks``), a multiple of 8, at most
    ``most``."""
    return min(most, -(-max(1, -(-rows * batch // target_blocks)) // 8) * 8)


def output_length(n_in: int, kernel_size: int, stride: int, dilation: int, transposed: bool) -> int:
    """Rows out of the depthwise conv: VALID ``(N - d(k-1) - 1) // s + 1``, or torch's transposed
    ``(N - 1) s + d(k-1) + 1``."""
    span = dilation * (kernel_size - 1)
    return (n_in - 1) * stride + span + 1 if transposed else (n_in - span - 1) // stride + 1


def depthwise_norm_plain(u: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor, kernel: torch.Tensor,
                         depthwise_bias: torch.Tensor, scale2: torch.Tensor, bias2: torch.Tensor, *, stride: int,
                         dilation: int, transposed: bool) -> torch.Tensor:
    """The chain in plain PyTorch: ``u (B, N_in, C)``, the GroupNorms' ``scale``/``bias`` ``(C,)``, the
    depthwise ``kernel (k, 1, C)`` and its bias; returns ``z (B, N_out, C)``."""
    g = group_norm_channels(torch.relu(u), scale1, bias1)
    if transposed:
        v = depthwise_conv_transpose1d(g, kernel, stride=stride, dilation=dilation)
    else:
        v = depthwise_conv1d(g, kernel, stride=stride, dilation=dilation)
    return group_norm_channels(torch.relu(v + depthwise_bias), scale2, bias2)


def _group_norm_save(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """:func:`group_norm_channels` and its statistics ``(B, C)`` each: the mean, the multiplier ``scale / sqrt(var +
    eps)``, ``1 / sqrt(var + eps)`` and the slope of ``var = max(E[x^2] - E[x]^2, 0)`` at its argument (1, 0.5 at 0
    as ``jnp.maximum``'s gradient splits a tie, 0 below)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=1, keepdim=True)
    spread = (xf * xf).mean(dim=1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(torch.clamp_min(spread, 0.0) + GROUP_NORM_EPSILON)
    mul = rstd * scale
    slope = torch.where(spread > 0, 1.0, torch.where(spread == 0, 0.5, 0.0)).to(xf.dtype)
    return (xf - mean) * mul + bias, [t[:, 0] for t in (mean, mul, rstd, slope)]


def _save_plain(u, scale1, bias1, kernel, depthwise_bias, scale2, bias2, *, stride, dilation, transposed):
    """The twin's ``(z, stats)``, ``stats (4, B, 2, C)`` laid out as K11's save mode writes it: GroupNorm 1's (mean,
    multiplier), GroupNorm 2's, then GroupNorm 1's (1 / sqrt(var + eps), variance slope) and GroupNorm 2's."""
    g, (m1, mul1, rstd1, slope1) = _group_norm_save(torch.relu(u), scale1, bias1)
    conv = depthwise_conv_transpose1d if transposed else depthwise_conv1d
    v = conv(g, kernel, stride=stride, dilation=dilation)
    z, (m2, mul2, rstd2, slope2) = _group_norm_save(torch.relu(v + depthwise_bias), scale2, bias2)
    pairs = ((m1, mul1), (m2, mul2), (rstd1, slope1), (rstd2, slope2))
    return z, torch.stack([torch.stack(p, dim=1) for p in pairs])


def _group_norm_backward(dy, x, mean, mul, rstd, slope, scale):
    """The backward of flax's ``GroupNorm(num_groups=C)`` as JAX's autodiff differentiates it, from the forward's
    statistics (each ``(B, 1, C)``): ``(dx, d scale, d bias)``."""
    n = x.shape[1]
    sa = dy.sum(dim=1, keepdim=True)
    centered = (dy * (x - mean)).sum(dim=1, keepdim=True)
    dvar = slope * (centered * scale * -0.5 * rstd * rstd * rstd)
    dmean = -mul * sa - 2.0 * mean * dvar
    dx = dy * mul + dmean / n + 2.0 * x * dvar / n
    return dx, (centered * rstd).sum(dim=(0, 1)), sa.sum(dim=(0, 1))


def _depthwise_conv_backward(dv, g, kernel, *, stride, dilation, transposed):
    """The depthwise conv's input and kernel gradients, ``(dg, dw (k, 1, C))``: the encoder's VALID correlation reads
    ``g[o s + j d]`` for output row ``o``, the decoder's transposed conv adds ``w_j g[i]`` into row ``i s + j d``."""
    k = kernel.shape[0]
    n_in, n_out = g.shape[1], dv.shape[1]
    dg = torch.zeros_like(g)
    dw = []
    for j in range(k):
        w_j = kernel[j, 0]
        if transposed:
            rows = dv[:, j * dilation: j * dilation + (n_in - 1) * stride + 1: stride]
            dg += w_j * rows
            dw.append((g * rows).sum(dim=(0, 1)))
        else:
            taps = slice(j * dilation, j * dilation + (n_out - 1) * stride + 1, stride)
            dg[:, taps] += w_j * dv
            dw.append((dv * g[:, taps]).sum(dim=(0, 1)))
    return dg, torch.stack(dw)[:, None, :]


def depthwise_norm_backward_plain(dz: torch.Tensor, u: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor,
                                  kernel: torch.Tensor, depthwise_bias: torch.Tensor, scale2: torch.Tensor,
                                  stats: torch.Tensor, *, stride: int, dilation: int,
                                  transposed: bool) -> Tuple[torch.Tensor, ...]:
    """The twin of K11-bwd: from the output gradient ``dz (B, N_out, C)``, the forward's inputs and its statistics
    ``stats (4, B, 2, C)`` (:func:`depthwise_norm_save`), the chain's backward op by op as JAX's autodiff
    differentiates it (ReLU's gradient 0 at 0; GroupNorm's through its mean and clamped fast variance), ``g`` and
    ``y`` recomputed from ``u``: ``(du, d scale1, d bias1, d kernel (k, 1, C), d depthwise_bias, d scale2, d
    bias2)``."""
    (m1, mul1), (m2, mul2), (rstd1, slope1), (rstd2, slope2) = (
        (stats[i, :, 0, None], stats[i, :, 1, None]) for i in range(4))
    r = torch.relu(u)
    g = (r - m1) * mul1 + bias1
    conv = depthwise_conv_transpose1d if transposed else depthwise_conv1d
    v = conv(g, kernel, stride=stride, dilation=dilation) + depthwise_bias
    y = torch.relu(v)
    dy, d_scale2, d_bias2 = _group_norm_backward(dz, y, m2, mul2, rstd2, slope2, scale2)
    dv = torch.where(v > 0, dy, torch.zeros_like(dy))
    dg, d_kernel = _depthwise_conv_backward(dv, g, kernel, stride=stride, dilation=dilation, transposed=transposed)
    dr, d_scale1, d_bias1 = _group_norm_backward(dg, r, m1, mul1, rstd1, slope1, scale1)
    du = torch.where(u > 0, dr, torch.zeros_like(dr))
    return du, d_scale1, d_bias1, d_kernel, dv.sum(dim=(0, 1)), d_scale2, d_bias2


class DepthwiseNormFunction(torch.autograd.Function):
    """The chain as one differentiable op: ``apply(stride, dilation, transposed, u, scale1, bias1, kernel,
    depthwise_bias, scale2, bias2)`` -> ``z``. The forward keeps both GroupNorms' statistics
    (:func:`depthwise_norm_save`); the backward is one :func:`depthwise_norm_backward` and returns the gradients of
    ``u`` and the six parameters."""

    @staticmethod
    def forward(ctx, stride, dilation, transposed, u, scale1, bias1, kernel, depthwise_bias, scale2, bias2):
        ctx.kw = dict(stride=stride, dilation=dilation, transposed=transposed)
        z, stats = depthwise_norm_save(u, scale1, bias1, kernel, depthwise_bias, scale2, bias2, **ctx.kw)
        ctx.save_for_backward(u, scale1, bias1, kernel, depthwise_bias, scale2, stats)
        return z

    @staticmethod
    def backward(ctx, dz):
        return (None, None, None, *depthwise_norm_backward(dz, *ctx.saved_tensors, **ctx.kw))


def depthwise_norm(u: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor, kernel: torch.Tensor,
                   depthwise_bias: torch.Tensor, scale2: torch.Tensor, bias2: torch.Tensor, *, stride: int,
                   dilation: int, transposed: bool) -> torch.Tensor:
    """:func:`depthwise_norm_plain`'s function. Without a gradient: CPU tensors, the twin; CUDA tensors, one call of
    K11, float32, ``C`` a multiple of 4 and at most 8 taps. With gradients enabled and an input that requires one:
    :class:`DepthwiseNormFunction` (on the card K11 in save mode forward and K11-bwd backward; on the CPU their
    twins). A refused dtype or shape raises."""
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)
    tensors = (u, scale1, bias1, kernel, depthwise_bias, scale2, bias2)
    if u.is_cuda:
        _check(tensors, **kw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return DepthwiseNormFunction.apply(stride, dilation, transposed, *tensors)
    if not u.is_cuda:
        return depthwise_norm_plain(*tensors, **kw)
    return _launch(tensors, save=False, **kw)


def depthwise_norm_save(u: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor, kernel: torch.Tensor,
                        depthwise_bias: torch.Tensor, scale2: torch.Tensor, bias2: torch.Tensor, *, stride: int,
                        dilation: int, transposed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of :class:`DepthwiseNormFunction`: ``(z, stats (4, B, 2, C))``. CPU tensors: the twin; CUDA
    tensors: one call of K11 in save mode (``z`` the same bits as without)."""
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)
    tensors = (u, scale1, bias1, kernel, depthwise_bias, scale2, bias2)
    if not u.is_cuda:
        return _save_plain(*tensors, **kw)
    _check(tensors, **kw)
    return _launch(tensors, save=True, **kw)


def _check(tensors, *, stride, dilation, transposed) -> int:
    """Raise on what K11 does not take; the output rows."""
    u, kernel = tensors[0], tensors[3]
    if any(t.device != u.device for t in tensors):
        raise ValueError("depthwise_norm: all inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise NotImplementedError("the depthwise_norm kernel (K11) takes float32 tensors only (bf16 coders are not "
                                  "ported to the card)")
    B, N_in, C = u.shape
    k = kernel.shape[0]
    if (tuple(kernel.shape) != (k, 1, C) or any(tuple(t.shape) != (C,) for t in tensors[1:3] + tensors[4:])
            or C % 4 or not 1 <= k <= MAX_TAPS):
        raise NotImplementedError(f"depthwise_norm (K11) takes u (B, N, C) with C a multiple of 4, a (k, 1, C) kernel "
                                  f"of at most {MAX_TAPS} taps and (C,) vectors; got u {tuple(u.shape)}, kernel "
                                  f"{tuple(kernel.shape)}")
    N_out = output_length(N_in, k, stride, dilation, transposed)
    if N_out < 1:
        raise ValueError(f"depthwise_norm: {N_in} input rows are fewer than the kernel's span of "
                         f"{dilation * (k - 1) + 1}")
    return N_out


def _target_blocks(device) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _launch(tensors, *, save, stride, dilation, transposed):
    """One call of K11: ``z``, and with ``save`` ``(z, stats (4, B, 2, C))``."""
    u, scale1, bias1, kernel, depthwise_bias, scale2, bias2 = tensors
    B, N_in, C = u.shape
    k = kernel.shape[0]
    N_out = output_length(N_in, k, stride, dilation, transposed)
    u = u.detach().contiguous()
    out = torch.empty((B, N_out, C), dtype=torch.float32, device=u.device)
    target_blocks = _target_blocks(u.device)
    stats_rows, conv_rows = tile_rows(N_in, B, STATS_ROWS, target_blocks), tile_rows(N_out, B, CONV_ROWS, target_blocks)
    tiles = max(-(-N_in // stats_rows), -(-N_out // conv_rows))
    part = torch.empty(B * tiles * 2 * C, dtype=torch.float64, device=u.device)
    stats = torch.empty((4 if save else 2, B, 2, C), dtype=torch.float32, device=u.device)
    w = kernel.detach()[:, 0, :].contiguous()
    vectors = [t.detach().contiguous() for t in (scale1, bias1, depthwise_bias, scale2, bias2)]
    lib = cuda.library()
    cuda.count_launch("depthwise_norm")
    err = lib.blvm_depthwise_norm(u.data_ptr(), vectors[0].data_ptr(), vectors[1].data_ptr(), w.data_ptr(),
                                  vectors[2].data_ptr(), vectors[3].data_ptr(), vectors[4].data_ptr(), out.data_ptr(),
                                  part.data_ptr(), stats.data_ptr(), part.numel(), B, N_in, N_out, C, k, stride,
                                  dilation, int(transposed), stats_rows, conv_rows, int(save), cuda.stream_handle(u))
    cuda.check(err, "depthwise_norm")
    return (out, stats) if save else out


def depthwise_norm_backward(dz: torch.Tensor, u: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor,
                            kernel: torch.Tensor, depthwise_bias: torch.Tensor, scale2: torch.Tensor,
                            stats: torch.Tensor, *, stride: int, dilation: int,
                            transposed: bool) -> Tuple[torch.Tensor, ...]:
    """The gradients :func:`depthwise_norm_backward_plain` gives. CPU tensors: that twin; CUDA tensors: one call of
    K11-bwd (its six passes counted as one launch), float32; a refused dtype or shape raises."""
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)
    if not u.is_cuda:
        return depthwise_norm_backward_plain(dz, u, scale1, bias1, kernel, depthwise_bias, scale2, stats, **kw)
    B, N_in, C = u.shape
    k = kernel.shape[0]
    N_out = _check((u, scale1, bias1, kernel, depthwise_bias, scale2), **kw)
    if (dz.device != u.device or dz.dtype != torch.float32 or stats.dtype != torch.float32
            or tuple(dz.shape) != (B, N_out, C) or tuple(stats.shape) != (4, B, 2, C) or stats.device != u.device):
        raise ValueError(f"depthwise_norm_backward: dz {tuple(dz.shape)} and stats {tuple(stats.shape)} must be "
                         f"float32 ({B}, {N_out}, {C}) and (4, {B}, 2, {C}) on {u.device} (K11's save mode)")
    dz, u, stats = dz.contiguous(), u.contiguous(), stats.contiguous()
    target_blocks = _target_blocks(u.device)
    in_rows, out_rows = tile_rows(N_in, B, GRAD_ROWS, target_blocks), tile_rows(N_out, B, GRAD_ROWS, target_blocks)
    tiles_out = -(-N_out // out_rows)
    du = torch.empty_like(u)
    dv = torch.empty((B, N_out, C), dtype=torch.float32, device=u.device)
    dparams = torch.empty((k + 5, C), dtype=torch.float32, device=u.device)
    coef = torch.empty(4 * B * C, dtype=torch.float32, device=u.device)
    part = torch.empty(B * tiles_out * 2 * C, dtype=torch.float64, device=u.device)
    part_w = torch.empty(B * tiles_out * (k + 1) * C, dtype=torch.float64, device=u.device)
    w = kernel[:, 0, :].contiguous()
    vectors = [t.contiguous() for t in (scale1, bias1, depthwise_bias, scale2)]
    lib = cuda.library()
    cuda.count_launch("depthwise_norm_bwd")
    err = lib.blvm_depthwise_norm_bwd(dz.data_ptr(), u.data_ptr(), vectors[0].data_ptr(), vectors[1].data_ptr(),
                                      w.data_ptr(), vectors[2].data_ptr(), vectors[3].data_ptr(), stats.data_ptr(),
                                      du.data_ptr(), dv.data_ptr(), dparams.data_ptr(), coef.data_ptr(),
                                      part.data_ptr(), part_w.data_ptr(), part.numel(), part_w.numel(), B, N_in, N_out,
                                      C, k, stride, dilation, int(transposed), in_rows, out_rows,
                                      cuda.stream_handle(u))
    cuda.check(err, "depthwise_norm_bwd")
    return (du, dparams[0], dparams[1], dparams[2:2 + k, None, :], dparams[k + 2], dparams[k + 3], dparams[k + 4])
