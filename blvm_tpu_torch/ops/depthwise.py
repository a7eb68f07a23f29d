"""K11: the depthwise chain of a CW-VAE coder block (the part of ``blvm_tpu/models/clockwork_vae/conv_coders.py``
``BlockSeparable`` / ``_DepthwiseSeparable``, ``:70-88`` and ``:121-134``, between the block's two 1x1 products).

From the expanded block input ``u = x W1 + b1`` ``(B, N_in, C)``: ReLU, the per-channel GroupNorm, the depthwise
conv (strided and dilated for the encoder, transposed for the decoder), + bias, ReLU and the second per-channel
GroupNorm, whose output feeds the block's pointwise 1x1. :func:`depthwise_norm_plain` is the plain twin, op for
op the JAX block; :func:`depthwise_norm` is the entry point: for CPU tensors the twin, for CUDA tensors one call
of ``csrc/depthwise_norm.cu`` (its five passes on the caller's stream, counted as one launch of K11), float32
only. K11 has no backward yet: under a gradient on the card it raises.
"""

import torch

from blvm_tpu_torch.modules.convolutions import depthwise_conv1d, depthwise_conv_transpose1d, group_norm_channels
from blvm_tpu_torch.ops import cuda

# the kernel's row tiles (csrc/depthwise_norm.cu): at most the rows a statistics block sums and the output rows a conv
# block computes, and the blocks a pass aims at an SM, which shorter inputs get by smaller tiles
STATS_ROWS, CONV_ROWS, BLOCKS_PER_SM, MAX_TAPS = 256, 128, 4, 8


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


def depthwise_norm(u: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor, kernel: torch.Tensor,
                   depthwise_bias: torch.Tensor, scale2: torch.Tensor, bias2: torch.Tensor, *, stride: int,
                   dilation: int, transposed: bool) -> torch.Tensor:
    """:func:`depthwise_norm_plain`'s function. CPU tensors: the twin (with autograd's gradient). CUDA
    tensors: one call of K11, float32, ``C`` a multiple of 4 and at most 8 taps; under a gradient it
    raises ``NotImplementedError`` (K11-bwd is not written yet), a refused dtype or shape raises too."""
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)
    tensors = (u, scale1, bias1, kernel, depthwise_bias, scale2, bias2)
    if not u.is_cuda:
        return depthwise_norm_plain(*tensors, **kw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("depthwise_norm (K11) has no backward on the card yet; run the CW-VAE's coders "
                                  "under torch.no_grad() or torch.inference_mode()")
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
    u = u.contiguous()
    out = torch.empty((B, N_out, C), dtype=torch.float32, device=u.device)
    target_blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(u.device).multi_processor_count
    stats_rows, conv_rows = tile_rows(N_in, B, STATS_ROWS, target_blocks), tile_rows(N_out, B, CONV_ROWS, target_blocks)
    tiles = max(-(-N_in // stats_rows), -(-N_out // conv_rows))
    part = torch.empty(B * tiles * 2 * C, dtype=torch.float64, device=u.device)
    stats = torch.empty(4 * B * C, dtype=torch.float32, device=u.device)
    w = kernel[:, 0, :].contiguous()
    vectors = [t.contiguous() for t in (scale1, bias1, depthwise_bias, scale2, bias2)]
    lib = cuda.library()
    cuda.count_launch("depthwise_norm")
    err = lib.blvm_depthwise_norm(u.data_ptr(), vectors[0].data_ptr(), vectors[1].data_ptr(), w.data_ptr(),
                                  vectors[2].data_ptr(), vectors[3].data_ptr(), vectors[4].data_ptr(), out.data_ptr(),
                                  part.data_ptr(), stats.data_ptr(), part.numel(), B, N_in, N_out, C, k, stride,
                                  dilation, int(transposed), stats_rows, conv_rows, cuda.stream_handle(u))
    cuda.check(err, "depthwise_norm")
    return out
