"""The warpgroup tile alone (``csrc/wgmma_tile.cu``, on ``csrc/wgmma_bf16.cuh``): ``D = A B`` for a 64-row A on one
warpgroup, bf16 operands, f32 accumulation, in each operand layout the wgmma kernels use (A K-major, A M-major, A in
registers; B N-major). It replaces no TPU kernel; a test on the card holds it to :func:`wgmma_tile_plain` before the
kernels that share the tile rely on it.
"""

import torch

from blvm_tpu_torch.ops import cuda

WIDTHS = (96, 192)  # the N the tile is instantiated for; from registers only 192


def wgmma_tile_plain(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False) -> torch.Tensor:
    """The twin: ``A B`` in float32, A given as (64, K) or, with ``trans_a``, as (K, 64); B as (K, N)."""
    return (a.float().T if trans_a else a.float()) @ b.float()


def wgmma_tile(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False, a_in_registers: bool = False) -> torch.Tensor:
    """:func:`wgmma_tile_plain`'s function; CPU tensors run the twin, CUDA tensors one launch of the tile kernel
    (bf16, N in :data:`WIDTHS`, K 16, 64 or 192), or raise. ``a_in_registers`` feeds A to wgmma
    as register fragments (N = 192, A K-major)."""
    if not a.is_cuda:
        return wgmma_tile_plain(a, b, trans_a)
    K, N = b.shape
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or b.device != a.device:
        raise TypeError("wgmma_tile: a and b must be bfloat16 on one CUDA device")
    if (tuple(a.shape) != ((K, 64) if trans_a else (64, K)) or N not in WIDTHS or K not in (16, 64, 192)
            or (a_in_registers and (N != 192 or trans_a))):
        raise ValueError(f"wgmma_tile: a {tuple(a.shape)}, b {tuple(b.shape)}, trans_a={trans_a}, "
                         f"a_in_registers={a_in_registers}: not a tile it takes")
    a, b = a.contiguous(), b.contiguous()
    d = torch.empty((64, N), dtype=torch.float32, device=a.device)
    lib = cuda.library()
    cuda.count_launch("wgmma_tile")
    err = lib.blvm_wgmma_tile(a.data_ptr(), b.data_ptr(), d.data_ptr(), N, K, int(trans_a), int(a_in_registers),
                              cuda.stream_handle(a))
    cuda.check(err, "wgmma_tile")
    return d
