"""Sequence tensor operations: masking, frame (de)stacking, chunking.

Port of ``blvm_tpu/ops/sequence.py`` with the same batch-first ``(B, T, *)``
layout. ``split_sequence`` is host-side numpy, as in the JAX package: it
returns Python lists of chunks with per-chunk lengths, keeps the full batch in
every chunk (ended examples get length 0) and never drops rows.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sequence_mask(seq_lens: torch.Tensor, max_len: Optional[int] = None, stride: int = 1, dtype=torch.bool):
    """Binary mask ``(B, T)``: 1 where ``t < ceil(seq_len / stride)``, else 0
    (reference ``operations.py:90-119``). ``max_len`` defaults to
    ``ceil(max(seq_lens) / stride)``."""
    seq_lens = torch.as_tensor(seq_lens)
    if max_len is None:
        max_len = int(math.ceil(int(seq_lens.max()) / stride))
    t = torch.arange(max_len, device=seq_lens.device)
    lens = torch.ceil(seq_lens / stride) if stride != 1 else seq_lens
    return (t[None, :] < lens[:, None]).to(dtype)


def stack_tensor(x: torch.Tensor, stack_size: int, axis: int = -1) -> Tuple[torch.Tensor, int]:
    """Split ``axis`` into frames of ``stack_size`` with a new trailing stack dim.

    ``(..., D, ...) -> (..., D/S, ..., S)`` with right zero-padding to a multiple
    of ``stack_size``; returns ``(stacked, padding)`` (reference ``operations.py:14-32``).
    """
    if abs(axis) > x.ndim:
        raise ValueError(f"Got {axis=} which is out of range for x with shape {tuple(x.shape)}")
    axis = axis if axis >= 0 else x.ndim + axis

    padding = (-x.shape[axis]) % stack_size
    if padding:
        # F.pad lists (left, right) pairs from the last dim backwards
        pad = [0, 0] * (x.ndim - 1 - axis) + [0, padding]
        x = F.pad(x, pad)

    split_shape = list(x.shape)
    split_shape[axis : axis + 1] = [x.shape[axis] // stack_size, stack_size]
    x = x.reshape(split_shape)
    return torch.movedim(x, axis + 1, -1), padding


def unstack_tensor(x: torch.Tensor, stack_size: int, padding: int = 0, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`stack_tensor`: collapse the trailing stack dim back into
    ``axis`` (interpreted on the output array) and strip any right padding."""
    if abs(axis) > x.ndim - 1:
        raise ValueError(f"Got {axis=} which is out of range for x with shape {tuple(x.shape)}")
    out_ndim = x.ndim - 1
    axis = axis if axis >= 0 else out_ndim + axis

    x = torch.movedim(x, -1, axis + 1)
    new_shape = list(x.shape)
    new_shape[axis : axis + 2] = [x.shape[axis] * stack_size]
    x = x.reshape(new_shape)
    if padding:
        x = x.narrow(axis, 0, x.shape[axis] - padding)
    return x


def _chunk_geometry(T: int, length: int, overlap: int, mode: str):
    """Start/stop indices of each chunk for the two chunking modes.

    consume: chunk len = length, overlap consumes from new values (reference
    ``operations.py:161-166``). extend: chunk len = length + overlap, always
    ``length`` new values (``operations.py:167-170``).
    """
    if mode == "consume":
        if overlap >= length:
            raise ValueError("`split_sequence` does not support `overlap >= length` in `consume` mode")
        n = math.ceil(T / (length - overlap))
        starts = [i * (length - overlap) for i in range(n)]
        stops = [s + length for s in starts]
    elif mode == "extend":
        n = math.ceil(T / length)
        starts = [max(i * length - overlap, 0) for i in range(n)]
        stops = [(i + 1) * length for i in range(n)]
    else:
        raise ValueError(f"Unknown mode `{mode}`. Recognized options are `consume` and `extend`.")
    return starts, stops


def split_lengths(x_sl: np.ndarray, starts, stops):
    """Per-chunk sequence lengths: the chunk's full data length while the
    example is still active, the remainder in the first chunk that reaches its
    end, 0 after. An example only counts as active in chunk ``i`` if it extends
    beyond chunk ``i-1``'s new-frame boundary, so tail frames in an overlap
    region are never scored twice (see ``blvm_tpu/ops/sequence.py``)."""
    x_sl = np.asarray(x_sl)
    out = []
    prev_stop = 0
    for start, stop in zip(starts, stops):
        entered = x_sl > prev_stop
        active_next = x_sl > stop
        sl = np.where(active_next, stop - start, np.clip(x_sl - start, 0, None))
        out.append(np.where(entered, sl, 0))
        prev_stop = stop
    return out


def split_sequence(x, x_sl, length: int, overlap: int = 0, mode: str = "consume") -> Tuple[list, list]:
    """Host-side chunking of ``(B, T, *)`` numpy data into subsequences along T.

    Returns ``(chunks, chunk_lens)`` lists. Trailing chunks where no example is
    active are omitted. In extend mode, chunks after the first whose overlap
    context is cut by the sequence start are left-padded with zeros to the
    uniform ``length + overlap`` and the pad is counted in their lengths; chunk
    0 stays data-only (consumers rf-pad it through their first-chunk path).
    """
    x = np.asarray(x)
    starts, stops = _chunk_geometry(x.shape[1], length, overlap, mode)
    lens = split_lengths(x_sl, starts, stops)

    chunks, chunk_lens = [], []
    for i, ((start, stop), sl) in enumerate(zip(zip(starts, stops), lens)):
        if not np.any(sl > 0):
            break
        chunk = x[:, start:stop]
        if chunk.shape[1] < stop - start:  # right-pad final short chunk to static length
            pad = [(0, 0)] * x.ndim
            pad[1] = (0, stop - start - chunk.shape[1])
            chunk = np.pad(chunk, pad)
        if mode == "extend" and i > 0 and stop - start < length + overlap:
            left = length + overlap - (stop - start)
            pad = [(0, 0)] * x.ndim
            pad[1] = (left, 0)
            chunk = np.pad(chunk, pad)
            sl = np.where(sl > 0, sl + left, 0)
        chunks.append(chunk)
        chunk_lens.append(sl)
    return chunks, chunk_lens


def update_running_variance(mean_a, weight_a, M2_a, mean_b=0, weight_b=0, M2_b=0):
    """Parallel Welford variance update (reference ``operations.py:200-242``).

    Returns ``(var, mean, weight, M2)``. Works on floats, numpy arrays or tensors.
    """
    weight = weight_a + weight_b
    delta = mean_b - mean_a
    M2 = M2_a + M2_b + delta**2 * (weight_a * weight_b / weight)
    var = M2 / (weight - 1)
    mean = (weight_a * mean_a + weight_b * mean_b) / weight
    return var, mean, weight, M2
