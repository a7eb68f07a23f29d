"""Greedy CTC decoding on the host (copy of ``blvm_tpu/utils/decoding.py``; a row of length 0
decodes to nothing here, where the JAX copy raises an ``IndexError``)."""

from typing import List

import numpy as np


def greedy_ctc(logprobs, seq_lens, blank: int = 0) -> List[List[int]]:
    """Argmax -> collapse repeats -> drop blanks.

    Args:
        logprobs: ``(B, T, C)`` log-probabilities (or logits; argmax invariant).
        seq_lens: ``(B,)`` valid lengths.

    Returns a list of B decoded index sequences.
    """
    ids = np.asarray(logprobs).argmax(axis=-1)
    seq_lens = np.asarray(seq_lens)
    out = []
    for b in range(ids.shape[0]):
        seq = ids[b, : int(seq_lens[b])]
        if not len(seq):
            out.append([])
            continue
        collapsed = seq[np.insert(seq[1:] != seq[:-1], 0, True)]  # collapse repeats
        out.append(collapsed[collapsed != blank].tolist())  # drop blanks
    return out


def greedy_standard(logprobs, seq_lens) -> List[List[int]]:
    """Plain per-frame argmax decode truncated to sequence length."""
    ids = np.asarray(logprobs).argmax(axis=-1)
    seq_lens = np.asarray(seq_lens)
    return [ids[b, : int(seq_lens[b])].tolist() for b in range(ids.shape[0])]
