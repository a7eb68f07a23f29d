"""Collation into padded ``(batch, seq_lens)`` numpy arrays (copy of ``TextBatcher`` and
``DynamicTensorBatcher`` of ``blvm_tpu/data/batchers.py``), with the padded length
rounded up by a :class:`~blvm_tpu_torch.data.buckets.BucketSpec`; rows added by
batch-size bucketing have length 0."""

from typing import List, Optional

import numpy as np

from blvm_tpu_torch.data.buckets import BucketSpec, bucket_length


class TextBatcher:
    """Pad integer lists to the (bucketed) max length."""

    def __init__(self, pad_value: int = 0, bucket: Optional[BucketSpec] = None) -> None:
        self.pad_value = pad_value
        self.bucket = bucket

    def __call__(self, batch: List[List[int]]):
        return self.collate(batch)

    def collate(self, batch: List[List[int]]):
        sequence_lengths = [len(text) for text in batch]
        T = bucket_length(max(sequence_lengths), self.bucket)
        rows = [list(text) + [self.pad_value] * (T - t) for t, text in zip(sequence_lengths, batch)]
        return np.asarray(rows, dtype=np.int64), np.asarray(sequence_lengths, dtype=np.int64)


class DynamicTensorBatcher:
    """Pad arrays along one dynamic axis to the (bucketed) max length and stack: ``(B', *, T', *)``,
    T' bucketed and B' optionally bucketed by appending all-padding rows of length 0."""

    def __init__(
        self,
        axis: int = -1,
        pad_value: float = 0,
        bucket: Optional[BucketSpec] = None,
        batch_size_bucket: Optional[BucketSpec] = None,
    ) -> None:
        self.axis = axis
        self.pad_value = pad_value
        self.bucket = bucket
        self.batch_size_bucket = batch_size_bucket

    def __call__(self, batch: List[np.ndarray]):
        return self.collate(batch)

    def collate(self, batch: List[np.ndarray]):
        batch = [np.asarray(a) for a in batch]
        axis = self.axis if self.axis >= 0 else batch[0].ndim + self.axis
        sequence_lengths = [a.shape[axis] for a in batch]

        N = len(batch)
        T = bucket_length(max(sequence_lengths), self.bucket)
        N_out = bucket_length(N, self.batch_size_bucket)

        collated_shape = list(batch[0].shape)
        collated_shape[axis] = T
        out = np.full([N_out] + collated_shape, self.pad_value, dtype=batch[0].dtype)
        for i, (a, sl) in enumerate(zip(batch, sequence_lengths)):
            sel = [i] + [slice(None)] * a.ndim
            sel[1 + axis] = slice(0, sl)
            out[tuple(sel)] = a

        seq_lens = np.zeros(N_out, dtype=np.int64)
        seq_lens[:N] = sequence_lengths
        return out, seq_lens
