"""SimpleLSTMASR, the CTC probe classifier over spectrograms or representations (port of
``blvm_tpu/models/lstm_asr.py``).

An :class:`~blvm_tpu_torch.modules.lstm_block.LSTMBlock` (K6 a bidirectional layer on the card), a
dense head over the vocabulary, ``log_softmax`` and the CTC loss
(:func:`~blvm_tpu_torch.ops.ctc.ctc_loss`, optax's values, K13 on the card); ``loss = sum of
per-example losses / sum(y_sl)``. Decoding and the error rates run on the host in :meth:`SimpleLSTMASR.build_metrics`:
the greedy CTC decode, then WER and CER against the references.
"""

from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from blvm_tpu_torch.data.token_map import TokenMap
from blvm_tpu_torch.data.tokenizers import char_tokenizer, word_tokenizer
from blvm_tpu_torch.data.tokens import BLANK_TOKEN
from blvm_tpu_torch.evaluation.metrics import ErrorRateMetric, LossMetric
from blvm_tpu_torch.models.base import BaseModel
from blvm_tpu_torch.modules.common import Dense
from blvm_tpu_torch.modules.lstm_block import LSTMBlock
from blvm_tpu_torch.ops import ctc as ctc_ops
from blvm_tpu_torch.utils.decoding import greedy_ctc


class SimpleLSTMASR(BaseModel):
    """Keyword arguments and defaults are the flax ``SimpleLSTMASR``'s fields. The vocabulary is a
    tuple (blank at ``blank_index``; :class:`TokenMap` puts it at 0); ``unroll`` only schedules XLA
    and is ignored. Dropout (``self.training``) draws from the forward's ``generator``."""

    def __init__(self, vocab: Sequence[str], input_size: int = 80, hidden_size: int = 256, num_layers: int = 1,
                 bidirectional: bool = False, sum_directions: bool = False, dropout_prob: float = 0.0,
                 temporal_dropout: bool = True, blank_index: int = 0, unroll: int = 1, device=None):
        vocab = tuple(vocab)
        super().__init__(vocab=vocab, input_size=input_size, hidden_size=hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional, sum_directions=sum_directions, dropout_prob=dropout_prob,
                         temporal_dropout=temporal_dropout, blank_index=blank_index, unroll=unroll)
        self.vocab, self.input_size, self.blank_index = vocab, input_size, blank_index
        self.lstm = LSTMBlock(input_size, hidden_size, num_layers=num_layers, bidirectional=bidirectional,
                              sum_directions=sum_directions, dropout_prob=dropout_prob,
                              temporal_dropout=temporal_dropout, device=device)
        self.output = Dense(self.lstm.output_size, len(vocab), device=device)

    @classmethod
    def from_token_map(cls, token_map: TokenMap, **kwargs) -> "SimpleLSTMASR":
        return cls(vocab=tuple(token_map.tokens), blank_index=token_map.token2index[BLANK_TOKEN], **kwargs)

    def token_map(self) -> TokenMap:
        tm = TokenMap.__new__(TokenMap)
        tm.tokens = list(self.vocab)
        tm.token2index = {t: i for i, t in enumerate(tm.tokens)}
        tm.index2token = {i: t for i, t in enumerate(tm.tokens)}
        tm.add_unknown = False
        tm.prefix = tm.suffix = ""
        return tm

    def forward(self, x: torch.Tensor, x_sl: torch.Tensor, y: torch.Tensor, y_sl: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``x (B, T, D)`` features, ``y (B, N)`` integer targets, each with its lengths:
        ``(loss, mets, outputs)``."""
        x = x.to(self.output.kernel.dtype)  # as JAX promotes the features to the parameters' type
        z, z_sl = self.lstm(x, x_sl, deterministic=not self.training, generator=generator)
        logits = self.output(z)  # (B, T, O)
        per_example = ctc_ops.ctc_loss(logits, z_sl, y, y_sl, blank=self.blank_index)
        loss = per_example.sum() / y_sl.sum()
        mets = dict(loss=loss, per_example=per_example, logits=logits, z_sl=z_sl, y=y, y_sl=y_sl)
        outputs = SimpleNamespace(logits=logits, sl=z_sl)
        return loss, mets, outputs

    def build_metrics(self, mets: dict):
        """Host-side: ``(metrics, hyps, refs)``, the greedy decode of the rows with labels and the loss,
        WER and CER metrics (``blvm_tpu/models/lstm_asr.py:88-114``). Zero-length padded rows are
        dropped: their empty references would dilute WER and CER."""
        token_map = self.token_map()
        logits, z_sl, y, y_sl = (np.asarray(mets[k]) for k in ("logits", "z_sl", "y", "y_sl"))
        active = y_sl > 0
        if not active.all():
            logits, z_sl, y, y_sl = logits[active], z_sl[active], y[active], y_sl[active]

        hyps_raw = greedy_ctc(logits, z_sl, blank=self.blank_index)
        hyps = [token_map.decode(h, " ") for h in hyps_raw]
        refs = token_map.decode_batch(y, y_sl, " ")

        return [
            LossMetric(mets["loss"], weight_by=float(y_sl.sum())),
            ErrorRateMetric(refs, hyps, word_tokenizer, name="wer"),
            ErrorRateMetric(refs, hyps, char_tokenizer, name="cer"),
        ], hyps, refs

    def example_inputs(self):
        device = self.output.kernel.device
        x = torch.zeros((1, 8, self.input_size), dtype=torch.float32, device=device)
        return (x, torch.tensor([8], device=device), torch.zeros((1, 4), dtype=torch.int64, device=device),
                torch.tensor([4], device=device)), {}
