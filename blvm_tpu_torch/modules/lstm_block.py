"""Stacked (bi)LSTM block with temporal dropout (port of ``blvm_tpu/modules/lstm_block.py``).

Each layer of a bidirectional block is one time-parallel product ``x [W_ih[0] | W_ih[1]]`` for
both directions' input projections, then one call of
:func:`~blvm_tpu_torch.ops.recurrent.bilstm_recurrence` (K6 on the card): direction 1 runs over
the whole padded sequence reversed, padding first, and its outputs land in forward time order,
as the JAX block's flips put them (pad_packed_sequence semantics, zeros past each length). The
directions come out concatenated, ``(B, T, 2H)``, or summed under ``sum_directions``. A
unidirectional block runs the port's :class:`~blvm_tpu_torch.modules.recurrent.LSTM` (K5).
Dropout, when not ``deterministic``, follows every layer, the last one too: a keep mask of shape
``(B, 1, F)`` a layer under ``temporal_dropout`` (fixed over time), else of the layer's whole
output, drawn from the caller's generator. Parameters keep the flax names: ``fwd_{i}`` and
``bwd_{i}``, each an LSTM holding ``w_ih_0``, ``b_ih_0``, ``w_hh_0``, ``b_hh_0``.
"""

from typing import Optional

import torch
from torch import nn

from blvm_tpu_torch.modules.recurrent import LSTM
from blvm_tpu_torch.ops import recurrent as recurrent_ops
from blvm_tpu_torch.ops.sequence import sequence_mask


class LSTMBlock(nn.Module):
    """Keyword arguments and defaults are the flax ``LSTMBlock``'s fields, with ``input_size`` first;
    ``fuse_directions`` and ``unroll`` only schedule XLA in the JAX package (the same math) and are
    accepted and ignored."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, bidirectional: bool = True,
                 sum_directions: bool = False, dropout_prob: float = 0.40, temporal_dropout: bool = True,
                 return_all: bool = False, fuse_directions: bool = True, unroll: int = 1, device=None):
        super().__init__()
        del fuse_directions, unroll
        if sum_directions and not bidirectional:
            raise ValueError("LSTM block must be bidirectional to sum directions.")
        self.hidden_size, self.num_layers, self.bidirectional = hidden_size, num_layers, bidirectional
        self.sum_directions, self.dropout_prob, self.temporal_dropout = sum_directions, dropout_prob, temporal_dropout
        self.return_all = return_all
        width = hidden_size if sum_directions or not bidirectional else 2 * hidden_size
        for idx in range(num_layers):
            in_features = input_size if idx == 0 else width
            setattr(self, f"fwd_{idx}", LSTM(in_features, hidden_size, device=device))
            if bidirectional:
                setattr(self, f"bwd_{idx}", LSTM(in_features, hidden_size, device=device))

    @property
    def output_size(self) -> int:
        return self.hidden_size if self.sum_directions or not self.bidirectional else 2 * self.hidden_size

    def forward(self, x: torch.Tensor, x_sl: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``x (B, T, D)``, ``x_sl (B,)``: ``(out (B, T, H or 2H), x_sl)``, or under ``return_all`` the
        list of every layer's output (after its dropout) in place of ``out``."""
        mask = sequence_mask(x_sl, max_len=x.shape[1], dtype=x.dtype)
        H = self.hidden_size
        outputs = []
        for idx in range(self.num_layers):
            fwd = getattr(self, f"fwd_{idx}")
            if self.bidirectional:
                bwd = getattr(self, f"bwd_{idx}")
                w_ih = torch.cat([fwd.w_ih_0, bwd.w_ih_0], dim=1)  # (D, 8H): both projections in one product
                b_ih = torch.cat([fwd.b_ih_0, bwd.b_ih_0])
                w_hh = torch.stack([fwd.w_hh_0, bwd.w_hh_0])
                b_hh = torch.stack([fwd.b_hh_0, bwd.b_hh_0])
                x = recurrent_ops.bilstm_recurrence(x @ w_ih + b_ih, w_hh, b_hh, mask)
                if self.sum_directions:
                    x = x[..., :H] + x[..., H:]
            else:
                x, _ = fwd(x, mask=mask)
            if self.dropout_prob > 0 and not deterministic:
                keep_prob = 1.0 - self.dropout_prob
                shape = (x.shape[0], 1, x.shape[-1]) if self.temporal_dropout else x.shape
                keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
                x = torch.where(keep, x / keep_prob, 0.0)
            outputs.append(x)
        if self.return_all:
            return outputs, x_sl
        return x, x_sl
