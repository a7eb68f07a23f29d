"""Recurrent cores (port of ``blvm_tpu/modules/recurrent.py``: the LSTM, the GRU cell and the GRU).

As in the JAX package, the input projection ``x @ W_ih + b_ih`` of every step is
one time-parallel product, and only ``h @ W_hh`` runs inside the recurrence, which
is :func:`blvm_tpu_torch.ops.recurrent.lstm_recurrence` (the K5 kernel on CUDA
tensors) or :func:`~blvm_tpu_torch.ops.recurrent.gru_recurrence` (K7), their plain
twins on CPU tensors. Parameters keep the flax names and layouts (``w_ih_{l}``
``(D, 4H)``, ``b_ih_{l}``, ``w_hh_{l}`` ``(H, 4H)``, ``b_hh_{l}``; the GRU's ``w_ih
(D, 3H)``, ``b_ih``, ``w_hh (H, 3H)``, ``b_hh``) and torch's U(-1/sqrt(H), 1/sqrt(H))
init. :class:`GRUCell` is one step of torch's GRU (gate order r, z, n; the reset gate
multiplies ``h W_hn + b_hn``), the cell the VRNN runs inside K8; :class:`GRU` runs the
same step over a sequence with a mask, SRNN's two recurrences.
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from blvm_tpu_torch.ops import recurrent as recurrent_ops


class LSTM(nn.Module):
    """Stacked unidirectional LSTM over ``(B, T, D)`` with per-example lengths.

    ``forward`` returns ``(outputs (B, T, H), (h_n, c_n))``, ``h_n`` and ``c_n`` of
    shape ``(num_layers, B, H)``: the state at each sequence's true end; outputs past
    a sequence's length are zero. ``dtype`` is the compute dtype (inputs, weights and
    state are cast to it, as JAX casts them); ``unroll`` only schedules XLA in the JAX
    package and is accepted and ignored. Dropout between layers, when not
    ``deterministic``, draws from ``generator``.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, dropout: float = 0.0, dtype=None,
                 unroll: int = 1, device=None):
        super().__init__()
        del unroll
        self.hidden_size, self.num_layers, self.dropout, self.dtype = hidden_size, num_layers, dropout, dtype
        G = 4 * hidden_size
        for layer in range(num_layers):  # flax's creation order: w_ih, b_ih, w_hh, b_hh
            in_features = input_size if layer == 0 else hidden_size
            self.register_parameter(f"w_ih_{layer}", nn.Parameter(torch.empty(in_features, G, device=device)))
            self.register_parameter(f"b_ih_{layer}", nn.Parameter(torch.empty(G, device=device)))
            self.register_parameter(f"w_hh_{layer}", nn.Parameter(torch.empty(hidden_size, G, device=device)))
            self.register_parameter(f"b_hh_{layer}", nn.Parameter(torch.empty(G, device=device)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        B, H = x.shape[0], self.hidden_size
        if self.dtype is not None:
            x = x.to(self.dtype)
        if initial_state is None:
            h_0 = c_0 = torch.zeros((self.num_layers, B, H), dtype=x.dtype, device=x.device)
        else:
            h_0, c_0 = (s.to(x.dtype) for s in initial_state)
        if mask is not None:
            mask = mask.to(x.dtype)

        h_ns, c_ns = [], []
        layer_in = x
        for layer in range(self.num_layers):
            w_ih, b_ih, w_hh, b_hh = (getattr(self, f"{n}_{layer}") for n in ("w_ih", "b_ih", "w_hh", "b_hh"))
            if self.dtype is not None:
                w_ih, b_ih, w_hh, b_hh = (w.to(self.dtype) for w in (w_ih, b_ih, w_hh, b_hh))
            xw = layer_in @ w_ih + b_ih  # (B, T, 4H): the time-parallel input projection
            layer_in, h_n, c_n = recurrent_ops.lstm_recurrence(xw, w_hh, b_hh, mask, h_0[layer], c_0[layer])
            h_ns.append(h_n)
            c_ns.append(c_n)
            if self.dropout > 0 and layer < self.num_layers - 1 and not deterministic:
                keep = torch.rand(layer_in.shape, generator=generator, device=layer_in.device) < 1.0 - self.dropout
                layer_in = torch.where(keep, layer_in / (1.0 - self.dropout), 0.0)
        return layer_in, (torch.stack(h_ns), torch.stack(c_ns))


class GRUCell(nn.Module):
    """One GRU step with torch's gate math (``blvm_tpu/modules/recurrent.py:117-145``):
    ``forward(x (*, D), h (*, H)) -> h'``. Parameters ``w_ih (D, 3H)``, ``b_ih``,
    ``w_hh (H, 3H)``, ``b_hh``; U(-1/sqrt(H), 1/sqrt(H)) init, ``w_hh`` orthogonal
    under ``orthogonal_hh`` (as the VRNN's cell has it; the SRNN's gated transfer cell,
    ``blvm_tpu/models/srnn.py:66``, does not)."""

    def __init__(self, input_size: int, hidden_size: int, orthogonal_hh: bool = False, device=None):
        super().__init__()
        self.hidden_size, self.orthogonal_hh = hidden_size, orthogonal_hh
        G = 3 * hidden_size  # flax's creation order: w_ih, b_ih, w_hh, b_hh
        self.w_ih = nn.Parameter(torch.empty(input_size, G, device=device))
        self.b_ih = nn.Parameter(torch.empty(G, device=device))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, G, device=device))
        self.b_hh = nn.Parameter(torch.empty(G, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)
            if self.orthogonal_hh:
                nn.init.orthogonal_(self.w_hh, generator=generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return recurrent_ops.gru_update(x @ self.w_ih + self.b_ih, h @ self.w_hh + self.b_hh, h)


class GRU(nn.Module):
    """Unidirectional GRU over ``(B, T, D)`` with a time-parallel input projection
    (``blvm_tpu/modules/recurrent.py:148-190``).

    ``forward(x, mask=None, initial_state=None)`` returns ``(outputs (B, T, H), h_n (B, H))``:
    ``outputs`` are ``h_new * m``, ``h_n`` the state after the last step, frozen wherever
    the mask ``(B, T)`` is 0 (any 0/1 pattern: SRNN's backward GRU runs over a full flip,
    its zeros leading). Parameters ``w_ih (D, 3H)``, ``b_ih``, ``w_hh (H, 3H)``, ``b_hh``,
    all U(-1/sqrt(H), 1/sqrt(H)) (no orthogonal draw). ``x @ w_ih + b_ih`` is one product
    over all steps; the recurrence is :func:`~blvm_tpu_torch.ops.recurrent.gru_recurrence`.
    """

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        G = 3 * hidden_size  # flax's creation order: w_ih, b_ih, w_hh, b_hh
        self.w_ih = nn.Parameter(torch.empty(input_size, G, device=device))
        self.b_ih = nn.Parameter(torch.empty(G, device=device))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, G, device=device))
        self.b_hh = nn.Parameter(torch.empty(G, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        B = x.shape[0]
        h_0 = (torch.zeros((B, self.hidden_size), dtype=x.dtype, device=x.device) if initial_state is None
               else initial_state)
        xw = x @ self.w_ih + self.b_ih  # (B, T, 3H): the time-parallel input projection
        return recurrent_ops.gru_recurrence(xw, self.w_hh, self.b_hh, mask, h_0)
