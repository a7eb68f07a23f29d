"""K5 and K7: the masked LSTM and GRU recurrences (port of the ``lax.scan`` steps of
``blvm_tpu/modules/recurrent.py`` ``LSTM.__call__``, ``:92-102``, and ``GRU.__call__``,
``:177-187``).

The input projection ``x @ W_ih + b_ih`` of every step is one time-parallel
product outside the recurrence, as in the JAX package; what remains is the
serial chain: ``gates = xw_t + h @ W_hh + b_hh`` in gate order i, f, g, o,
``c_new = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h_new = sigmoid(o) tanh(c_new)``,
the state frozen where the mask is 0 (``h = m h_new + (1 - m) h``) and the output
``h_new * m``. Tensors are batch-first: ``xw (B, T, 4H)``, ``out (B, T, H)``.

:func:`lstm_recurrence_plain` is the plain twin, one step at a time, op for op the
JAX step (in bf16 every op rounds, as XLA rounds it). :func:`lstm_recurrence` is
the entry point: for CPU tensors the twin (autograd gives its gradient); for CUDA
tensors one launch of ``csrc/lstm.cu``'s forward, under autograd
:class:`LSTMRecurrenceFunction` with the backward kernel, or it raises.
:func:`gru_update` is the GRU's gate math, shared by ``GRUCell``, K7's twin and K8's twin.

K7 is the GRU's chain: ``gh = h @ W_hh + b_hh``, ``h_new = gru_update(xw_t, gh, h)``
(gate order r, z, n), the state frozen where the mask is 0 and the output
``h_new * m``. :func:`gru_recurrence_plain` is its twin; :func:`gru_recurrence` the
entry point: for CPU tensors the twin, for CUDA tensors one launch of ``csrc/gru.cu``
(forward only: K7-bwd is not written yet, so a call that needs a gradient on the card
raises).
"""

from typing import Optional, Tuple

import torch

from blvm_tpu_torch.ops import cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/lstm.cu: a CTA of the 8-CTA cluster keeps its 2 H^2 bytes of W_hh (f32) in shared memory
K5_CLUSTER, K5_MAX_HIDDEN = 8, 256


def gru_update(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU's new state from ``gi = x W_ih + b_ih`` and ``gh = h W_hh + b_hh``
    (gate order r, z, n; torch's placement of the reset gate on ``h W_hn + b_hn``)."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def lstm_recurrence_plain(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, mask: Optional[torch.Tensor],
                          h0: torch.Tensor, c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX step in plain PyTorch, one step at a time: the twin of K5.

    ``xw (B, T, 4H)``, ``w_hh (H, 4H)``, ``b_hh (4H,)``, ``mask (B, T)`` of 0/1
    (None: all ones), ``h0, c0 (B, H)``; computes in ``xw``'s dtype (the mask and the
    state are cast to it, as JAX casts them). Returns ``(out (B, T, H), h_n, c_n)``.
    """
    dtype = xw.dtype
    B, T = xw.shape[:2]
    h, c = h0.to(dtype), c0.to(dtype)
    mask = torch.ones((B, T), dtype=dtype, device=xw.device) if mask is None else mask.to(dtype)
    outs = []
    for t in range(T):
        m = mask[:, t, None]
        gates = xw[:, t] + h @ w_hh + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        outs.append(h_new * m)
    out = torch.stack(outs, dim=1) if outs else xw.new_zeros((B, 0, h.shape[-1]))
    return out, h, c


def lstm_recurrence(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, mask: Optional[torch.Tensor],
                    h0: torch.Tensor, c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out (B, T, H), h_n (B, H), c_n (B, H))`` of the masked recurrence.

    CPU tensors: :func:`lstm_recurrence_plain`. CUDA tensors: one launch of K5 (one
    more of K5-bwd in the backward when a gradient is wanted); ``xw``, ``w_hh``,
    ``b_hh``, ``h0``, ``c0`` must share one dtype, float32 or bfloat16, and
    ``H`` must be a multiple of 8 up to 256, else it raises.
    """
    if not xw.is_cuda:
        return lstm_recurrence_plain(xw, w_hh, b_hh, mask, h0, c0)
    _check(xw, w_hh, b_hh, mask, h0, c0)
    if mask is not None:
        mask = mask.detach().to(torch.float32).contiguous()
    if xw.shape[1] == 0:
        return xw.new_zeros((xw.shape[0], 0, w_hh.shape[0])), h0, c0
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xw, w_hh, b_hh, h0, c0)):
        return LSTMRecurrenceFunction.apply(xw, w_hh, b_hh, mask, h0, c0)
    with torch.no_grad():
        return _forward(xw, w_hh, b_hh, mask, h0, c0, save=False)[:3]


def _check(xw, w_hh, b_hh, mask, h0, c0) -> None:
    if xw.ndim != 3 or xw.shape[-1] % 4:
        raise ValueError(f"lstm_recurrence takes xw of shape (B, T, 4H), got {tuple(xw.shape)}")
    B, T, G = xw.shape
    H = G // 4
    shapes = {"w_hh": (w_hh, (H, G)), "b_hh": (b_hh, (G,)), "h0": (h0, (B, H)), "c0": (c0, (B, H))}
    if mask is not None:
        shapes["mask"] = (mask, (B, T))
    wrong = {name: tuple(t.shape) for name, (t, shape) in shapes.items() if tuple(t.shape) != shape}
    if wrong:
        raise ValueError(f"lstm_recurrence: for xw {tuple(xw.shape)} expected w_hh ({H}, {G}), b_hh ({G},), "
                         f"mask ({B}, {T}), h0 and c0 ({B}, {H}); got {wrong}")
    tensors = [xw, w_hh, b_hh, h0, c0] + ([mask] if mask is not None else [])
    if any(t.device != xw.device for t in tensors):
        raise ValueError("lstm_recurrence: all inputs must lie on one CUDA device")
    if xw.dtype not in _DTYPE_CODES or any(t.dtype != xw.dtype for t in (w_hh, b_hh, h0, c0)):
        raise TypeError(f"the lstm_recurrence kernel takes xw, w_hh, b_hh, h0, c0 all float32 or all bfloat16, got "
                        f"{[t.dtype for t in (xw, w_hh, b_hh, h0, c0)]}")
    if H % K5_CLUSTER or not K5_CLUSTER <= H <= K5_MAX_HIDDEN or B < 1:
        raise ValueError(f"the lstm_recurrence kernel takes a hidden size H that is a multiple of {K5_CLUSTER} up to "
                         f"{K5_MAX_HIDDEN} (each of its {K5_CLUSTER} CTAs keeps H/{K5_CLUSTER} units' columns of W_hh, "
                         f"2 H^2 bytes, in shared memory) and B >= 1; got H={H}, B={B}")


def _forward(xw, w_hh, b_hh, mask, h0, c0, save: bool):
    """One launch of K5: ``(out, h_n, c_n, gates, h_prev, c_prev)``; with ``save`` the
    last three are what the backward reads (the activated gates ``(B, T, 4H)`` and the
    carried state before each step, ``(B, T, H)`` each), else None."""
    xw, w_hh, b_hh, h0, c0 = (t.contiguous() for t in (xw, w_hh, b_hh, h0, c0))
    B, T, G = xw.shape
    H = G // 4
    out = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    h_n, c_n = torch.empty_like(h0), torch.empty_like(c0)
    saved = [torch.empty((B, T, G), dtype=xw.dtype, device=xw.device)] if save else [None]
    saved += [torch.empty_like(out), torch.empty_like(out)] if save else [None, None]
    lib = cuda.library()
    cuda.count_launch("lstm_recurrence")
    err = lib.blvm_lstm_recurrence(
        *(_ptr(t) for t in (xw, w_hh, b_hh, mask, h0, c0, out, h_n, c_n, *saved)),
        B, T, H, _DTYPE_CODES[xw.dtype], cuda.stream_handle(xw),
    )
    cuda.check(err, "lstm_recurrence")
    return (out, h_n, c_n, *saved)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class LSTMRecurrenceFunction(torch.autograd.Function):
    """K5 under autograd. ``forward`` launches the forward kernel, which also writes
    the activated gates and the carried state before every step; ``backward``
    launches K5-bwd, which runs the chain in reverse and writes ``dgates`` (the
    gradient of ``xw``), ``dh0`` and ``dc0``. The weight gradients are sums over all
    ``B * T`` rows, left to cuBLAS as the JAX backward leaves them to XLA:
    ``dW_hh = h_prev^T dgates`` and ``db_hh`` a product of ``dgates`` with a row of
    ones. Arguments were checked by :func:`lstm_recurrence`."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh, mask, h0, c0):
        out, h_n, c_n, gates, h_prev, c_prev = _forward(xw, w_hh, b_hh, mask, h0, c0, save=True)
        ctx.save_for_backward(w_hh, mask, gates, h_prev, c_prev)
        return out, h_n, c_n

    @staticmethod
    def backward(ctx, d_out, d_h_n, d_c_n):
        w_hh, mask, gates, h_prev, c_prev = ctx.saved_tensors
        B, T, H = h_prev.shape
        dtype = gates.dtype
        w_hh, d_out, d_h_n, d_c_n = (t.to(dtype).contiguous() for t in (w_hh, d_out, d_h_n, d_c_n))
        d_gates = torch.empty_like(gates)
        d_h0 = torch.empty((B, H), dtype=dtype, device=gates.device)
        d_c0 = torch.empty_like(d_h0)
        lib = cuda.library()
        cuda.count_launch("lstm_recurrence_bwd")
        err = lib.blvm_lstm_recurrence_bwd(
            *(_ptr(t) for t in (w_hh, mask, gates, c_prev, d_out, d_h_n, d_c_n, d_gates, d_h0, d_c0)),
            B, T, H, _DTYPE_CODES[dtype], cuda.stream_handle(gates),
        )
        cuda.check(err, "lstm_recurrence_bwd")
        rows = d_gates.reshape(B * T, 4 * H)
        d_w_hh = h_prev.reshape(B * T, H).T @ rows
        d_b_hh = (torch.ones((1, B * T), dtype=dtype, device=rows.device) @ rows)[0]
        return d_gates, d_w_hh, d_b_hh, None, d_h0, d_c0


def gru_recurrence_plain(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, mask: Optional[torch.Tensor],
                         h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX GRU step in plain PyTorch, one step at a time: the twin of K7.

    ``xw (B, T, 3H)`` (``x W_ih + b_ih``), ``w_hh (H, 3H)``, ``b_hh (3H,)``, ``mask (B, T)``
    of 0/1 (None: all ones; any pattern, e.g. the flipped mask of a backward GRU, whose
    zeros lead), ``h0 (B, H)``. Returns ``(out (B, T, H), h_n (B, H))``: ``out`` is
    ``h_new * m``, ``h_n`` the state after the last step, frozen wherever ``m`` is 0.
    """
    dtype = xw.dtype
    B, T = xw.shape[:2]
    h = h0.to(dtype)
    mask = torch.ones((B, T), dtype=dtype, device=xw.device) if mask is None else mask.to(dtype)
    outs = []
    for t in range(T):
        m = mask[:, t, None]
        h_new = gru_update(xw[:, t], h @ w_hh + b_hh, h)
        h = m * h_new + (1 - m) * h
        outs.append(h_new * m)
    out = torch.stack(outs, dim=1) if outs else xw.new_zeros((B, 0, h.shape[-1]))
    return out, h


def gru_recurrence(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, mask: Optional[torch.Tensor],
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, T, H), h_n (B, H))`` of the masked GRU recurrence.

    CPU tensors: :func:`gru_recurrence_plain` (autograd gives its gradient). CUDA tensors:
    one launch of K7, all float32 and on one device, on a grid of one CTA an SM; a call
    that needs a gradient raises ``NotImplementedError`` (K7-bwd, the backward through
    time, is the next slice's kernel), as does nothing else: no fallback to the twin.
    """
    if not xw.is_cuda:
        return gru_recurrence_plain(xw, w_hh, b_hh, mask, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xw, w_hh, b_hh, h0)):
        raise NotImplementedError("gru_recurrence (K7) has no backward on the card yet (K7-bwd is still to be "
                                  "written); run it under torch.no_grad() or on CPU tensors")
    _check_gru(xw, w_hh, b_hh, mask, h0)
    if xw.shape[1] == 0:
        return xw.new_zeros((xw.shape[0], 0, w_hh.shape[0])), h0
    xw, w_hh, b_hh, h0 = (t.contiguous() for t in (xw, w_hh, b_hh, h0))
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    B, T, G = xw.shape
    H = G // 3
    out = torch.empty((B, T, H), dtype=torch.float32, device=xw.device)
    h_n = torch.empty_like(h0)
    state = torch.empty((2, B, H), dtype=torch.float32, device=xw.device)
    barrier = torch.empty(1, dtype=torch.int32, device=xw.device)
    lib = cuda.library()
    cuda.count_launch("gru_recurrence")
    err = lib.blvm_gru_recurrence(*(_ptr(t) for t in (xw, w_hh, b_hh, mask, h0, out, h_n, state, barrier)), B, T, H,
                                  cuda.stream_handle(xw))
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K7 (gru_recurrence): W_hh of H={H} at B={B} does not fit the shared memory of a grid of "
                           "one CTA an SM that is all resident")
    cuda.check(err, "gru_recurrence")
    return out, h_n


def _check_gru(xw, w_hh, b_hh, mask, h0) -> None:
    if xw.ndim != 3 or xw.shape[-1] % 3:
        raise ValueError(f"gru_recurrence takes xw of shape (B, T, 3H), got {tuple(xw.shape)}")
    B, T, G = xw.shape
    H = G // 3
    shapes = {"w_hh": (w_hh, (H, G)), "b_hh": (b_hh, (G,)), "h0": (h0, (B, H))}
    if mask is not None:
        shapes["mask"] = (mask, (B, T))
    wrong = {name: tuple(t.shape) for name, (t, shape) in shapes.items() if tuple(t.shape) != shape}
    if wrong:
        raise ValueError(f"gru_recurrence: for xw {tuple(xw.shape)} expected w_hh ({H}, {G}), b_hh ({G},), "
                         f"mask ({B}, {T}) and h0 ({B}, {H}); got {wrong}")
    tensors = [xw, w_hh, b_hh, h0] + ([mask] if mask is not None else [])
    if any(t.device != xw.device for t in tensors):
        raise ValueError("gru_recurrence: all inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in (xw, w_hh, b_hh, h0)):
        raise TypeError(f"the gru_recurrence kernel takes float32 xw, w_hh, b_hh and h0 (the JAX GRU is f32), got "
                        f"{[t.dtype for t in (xw, w_hh, b_hh, h0)]}")
    if B < 1 or H < 1:
        raise ValueError(f"gru_recurrence takes B >= 1 and H >= 1, got B={B}, H={H}")
