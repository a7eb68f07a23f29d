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
entry point: for CPU tensors the twin, for CUDA tensors one launch of ``csrc/gru.cu``.
Where a gradient is needed it runs :class:`GRURecurrenceFunction`: the forward saves what
the backward reads (:func:`gru_recurrence_save`; K7's save mode on the card), the backward
is :func:`gru_recurrence_backward` (K7-bwd, ``csrc/gru_bwd.cu``, on the card;
:func:`gru_recurrence_backward_plain` on the CPU) and the weight gradients as sums over the
``B T`` rows (:func:`gru_weight_grads`).

K6 is one layer of the bidirectional LSTM (port of the scan of
``blvm_tpu/modules/lstm_block.py`` ``LSTMBlock._fused_bidirectional``, ``:82-130``): K5's
step for both directions at once, direction 1 over the whole padded sequence reversed (its
step ``s`` reads and writes time ``T - 1 - s``), from a zero state. ``xw (B, T, 8H)`` holds
direction ``d``'s gate columns at ``4 d H`` and ``out (B, T, 2H)`` direction ``d`` at ``d H``.
:func:`bilstm_recurrence_plain` is its twin; :func:`bilstm_recurrence` the entry point: for
CPU tensors the twin, for CUDA tensors one launch of ``csrc/bilstm.cu``; with a gradient
:class:`BiLSTMRecurrenceFunction` (K6 in save mode and K6-bwd on the card, the save twin and
:func:`bilstm_recurrence_backward_plain` on the CPU).
"""

from typing import Optional, Tuple

import torch

from blvm_tpu_torch.ops import cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/lstm_common.cuh (K5 and K6): a CTA of the 8-CTA cluster keeps its 2 H^2 bytes of W_hh (f32) in shared memory
K5_CLUSTER, K5_MAX_HIDDEN = 8, 256


def gru_gates(gi: torch.Tensor, gh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(r, z, n, hn)`` of a GRU step from ``gi = x W_ih + b_ih`` and ``gh = h W_hh + b_hh``
    (gate order r, z, n; torch's placement of the reset gate on ``hn = h W_hn + b_hn``)."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return r, z, n, h_n


def gru_update(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU's new state from ``gi`` and ``gh`` (:func:`gru_gates`)."""
    _, z, n, _ = gru_gates(gi, gh)
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
    return _gru_chain_plain(xw, w_hh, b_hh, mask, h0, save=False)[:2]


def _gru_chain_plain(xw, w_hh, b_hh, mask, h0, save: bool):
    """:func:`gru_recurrence_plain` and, with ``save``, K7's save buffer ``(B, T, 5H)`` (the
    state entering each step, r, z, n, hn), else None."""
    dtype = xw.dtype
    B, T = xw.shape[:2]
    h = h0.to(dtype)
    mask = torch.ones((B, T), dtype=dtype, device=xw.device) if mask is None else mask.to(dtype)
    outs, saved = [], []
    for t in range(T):
        m = mask[:, t, None]
        r, z, n, hn = gru_gates(xw[:, t], h @ w_hh + b_hh)
        h_new = (1.0 - z) * n + z * h
        if save:
            saved.append(torch.cat([h, r, z, n, hn], dim=-1))
        h = m * h_new + (1 - m) * h
        outs.append(h_new * m)
    out = torch.stack(outs, dim=1) if outs else xw.new_zeros((B, 0, h.shape[-1]))
    return out, h, torch.stack(saved, dim=1) if save else None


def gru_recurrence(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, mask: Optional[torch.Tensor],
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, T, H), h_n (B, H))`` of the masked GRU recurrence.

    Without a gradient: CPU tensors, :func:`gru_recurrence_plain`; CUDA tensors, one launch of
    K7, all float32 and on one device, on a grid of one CTA an SM. With gradients enabled and
    an input or weight that requires one: :class:`GRURecurrenceFunction` (on the card K7 in
    save mode forward, K7-bwd backward; on the CPU their twins). No fallback to the twin on
    the card: what the kernels do not take raises.
    """
    if xw.is_cuda:
        _check_gru(xw, w_hh, b_hh, mask, h0)
        if mask is not None:
            mask = mask.detach().to(torch.float32).contiguous()
    if xw.shape[1] == 0:
        return xw.new_zeros((xw.shape[0], 0, w_hh.shape[0])), h0
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xw, w_hh, b_hh, h0)):
        return GRURecurrenceFunction.apply(xw, w_hh, b_hh, mask, h0)
    if not xw.is_cuda:
        return gru_recurrence_plain(xw, w_hh, b_hh, mask, h0)
    with torch.no_grad():
        return _gru_launch(xw, w_hh, b_hh, mask, h0, save=False)[:2]


def gru_recurrence_save(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, mask: Optional[torch.Tensor],
                        h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward of :class:`GRURecurrenceFunction`: ``(out, h_n, saved)``, ``saved (B, T, 5H)``
    the state entering each step and its r, z, n and ``hn = h W_hn + b_hn``. CPU tensors: the
    twin; CUDA tensors: one launch of K7 in save mode (its outputs the same bits as without)."""
    if not xw.is_cuda:
        return _gru_chain_plain(xw, w_hh, b_hh, mask, h0, save=True)
    return _gru_launch(xw, w_hh, b_hh, mask, h0, save=True)


def _gru_launch(xw, w_hh, b_hh, mask, h0, save: bool):
    """One launch of K7: ``(out, h_n, saved)``, ``saved`` None without ``save``."""
    xw, w_hh, b_hh, h0 = (t.contiguous() for t in (xw, w_hh, b_hh, h0))
    B, T, G = xw.shape
    H = G // 3
    out = torch.empty((B, T, H), dtype=torch.float32, device=xw.device)
    h_n = torch.empty_like(h0)
    saved = torch.empty((B, T, 5 * H), dtype=torch.float32, device=xw.device) if save else None
    state = torch.empty((2, B, H), dtype=torch.float32, device=xw.device)
    barrier = torch.empty(1, dtype=torch.int32, device=xw.device)
    lib = cuda.library()
    cuda.count_launch("gru_recurrence")
    err = lib.blvm_gru_recurrence(*(_ptr(t) for t in (xw, w_hh, b_hh, mask, h0, out, h_n, saved, state, barrier)),
                                  B, T, H, cuda.stream_handle(xw))
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K7 (gru_recurrence): W_hh of H={H} at B={B} does not fit the shared memory of a grid of "
                           "one CTA an SM that is all resident")
    cuda.check(err, "gru_recurrence")
    return out, h_n, saved


def gru_recurrence_backward_plain(w_hh: torch.Tensor, mask: Optional[torch.Tensor], saved: torch.Tensor,
                                  d_out: Optional[torch.Tensor],
                                  d_h_n: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The twin of K7-bwd: the reverse chain in plain PyTorch, one step at a time. From ``w_hh``,
    the mask, K7's save buffer and the gradients of ``out`` and ``h_n`` (None for zero):
    ``(d_gi, d_gh, d_h0)``, ``d_gi (B, T, 3H)`` the gradient of ``xw`` and ``d_gh`` that of
    ``h W_hh + b_hh`` at every step (its n part ``d pre_n r``, where ``d_gi``'s is ``d pre_n``)."""
    B, T, H = saved.shape[0], saved.shape[1], saved.shape[2] // 5
    dh = torch.zeros((B, H), dtype=saved.dtype, device=saved.device) if d_h_n is None else d_h_n
    d_gi, d_gh = [], []
    for t in range(T - 1, -1, -1):
        h_prev, r, z, n, hn = saved[:, t].split(H, dim=-1)
        m = 1.0 if mask is None else mask[:, t, None].to(saved.dtype)
        dh_new = m * (dh if d_out is None else dh + d_out[:, t])
        dn = dh_new * (1.0 - z)
        dz = dh_new * (h_prev - n)
        d_pre_n = dn * (1.0 - n * n)
        d_pre_z = dz * z * (1.0 - z)
        d_pre_r = d_pre_n * hn * r * (1.0 - r)
        d_gi.append(torch.cat([d_pre_r, d_pre_z, d_pre_n], dim=-1))
        d_gh.append(torch.cat([d_pre_r, d_pre_z, d_pre_n * r], dim=-1))
        dh = ((1.0 - m) * dh + dh_new * z) + d_gh[-1] @ w_hh.T
    return torch.stack(d_gi[::-1], dim=1), torch.stack(d_gh[::-1], dim=1), dh


def gru_recurrence_backward(w_hh: torch.Tensor, mask: Optional[torch.Tensor], saved: torch.Tensor,
                            d_out: Optional[torch.Tensor], d_h_n: Optional[torch.Tensor],
                            trace: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(d_gi, d_gh, d_h0)`` as :func:`gru_recurrence_backward_plain` gives them. CPU tensors:
    that twin; CUDA tensors: one launch of K7-bwd (float32; ``trace``, an int64 tensor of
    :func:`gru_bwd_trace_size` zeros on the card, receives its time by stage and phase)."""
    if not saved.is_cuda:
        return gru_recurrence_backward_plain(w_hh, mask, saved, d_out, d_h_n)
    B, T, W = saved.shape
    H = W // 5
    w_hh, saved = w_hh.contiguous(), saved.contiguous()
    d_out, d_h_n = (None if g is None else g.contiguous() for g in (d_out, d_h_n))
    tensors = [w_hh, saved] + [t for t in (mask, d_out, d_h_n) if t is not None]
    if any(t.device != saved.device or t.dtype != torch.float32 for t in tensors):
        raise ValueError("gru_recurrence_backward takes float32 tensors on one CUDA device")
    if (tuple(w_hh.shape) != (H, 3 * H) or W != 5 * H or (mask is not None and tuple(mask.shape) != (B, T))
            or (d_out is not None and tuple(d_out.shape) != (B, T, H))
            or (d_h_n is not None and tuple(d_h_n.shape) != (B, H))):
        raise ValueError(f"gru_recurrence_backward: saved {tuple(saved.shape)} is not K7's save buffer for w_hh "
                         f"{tuple(w_hh.shape)}, or the mask or the output gradients do not match it")
    if trace is not None and (trace.dtype != torch.int64 or trace.numel() != gru_bwd_trace_size()
                              or trace.device != saved.device):
        raise ValueError(f"the trace must be an int64 tensor of {gru_bwd_trace_size()} elements on {saved.device}")
    d_gi = torch.empty((B, T, 3 * H), dtype=torch.float32, device=saved.device)
    d_gh = torch.empty_like(d_gi)
    d_h0 = torch.empty((B, H), dtype=torch.float32, device=saved.device)
    barrier = torch.empty(1, dtype=torch.int32, device=saved.device)
    lib = cuda.library()
    cuda.count_launch("gru_recurrence_bwd")
    err = lib.blvm_gru_recurrence_bwd(*(_ptr(t) for t in (w_hh, mask, saved, d_out, d_h_n, d_gi, d_gh, d_h0, barrier,
                                                          trace)), B, T, H, cuda.stream_handle(saved))
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K7-bwd (gru_recurrence_bwd): W_hh of H={H} at B={B} does not fit the shared memory of "
                           "a grid of one CTA an SM that is all resident")
    cuda.check(err, "gru_recurrence_bwd")
    return d_gi, d_gh, d_h0


def gru_weight_grads(saved: torch.Tensor, d_gh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW_hh, db_hh)``: ``dW_hh = sum_t h_{t-1}^T d gh_t`` over the ``B T`` rows as one GEMM
    (cuBLAS on the card), ``db_hh`` the column sums of ``d gh`` as a product with a row of ones
    (a column ``sum`` is ~10x slower on the card)."""
    B, T, G = d_gh.shape
    rows = d_gh.reshape(B * T, G)
    h_prev = saved[..., :G // 3].reshape(B * T, G // 3)
    return h_prev.T @ rows, (torch.ones((1, B * T), dtype=rows.dtype, device=rows.device) @ rows)[0]


def gru_bwd_trace_size() -> int:
    """K7-bwd's trace: its 2 stages (the elementwise backward, the product) x 4 phases, then the
    loop's cycles and nanoseconds; read it as ``ops/srnn.py:read_trace`` reads K9's."""
    return 2 * 4 + 2


class GRURecurrenceFunction(torch.autograd.Function):
    """K7 under autograd: ``apply(xw, w_hh, b_hh, mask, h0) -> (out, h_n)``. ``forward`` runs
    :func:`gru_recurrence_save`; ``backward`` runs :func:`gru_recurrence_backward` once and
    :func:`gru_weight_grads`, and returns the gradients of ``xw`` (``d_gi``), ``w_hh``,
    ``b_hh`` and ``h0`` (none for the mask). An output gradient autograd has none for arrives
    as None and is read as zero."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh, mask, h0):
        out, h_n, saved = gru_recurrence_save(xw, w_hh, b_hh, mask, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w_hh, mask, saved)
        return out, h_n

    @staticmethod
    def backward(ctx, d_out, d_h_n):
        w_hh, mask, saved = ctx.saved_tensors
        d_gi, d_gh, d_h0 = gru_recurrence_backward(w_hh, mask, saved, d_out, d_h_n)
        d_w_hh, d_b_hh = gru_weight_grads(saved, d_gh)
        return d_gi, d_w_hh, d_b_hh, None, d_h0


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


def bilstm_recurrence_plain(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX block's fused scan in plain PyTorch, one step at a time: the twin of K6.

    ``xw (B, T, 8H)`` (``x [W_ih[0] | W_ih[1]] + [b_ih[0] | b_ih[1]]``), ``w_hh (2, H, 4H)``,
    ``b_hh (2, 4H)``, ``mask (B, T)`` of 0/1 (None: all ones). Both directions from a zero
    state, direction 1 over the reversed sequence and mask. Returns ``out (B, T, 2H)``, the
    directions concatenated (direction 1 back in forward time order)."""
    return _bilstm_plain(xw, w_hh, b_hh, mask, save=False)[0]


def _bilstm_plain(xw, w_hh, b_hh, mask, save: bool):
    """:func:`bilstm_recurrence_plain` and, with ``save``, what the backward reads, as K6's save
    mode writes it: the activated gates ``(B, T, 8H)`` and the carried ``h`` and ``c`` before each
    step ``(B, T, 2H)``, at each step's own time index; else None."""
    dtype = xw.dtype
    B, T = xw.shape[:2]
    H = w_hh.shape[1]
    G = 4 * H
    mask = torch.ones((B, T), dtype=dtype, device=xw.device) if mask is None else mask.to(dtype)
    h = c = xw.new_zeros((2, B, H))
    outs, saved = [[None] * T, [None] * T], [[None] * T, [None] * T]
    for s in range(T):
        times = (s, T - 1 - s)
        x_t = torch.stack([xw[:, times[0], :G], xw[:, times[1], G:]])  # (2, B, 4H)
        m = torch.stack([mask[:, times[0]], mask[:, times[1]]])[..., None]  # (2, B, 1)
        gates = x_t + torch.bmm(h, w_hh) + b_hh[:, None]
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        for d in range(2):
            outs[d][times[d]] = h_new[d] * m[d]
            if save:
                saved[d][times[d]] = torch.cat([i[d], f[d], g[d], o[d], h[d], c[d]], dim=-1)
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
    if T == 0:
        return xw.new_zeros((B, 0, 2 * H)), None, None, None
    out = torch.cat([torch.stack(outs[0], dim=1), torch.stack(outs[1], dim=1)], dim=-1)
    if not save:
        return out, None, None, None
    per_dir = [torch.stack(saved[d], dim=1) for d in range(2)]  # (B, T, 6H): the gates, h, c
    gates_ = torch.cat([per_dir[0][..., :G], per_dir[1][..., :G]], dim=-1)
    h_prev = torch.cat([per_dir[0][..., G:G + H], per_dir[1][..., G:G + H]], dim=-1)
    c_prev = torch.cat([per_dir[0][..., G + H:], per_dir[1][..., G + H:]], dim=-1)
    return out, gates_, h_prev, c_prev


def bilstm_recurrence(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``out (B, T, 2H)`` of one bidirectional LSTM layer (:func:`bilstm_recurrence_plain`).

    Without a gradient: CPU tensors, the twin; CUDA tensors, one launch of K6. With gradients
    enabled and an input or weight that requires one: :class:`BiLSTMRecurrenceFunction`. On the
    card ``xw``, ``w_hh`` and ``b_hh`` must be float32 on one device and ``H`` a multiple of 8 up
    to 256, else it raises: no fallback to the twin."""
    if xw.is_cuda:
        _check_bilstm(xw, w_hh, b_hh, mask)
        if mask is not None:
            mask = mask.detach().to(torch.float32).contiguous()
    if xw.shape[1] == 0:
        return xw.new_zeros((xw.shape[0], 0, 2 * w_hh.shape[1]))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xw, w_hh, b_hh)):
        return BiLSTMRecurrenceFunction.apply(xw, w_hh, b_hh, mask)
    if not xw.is_cuda:
        return bilstm_recurrence_plain(xw, w_hh, b_hh, mask)
    with torch.no_grad():
        return _bilstm_launch(xw, w_hh, b_hh, mask, save=False)[0]


def bilstm_recurrence_save(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, mask: Optional[torch.Tensor]):
    """The forward of :class:`BiLSTMRecurrenceFunction`: ``(out, gates, h_prev, c_prev)``. CPU
    tensors: the twin; CUDA tensors: one launch of K6 in save mode (its ``out`` the same bits as
    without)."""
    if not xw.is_cuda:
        return _bilstm_plain(xw, w_hh, b_hh, mask, save=True)
    return _bilstm_launch(xw, w_hh, b_hh, mask, save=True)


def _bilstm_launch(xw, w_hh, b_hh, mask, save: bool):
    """One launch of K6: ``(out, gates, h_prev, c_prev)``, the last three None without ``save``."""
    xw, w_hh, b_hh = (t.contiguous() for t in (xw, w_hh, b_hh))
    B, T, G2 = xw.shape
    H = G2 // 8
    out = torch.empty((B, T, 2 * H), dtype=torch.float32, device=xw.device)
    saved = [torch.empty_like(xw), torch.empty_like(out), torch.empty_like(out)] if save else [None] * 3
    lib = cuda.library()
    cuda.count_launch("bilstm_recurrence")
    err = lib.blvm_bilstm_recurrence(*(_ptr(t) for t in (xw, w_hh, b_hh, mask, out, *saved)), B, T, H,
                                     cuda.stream_handle(xw))
    cuda.check(err, "bilstm_recurrence")
    return (out, *saved)


def bilstm_recurrence_backward_plain(w_hh: torch.Tensor, mask: Optional[torch.Tensor], gates: torch.Tensor,
                                     c_prev: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """The twin of K6-bwd: each direction's chain in reverse, in plain PyTorch, one step at a time
    (direction 0 from ``t = T - 1`` down, direction 1 from ``t = 0`` up). From ``w_hh (2, H, 4H)``,
    the mask, the save mode's gates ``(B, T, 8H)`` and ``c_prev (B, T, 2H)`` and ``d_out (B, T, 2H)``:
    ``d_gates (B, T, 8H)``, the gradient of ``xw``. A masked step passes dh and dc through."""
    B, T, G2 = gates.shape
    H, G = G2 // 8, G2 // 2
    dtype = gates.dtype
    mask = torch.ones((B, T), dtype=dtype, device=gates.device) if mask is None else mask.to(dtype)
    dh = dc = gates.new_zeros((2, B, H))
    d_gates = [[None] * T, [None] * T]
    for s in range(T - 1, -1, -1):
        times = (s, T - 1 - s)
        g_t = torch.stack([gates[:, times[0], :G], gates[:, times[1], G:]])  # (2, B, 4H)
        cp = torch.stack([c_prev[:, times[0], :H], c_prev[:, times[1], H:]])
        do = torch.stack([d_out[:, times[0], :H], d_out[:, times[1], H:]])
        m = torch.stack([mask[:, times[0]], mask[:, times[1]]])[..., None]
        i, f, g, o = g_t.chunk(4, dim=-1)
        tc = torch.tanh(f * cp + i * g)
        dh_new = m * (dh + do)
        dc_new = m * dc + dh_new * o * (1 - tc * tc)
        dg = torch.cat([dc_new * g * i * (1 - i), dc_new * cp * f * (1 - f), dc_new * i * (1 - g * g),
                        dh_new * tc * o * (1 - o)], dim=-1)
        for d in range(2):
            d_gates[d][times[d]] = dg[d]
        dc = (1 - m) * dc + dc_new * f
        dh = (1 - m) * dh + torch.bmm(dg, w_hh.transpose(1, 2))
    if T == 0:
        return gates.new_zeros((B, 0, G2))
    return torch.cat([torch.stack(d_gates[0], dim=1), torch.stack(d_gates[1], dim=1)], dim=-1)


def bilstm_recurrence_backward(w_hh: torch.Tensor, mask: Optional[torch.Tensor], gates: torch.Tensor,
                               c_prev: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """``d_gates`` as :func:`bilstm_recurrence_backward_plain` gives it. CPU tensors: that twin;
    CUDA tensors: one launch of K6-bwd (float32, on one device, the save mode's layouts)."""
    if not gates.is_cuda:
        return bilstm_recurrence_backward_plain(w_hh, mask, gates, c_prev, d_out)
    B, T, G2 = gates.shape
    H = G2 // 8
    w_hh, gates, c_prev, d_out = (t.contiguous() for t in (w_hh, gates, c_prev, d_out))
    tensors = [w_hh, gates, c_prev, d_out] + ([mask] if mask is not None else [])
    if any(t.device != gates.device or t.dtype != torch.float32 for t in tensors):
        raise ValueError("bilstm_recurrence_backward takes float32 tensors on one CUDA device")
    if (tuple(w_hh.shape) != (2, H, 4 * H) or tuple(c_prev.shape) != (B, T, 2 * H) or tuple(d_out.shape) != (B, T, 2 * H)
            or (mask is not None and tuple(mask.shape) != (B, T))):
        raise ValueError(f"bilstm_recurrence_backward: gates {tuple(gates.shape)} are not K6's save buffer for w_hh "
                         f"{tuple(w_hh.shape)}, or c_prev, d_out or the mask do not match them")
    d_gates = torch.empty_like(gates)
    lib = cuda.library()
    cuda.count_launch("bilstm_recurrence_bwd")
    err = lib.blvm_bilstm_recurrence_bwd(*(_ptr(t) for t in (w_hh, mask, gates, c_prev, d_out, d_gates)), B, T, H,
                                         cuda.stream_handle(gates))
    cuda.check(err, "bilstm_recurrence_bwd")
    return d_gates


def bilstm_weight_grads(h_prev: torch.Tensor, d_gates: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW_hh (2, H, 4H), db_hh (2, 4H))``: per direction ``h_prev[d]^T d_gates[d]`` over the ``B T``
    rows, one GEMM each (cuBLAS on the card), and the column sums of ``d_gates`` as one product with a
    row of ones."""
    B, T, G2 = d_gates.shape
    H = G2 // 8
    rows, h_rows = d_gates.reshape(B * T, G2), h_prev.reshape(B * T, 2 * H)
    d_w_hh = torch.stack([h_rows[:, d * H:(d + 1) * H].T @ rows[:, d * 4 * H:(d + 1) * 4 * H] for d in range(2)])
    d_b_hh = (torch.ones((1, B * T), dtype=rows.dtype, device=rows.device) @ rows).reshape(2, 4 * H)
    return d_w_hh, d_b_hh


class BiLSTMRecurrenceFunction(torch.autograd.Function):
    """K6 under autograd: ``apply(xw, w_hh, b_hh, mask) -> out``. ``forward`` runs
    :func:`bilstm_recurrence_save`; ``backward`` runs :func:`bilstm_recurrence_backward` once and
    :func:`bilstm_weight_grads`, and returns the gradients of ``xw`` (``d_gates``; the layer's one
    input product takes it on to ``x``, ``W_ih`` and ``b_ih``), ``w_hh`` and ``b_hh``."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh, mask):
        out, gates, h_prev, c_prev = bilstm_recurrence_save(xw, w_hh, b_hh, mask)
        ctx.save_for_backward(w_hh, mask, gates, h_prev, c_prev)
        return out

    @staticmethod
    def backward(ctx, d_out):
        w_hh, mask, gates, h_prev, c_prev = ctx.saved_tensors
        d_gates = bilstm_recurrence_backward(w_hh, mask, gates, c_prev, d_out)
        d_w_hh, d_b_hh = bilstm_weight_grads(h_prev, d_gates)
        return d_gates, d_w_hh, d_b_hh, None


def _check_bilstm(xw, w_hh, b_hh, mask) -> None:
    if xw.ndim != 3 or xw.shape[-1] % 8:
        raise ValueError(f"bilstm_recurrence takes xw of shape (B, T, 8H), got {tuple(xw.shape)}")
    B, T, G2 = xw.shape
    H = G2 // 8
    shapes = {"w_hh": (w_hh, (2, H, 4 * H)), "b_hh": (b_hh, (2, 4 * H))}
    if mask is not None:
        shapes["mask"] = (mask, (B, T))
    wrong = {name: tuple(t.shape) for name, (t, shape) in shapes.items() if tuple(t.shape) != shape}
    if wrong:
        raise ValueError(f"bilstm_recurrence: for xw {tuple(xw.shape)} expected w_hh (2, {H}, {4 * H}), b_hh (2, {4 * H}) "
                         f"and mask ({B}, {T}); got {wrong}")
    if any(t.device != xw.device for t in [w_hh, b_hh] + ([mask] if mask is not None else [])):
        raise ValueError("bilstm_recurrence: all inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in (xw, w_hh, b_hh)):
        raise TypeError(f"the bilstm_recurrence kernel takes float32 xw, w_hh and b_hh (the probe is f32), got "
                        f"{[t.dtype for t in (xw, w_hh, b_hh)]}")
    if H % K5_CLUSTER or not K5_CLUSTER <= H <= K5_MAX_HIDDEN or B < 1:
        raise ValueError(f"the bilstm_recurrence kernel takes a hidden size H that is a multiple of {K5_CLUSTER} up to "
                         f"{K5_MAX_HIDDEN} (each of its {K5_CLUSTER} CTAs keeps H/{K5_CLUSTER} units' columns of one "
                         f"direction's W_hh, 2 H^2 bytes, in shared memory) and B >= 1; got H={H}, B={B}")
