"""K13: the CTC loss of the ASR probe, optax's ``ctc_loss`` (``blvm_tpu/models/lstm_asr.py:80``).

optax runs a ``lax.scan`` over the frames with two sets of log-space states (the blank after ``n``
labels, and label ``n`` being emitted) and ``log_epsilon = -1e5`` standing in for ``log 0``, so a row
whose labels cannot fit its frames scores a large finite number (PyTorch's ``F.ctc_loss`` gives
``inf`` there) and a row with no frames and no labels ``-0.0``. :func:`ctc_loss_plain` is that
recursion in plain PyTorch, step for step: the twin, and the CPU path (autograd gives its gradient).
:func:`ctc_loss` is the entry point: CPU tensors, the twin; CUDA tensors, one launch of
``csrc/ctc.cu`` over ``log_softmax(logits)`` (K13), under autograd :class:`CTCLossFunction` with
K13-bwd, the gradient of the log-probabilities that ``log_softmax``'s backward takes on to the logits.
PyTorch's CUDA ``F.ctc_loss`` is not used: it synchronizes the stream several times a call (it copies
host-made offsets and lengths to the card from pageable memory), and the kernel reads its lengths from
the card.
"""

import torch
import torch.nn.functional as F

from blvm_tpu_torch.ops import cuda

LOG_EPSILON = -1e5  # optax.ctc_loss's default: its stand-in for log(0)
K13_MAX_LABELS = 1023  # csrc/ctc.cu: a CTA a row, a thread a state (N + 1 <= 1024)


def ctc_loss_plain(logits: torch.Tensor, z_sl: torch.Tensor, y: torch.Tensor, y_sl: torch.Tensor, blank: int = 0,
                   log_epsilon: float = LOG_EPSILON) -> torch.Tensor:
    """optax's ``ctc_loss_with_forward_probs`` in plain PyTorch, step for step: ``logits (B, T, K)``,
    ``z_sl (B,)`` frames, ``y (B, N)`` right-padded labels, ``y_sl (B,)``, all on one device: the
    per-example loss ``(B,)``. The twin of K13."""
    logprobs = torch.log_softmax(logits, dim=-1)
    B, T, _ = logprobs.shape
    N = y.shape[1]
    dtype, device = logprobs.dtype, logprobs.device
    y = y.long()
    repeat = F.pad((y[:, :-1] == y[:, 1:]).to(dtype), (0, 1))  # (B, N): label n equals label n + 1
    logprob_phi = logprobs[:, :, blank]  # (B, T)
    logprob_emit = torch.gather(logprobs, 2, y[:, None, :].expand(B, T, N))  # (B, T, N)
    pad = (torch.arange(T, device=device)[None] >= z_sl[:, None]).to(dtype)  # (B, T)
    phi = torch.full((B, N + 1), log_epsilon, dtype=dtype, device=device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, dtype=dtype, device=device)

    def update_phi(phi_, added):
        return torch.cat([phi_[:, :1], torch.logaddexp(phi_[:, 1:], added)], dim=-1)

    for t in range(T):
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)  # emit-to-phi, except before a repeat
        lp_emit, lp_phi = logprob_emit[:, t], logprob_phi[:, t, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        p = pad[:, t, None]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * phi + (1.0 - p) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, y_sl.long()[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, z_sl: torch.Tensor, y: torch.Tensor, y_sl: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """The per-example CTC loss ``(B,)`` of ``logits (B, T, K)`` against ``y (B, N)``, optax's values on
    every row. CPU tensors: :func:`ctc_loss_plain`. CUDA tensors: ``log_softmax`` and one launch of K13
    (one more of K13-bwd in the backward when a gradient is wanted), float32 logits and every input on one
    device, ``N`` up to 1023 labels; else it raises. The lengths are read on the card: no wait."""
    if not logits.is_cuda:
        return ctc_loss_plain(logits, z_sl, y, y_sl, blank)
    _check(logits, z_sl, y, y_sl, blank)
    logprobs = torch.log_softmax(logits, dim=-1)
    y, z_sl, y_sl = (t.detach().to(torch.int64).contiguous() for t in (y, z_sl, y_sl))
    if torch.is_grad_enabled() and logprobs.requires_grad:
        return CTCLossFunction.apply(logprobs, y, z_sl, y_sl, blank)
    with torch.no_grad():
        return _forward(logprobs, y, z_sl, y_sl, blank, save=False)[0]


def _check(logits, z_sl, y, y_sl, blank) -> None:
    if logits.ndim != 3 or y.ndim != 2 or y.shape[0] != logits.shape[0] or tuple(z_sl.shape) != (logits.shape[0],) \
            or tuple(y_sl.shape) != (logits.shape[0],):
        raise ValueError(f"ctc_loss takes logits (B, T, K), z_sl (B,), y (B, N), y_sl (B,); got {tuple(logits.shape)}, "
                         f"{tuple(z_sl.shape)}, {tuple(y.shape)}, {tuple(y_sl.shape)}")
    if any(t.device != logits.device for t in (z_sl, y, y_sl)):
        raise ValueError("ctc_loss: all inputs must lie on one CUDA device")
    if logits.dtype != torch.float32:
        raise TypeError(f"the ctc_loss kernel takes float32 logits (the probe is f32), got {logits.dtype}")
    B, T, K = logits.shape
    if not (B >= 1 and T >= 1 and 1 <= y.shape[1] <= K13_MAX_LABELS and 0 <= blank < K):
        raise ValueError(f"the ctc_loss kernel takes B, T >= 1, 1 to {K13_MAX_LABELS} label columns (a thread a state "
                         f"of a CTA a row) and a blank among the K classes; got B={B}, T={T}, N={y.shape[1]}, K={K}, "
                         f"blank={blank}")


def _forward(logprobs, y, z_sl, y_sl, blank, save: bool):
    """One launch of K13: ``(nll (B,), phi, emit)``, the last two the states before every frame and the final
    one, ``(B, T + 1, N + 1)`` and ``(B, T + 1, N)`` in float64 (the kernel's recursion runs in double), with
    ``save``, else None."""
    logprobs = logprobs.contiguous()
    B, T, K = logprobs.shape
    N = y.shape[1]
    nll = torch.empty(B, dtype=torch.float32, device=logprobs.device)
    phi = torch.empty((B, T + 1, N + 1), dtype=torch.float64, device=logprobs.device) if save else None
    emit = torch.empty((B, T + 1, N), dtype=torch.float64, device=logprobs.device) if save else None
    lib = cuda.library()
    cuda.count_launch("ctc_loss")
    err = lib.blvm_ctc_loss(*(_ptr(t) for t in (logprobs, y, z_sl, y_sl, nll, phi, emit)), B, T, N, K, blank,
                            LOG_EPSILON, cuda.stream_handle(logprobs))
    cuda.check(err, "ctc_loss")
    return nll, phi, emit


def _ptr(t):
    return None if t is None else t.data_ptr()


class CTCLossFunction(torch.autograd.Function):
    """K13 under autograd: ``apply(logprobs, y, z_sl, y_sl, blank) -> nll (B,)``. ``forward`` launches K13
    in save mode; ``backward`` launches K13-bwd, which writes the gradient of ``logprobs`` (zero past
    each row's frames). Arguments were checked by :func:`ctc_loss`."""

    @staticmethod
    def forward(ctx, logprobs, y, z_sl, y_sl, blank):
        nll, phi, emit = _forward(logprobs, y, z_sl, y_sl, blank, save=True)
        ctx.blank = blank
        ctx.save_for_backward(logprobs, y, z_sl, y_sl, phi, emit)
        return nll

    @staticmethod
    def backward(ctx, g):
        logprobs, y, z_sl, y_sl, phi, emit = ctx.saved_tensors
        logprobs, g = logprobs.contiguous(), g.to(torch.float32).contiguous()
        B, T, K = logprobs.shape
        d_lp = torch.empty_like(logprobs)
        lib = cuda.library()
        cuda.count_launch("ctc_loss_bwd")
        err = lib.blvm_ctc_loss_bwd(*(_ptr(t) for t in (logprobs, y, z_sl, y_sl, phi, emit, g, d_lp)), B, T,
                                    y.shape[1], K, ctx.blank, LOG_EPSILON, cuda.stream_handle(logprobs))
        cuda.check(err, "ctc_loss_bwd")
        return d_lp, None, None, None, None
