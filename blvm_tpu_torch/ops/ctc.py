"""K13: the CTC loss of the ASR probe, optax's ``ctc_loss`` (``blvm_tpu/models/lstm_asr.py:80``).

optax runs a ``lax.scan`` over the frames with two sets of log-space states (the blank after ``n``
labels, and label ``n`` being emitted) and ``log_epsilon = -1e5`` standing in for ``log 0``, so a row
whose labels cannot fit its frames scores a large finite number (PyTorch's ``F.ctc_loss`` gives
``inf`` there) and a row with no frames and no labels ``-0.0``. :func:`ctc_loss_plain` is that
recursion in plain PyTorch, step for step: the twin, and the CPU path (autograd gives its gradient).
:func:`ctc_loss` is the entry point: CPU tensors, the twin; CUDA tensors, one launch of
``csrc/ctc.cu`` over ``log_softmax(logits)`` (K13, a warp a row), under autograd :class:`CTCLossFunction`:
K13 in save mode, which runs alpha (the states) and beta (their log-adjoints) side by side, and K13-bwd,
which reads both and writes each frame's posterior as the gradient of the log-probabilities, with no
recursion; ``log_softmax``'s backward takes it on to the logits. :func:`ctc_alpha_beta_plain` and
:func:`ctc_loss_grad_plain` are that alpha-beta form in plain PyTorch, K13-bwd's twin, for the tests only.
PyTorch's CUDA ``F.ctc_loss`` is not used: it synchronizes the stream several times a call (it copies
host-made offsets and lengths to the card from pageable memory), and the kernel reads its lengths from
the card.
"""

import torch
import torch.nn.functional as F

from blvm_tpu_torch.ops import cuda

LOG_EPSILON = -1e5  # optax.ctc_loss's default: its stand-in for log(0)
K13_MAX_LABELS = 1023  # csrc/ctc.cu: up to 8 warps a row, 4 states a lane (N + 1 <= 1024)
K13_MAX_CLASSES = 4096  # csrc/ctc.cu: K13-bwd keeps a list head a class in shared memory
# csrc/ctc.cu (Stage): a trace's stages, then the loop's total cycles and nanoseconds
TRACE_STAGES = ("exchange", "emissions", "stores", "arithmetic")
TRACE_SIZE = len(TRACE_STAGES) + 2


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


def ctc_alpha_beta_plain(logprobs: torch.Tensor, z_sl: torch.Tensor, y: torch.Tensor, y_sl: torch.Tensor,
                         blank: int = 0, log_epsilon: float = LOG_EPSILON):
    """K13's save mode in plain PyTorch: ``(alpha, beta)``, each ``(B, T + 1, 2N + 1)`` in the layout of
    ``csrc/ctc.cu`` (phi_0..phi_N, then emit_0..emit_{N-1}), from log-probabilities ``(B, T, K)``. alpha is
    the recursion of :func:`ctc_loss_plain` before every frame and after the last; beta the log-adjoint, log
    d exp(L) / d exp(state), 0 on the states the loss reads and ``-inf`` elsewhere at the end. Past a row's
    frames alpha keeps its last state and beta its first. Test-only: the twin of what K13-bwd reads."""
    B, T, _ = logprobs.shape
    N = y.shape[1]
    dtype, device = logprobs.dtype, logprobs.device
    y = y.long()
    repeat = F.pad((y[:, :-1] == y[:, 1:]).to(dtype), (0, 1))  # (B, N): label n equals label n + 1
    blank_lp = logprobs[:, :, blank, None]  # (B, T, 1)
    emit_lp = torch.gather(logprobs, 2, y[:, None, :].expand(B, T, N))  # (B, T, N)
    pad = (torch.arange(T, device=device)[None] >= z_sl[:, None])[:, :, None]  # (B, T, 1)
    phi = torch.full((B, N + 1), log_epsilon, dtype=dtype, device=device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, dtype=dtype, device=device)
    alpha = [torch.cat([phi, emit], 1)]
    for t in range(T):
        f, e = blank_lp[:, t], emit_lp[:, t]
        a = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], emit + log_epsilon * repeat)], 1)
        next_emit = torch.logaddexp(a[:, :-1] + e, emit + e)
        next_phi = torch.cat([a[:, :1] + f, torch.logaddexp(a[:, 1:] + f, emit + f + log_epsilon * (1.0 - repeat))], 1)
        emit, phi = torch.where(pad[:, t], emit, next_emit), torch.where(pad[:, t], phi, next_phi)
        alpha.append(torch.cat([phi, emit], 1))

    # beta through a frame, the adjoint of each exp-space sum: phi_n feeds emit'_n and phi'_n; emit_n feeds emit'_n,
    # and (through a_{n+1}, or directly under d) emit'_{n+1} and phi'_{n+1}
    no_path = float("-inf")
    ls = y_sl.long().clamp(0, N)[:, None]
    cols = torch.arange(N + 1, device=device)[None]
    b_phi = torch.where(cols == ls, 0.0, no_path).to(dtype)
    b_emit = torch.where(cols[:, :N] + 1 == ls, 0.0, no_path).to(dtype)
    c, d = log_epsilon * repeat, log_epsilon * (1.0 - repeat)  # the edges into position n + 1
    beta = [torch.cat([b_phi, b_emit], 1)]
    for t in range(T - 1, -1, -1):
        f, e = blank_lp[:, t], emit_lp[:, t]
        stay = b_emit + e
        next_phi = torch.logaddexp(F.pad(stay, (0, 1), value=no_path), b_phi + f)
        up_emit = F.pad(b_emit[:, 1:] + e[:, 1:], (0, 1), value=no_path)
        up_phi = b_phi[:, 1:] + f
        next_emit = torch.logsumexp(torch.stack([stay, up_emit + c, up_phi + c, up_phi + d]), 0)
        b_emit, b_phi = torch.where(pad[:, t], b_emit, next_emit), torch.where(pad[:, t], b_phi, next_phi)
        beta.append(torch.cat([b_phi, b_emit], 1))
    return torch.stack(alpha, 1), torch.stack(beta[::-1], 1)


def ctc_loss_grad_plain(alpha: torch.Tensor, beta: torch.Tensor, y: torch.Tensor, z_sl: torch.Tensor,
                        g: torch.Tensor, num_classes: int, blank: int = 0) -> torch.Tensor:
    """K13-bwd in plain PyTorch: the gradient ``(B, T, K)`` of ``sum_b g_b loss_b`` with respect to the
    log-probabilities, from :func:`ctc_alpha_beta_plain`'s states. Frame t's row is minus ``g_b`` times the
    posterior of the states after it, exp(alpha + beta - Z) with Z their logsumexp (the log-likelihood), the
    phi states' summed into the blank's column and each emit_n's into label n's; 0 past the row's frames."""
    B, T = alpha.shape[0], alpha.shape[1] - 1
    N = y.shape[1]
    v = alpha[:, 1:] + beta[:, 1:]
    post = torch.exp(v - torch.logsumexp(v, -1, keepdim=True))
    d = torch.zeros(B, T, num_classes, dtype=alpha.dtype, device=alpha.device)
    d[:, :, blank] = post[:, :, :N + 1].sum(-1)
    d.scatter_add_(2, y.long()[:, None, :].expand(B, T, N), post[:, :, N + 1:])
    live = (torch.arange(T, device=alpha.device)[None] < z_sl[:, None])[:, :, None]
    return torch.where(live, -g.to(alpha.dtype)[:, None, None] * d, 0.0)


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
    if not (B >= 1 and T >= 1 and 1 <= y.shape[1] <= K13_MAX_LABELS and K <= K13_MAX_CLASSES and 0 <= blank < K):
        raise ValueError(f"the ctc_loss kernel takes B, T >= 1, 1 to {K13_MAX_LABELS} label columns (up to 8 warps "
                         f"a row), at most {K13_MAX_CLASSES} classes and a blank among them; got B={B}, T={T}, "
                         f"N={y.shape[1]}, K={K}, blank={blank}")


def _forward(logprobs, y, z_sl, y_sl, blank, save: bool, trace=None):
    """One launch of K13: ``(nll (B,), alpha, beta)``, with ``save`` the states before every frame and after
    the last and their log-adjoints, ``(B, T + 1, 2N + 1)`` float64 each (phi_0..phi_N, then emit_0..emit_{N-1};
    only the live states written: phi up to ``y_sl``, emit below it, frames up to ``z_sl``), else None.
    ``trace``, an int64 tensor of :data:`TRACE_SIZE` zeros on the card, receives the first row's cycles by
    stage (:func:`read_trace`)."""
    logprobs = logprobs.contiguous()
    B, T, K = logprobs.shape
    N = y.shape[1]
    nll = torch.empty(B, dtype=torch.float32, device=logprobs.device)
    alpha, beta = ((torch.empty((B, T + 1, 2 * N + 1), dtype=torch.float64, device=logprobs.device)
                    for _ in range(2)) if save else (None, None))
    lib = cuda.library()
    cuda.count_launch("ctc_loss")
    err = lib.blvm_ctc_loss(*(_ptr(t) for t in (logprobs, y, z_sl, y_sl, nll, alpha, beta, trace)), B, T, N, K, blank,
                            LOG_EPSILON, cuda.stream_handle(logprobs))
    cuda.check(err, "ctc_loss")
    return nll, alpha, beta


def read_trace(trace: torch.Tensor) -> torch.Tensor:
    """``(4,)`` nanoseconds of :data:`TRACE_STAGES`, summed over the launches that filled ``trace``, as the
    first thread of the first row's chain saw them (its SM cycles, converted at the rate its clock ran over
    the whole loop)."""
    t = trace.detach().cpu().double()
    return t[:len(TRACE_STAGES)] * (t[-1] / t[-2])


def _ptr(t):
    return None if t is None else t.data_ptr()


class CTCLossFunction(torch.autograd.Function):
    """K13 under autograd: ``apply(logprobs, y, z_sl, y_sl, blank) -> nll (B,)``. ``forward`` launches K13
    in save mode (alpha and beta); ``backward`` launches K13-bwd, which writes the gradient of ``logprobs``
    from them, a frame's posterior a row of it (zero past each row's frames). Arguments were checked by
    :func:`ctc_loss`."""

    @staticmethod
    def forward(ctx, logprobs, y, z_sl, y_sl, blank):
        nll, alpha, beta = _forward(logprobs, y, z_sl, y_sl, blank, save=True)
        ctx.blank, ctx.num_classes = blank, logprobs.shape[2]
        ctx.save_for_backward(y, z_sl, y_sl, alpha, beta)
        return nll

    @staticmethod
    def backward(ctx, g):
        y, z_sl, y_sl, alpha, beta = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        B, T = alpha.shape[0], alpha.shape[1] - 1
        d_lp = torch.empty((B, T, ctx.num_classes), dtype=torch.float32, device=alpha.device)
        lib = cuda.library()
        cuda.count_launch("ctc_loss_bwd")
        err = lib.blvm_ctc_loss_bwd(*(_ptr(t) for t in (y, z_sl, y_sl, alpha, beta, g, d_lp)), B, T, y.shape[1],
                                    ctx.num_classes, ctx.blank, cuda.stream_handle(alpha))
        cuda.check(err, "ctc_loss_bwd")
        return d_lp, None, None, None, None
