"""K8: the VRNN cell over a sequence (port of the ``nn.scan`` body of
``blvm_tpu/models/vrnn.py`` ``VRNNCell.__call__``, ``:77-92``, and of its prior-only
``generate_step``, ``:94-103``).

Per step, from the state ``h (B, R)`` and the encoded input ``x_t (B, X)``: the prior
MLP and head on ``h``, the posterior MLP and head on ``[h, x_t]`` (the prior mean
added under ``residual_posterior``), ``z = mu + sd * eps_t``, the 4-layer phi MLP, and
the GRU cell on ``[x_t, phi]`` (or ``phi`` alone without ``condition_h_on_x``). In
*prior* mode (generation) the posterior is skipped and ``z`` is the prior's sample, or
its mean under ``use_mode``. Every head's ``sd = softplus(beta raw) / beta + sd_epsilon``.

``weights`` is the 28-tuple of :meth:`blvm_tpu_torch.models.vrnn.VRNNCell.cell_weights`:
the prior MLP's three ``(kernel, bias)`` pairs and its head's, the posterior's the same
(its first kernel ``(R + X, H)``), phi's four pairs, and the GRU's ``w_ih, b_ih, w_hh,
b_hh``, all in the flax ``(in, out)`` layout. The x parts of the posterior's first layer
and of the GRU's input product do not depend on ``h``; both versions compute them for
every step at once, before the chain (:func:`_hoist`), which changes the sums only by
rounding against the JAX step.

:func:`vrnn_cell_plain` is the plain twin, one step at a time, op for op the JAX step.
:func:`vrnn_cell` is the entry point: for CPU tensors the twin; for CUDA tensors one
launch of ``csrc/vrnn_cell.cu``, which has no backward yet, so a call that would need a
gradient raises.
"""

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import softplus_beta
from blvm_tpu_torch.ops.recurrent import gru_update

N_WEIGHTS = 28
# csrc/vrnn_cell.cu: the trace's layout, 9 stages x 4 phases (inputs in, products, finish and store, barrier)
TRACE_STAGES, TRACE_PHASES = 9, 4


class VRNNCellOutputs(NamedTuple):
    """Each ``(B, T', *)``: ``h`` the state after each step (R), ``z`` and the heads'
    ``mu``/``sd`` (Z), ``phi_z`` (H). ``enc_mu`` (with the prior mean added under
    ``residual_posterior``) and ``enc_sd`` are None in prior mode."""

    h: torch.Tensor
    z: torch.Tensor
    phi_z: torch.Tensor
    enc_mu: Optional[torch.Tensor]
    enc_sd: Optional[torch.Tensor]
    prior_mu: torch.Tensor
    prior_sd: torch.Tensor


def _hoist(weights, x, inference: bool, condition_h_on_x: bool):
    """``(xpost, xg, w_post_h, w_ih_phi)``: the x parts of the posterior's first product,
    ``x W_q0[R:] (B, T', H)``, and of the GRU's input product, ``x W_ih[:X] (B, T', 3R)``,
    for all steps (None where the mode or the flags have none), and the rows of both
    kernels that stay inside the chain."""
    w_post, w_ih, w_hh = weights[8], weights[24], weights[26]
    R, X = w_hh.shape[0], x.shape[-1]
    xpost = x @ w_post[R:] if inference else None
    if condition_h_on_x:
        return xpost, x @ w_ih[:X], w_post[:R], w_ih[X:]
    return xpost, None, w_post[:R], w_ih


def _sd(raw, sd_beta: float, sd_epsilon: float):
    return softplus_beta(raw, sd_beta) + sd_epsilon


def vrnn_cell_plain(weights: Sequence[torch.Tensor], x: torch.Tensor, h0: torch.Tensor, eps: Optional[torch.Tensor],
                    *, inference: bool, residual_posterior: bool, condition_h_on_x: bool, use_mode: bool = False,
                    sd_beta: float, sd_epsilon: float) -> VRNNCellOutputs:
    """The cell in plain PyTorch, one step at a time: the twin of K8. ``x (B, T', X)``,
    ``h0 (B, R)``, ``eps (B, T', Z)`` (None in prior mode under ``use_mode``)."""
    (pw0, pb0, pw1, pb1, pw2, pb2, pwh, pbh, _, qb0, qw1, qb1, qw2, qb2, qwh, qbh,
     fw0, fb0, fw1, fb1, fw2, fb2, fw3, fb3, _, b_ih, w_hh, b_hh) = weights
    xpost, xg, qw0_h, w_ih_phi = _hoist(weights, x, inference, condition_h_on_x)
    Z = pwh.shape[1] // 2
    h = h0
    steps = []
    for t in range(x.shape[1]):
        a = torch.relu(h @ pw0 + pb0)
        a = torch.relu(torch.relu(a @ pw1 + pb1) @ pw2 + pb2)
        head = a @ pwh + pbh
        prior_mu, prior_sd = head[..., :Z], _sd(head[..., Z:], sd_beta, sd_epsilon)
        enc_mu = enc_sd = None
        if inference:
            q = torch.relu((h @ qw0_h + xpost[:, t]) + qb0)
            q = torch.relu(torch.relu(q @ qw1 + qb1) @ qw2 + qb2)
            head = q @ qwh + qbh
            enc_mu, enc_sd = head[..., :Z], _sd(head[..., Z:], sd_beta, sd_epsilon)
            if residual_posterior:
                enc_mu = enc_mu + prior_mu
            z = enc_mu + enc_sd * eps[:, t]
        else:
            z = prior_mu if use_mode else prior_mu + prior_sd * eps[:, t]
        phi = z
        for w, b in ((fw0, fb0), (fw1, fb1), (fw2, fb2), (fw3, fb3)):
            phi = torch.relu(phi @ w + b)
        gi = phi @ w_ih_phi
        if xg is not None:
            gi = gi + xg[:, t]
        h = gru_update(gi + b_ih, h @ w_hh + b_hh, h)
        steps.append((h, z, phi, enc_mu, enc_sd, prior_mu, prior_sd))
    return VRNNCellOutputs(*(torch.stack(seq, dim=1) if seq[0] is not None else None for seq in zip(*steps)))


def vrnn_cell(weights: Sequence[torch.Tensor], x: torch.Tensor, h0: torch.Tensor, eps: Optional[torch.Tensor], *,
              inference: bool, residual_posterior: bool, condition_h_on_x: bool, use_mode: bool = False,
              sd_beta: float, sd_epsilon: float, trace: Optional[torch.Tensor] = None) -> VRNNCellOutputs:
    """The cell over the ``T'`` steps of ``x (B, T', X)`` from ``h0 (B, R)`` with the noise
    ``eps (B, T', Z)``: posterior samples (``inference``) or prior ones.

    CPU tensors: :func:`vrnn_cell_plain`. CUDA tensors: the hoisted products (cuBLAS) and
    one launch of K8, all float32, on a grid of one CTA an SM. ``trace``, an int64 tensor of
    :func:`trace_size` zeros on the card, receives the kernel's time by stage and phase
    (:func:`read_trace`). K8 has no backward yet: with gradients enabled, an input or weight
    that requires one raises ``NotImplementedError``.
    """
    kwargs = dict(inference=inference, residual_posterior=residual_posterior, condition_h_on_x=condition_h_on_x,
                  use_mode=use_mode, sd_beta=sd_beta, sd_epsilon=sd_epsilon)
    if not h0.is_cuda:
        return vrnn_cell_plain(weights, x, h0, eps, **kwargs)
    tensors = [*weights, x, h0] + ([eps] if eps is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("K8 has no backward yet: run the VRNN on the card under torch.no_grad() "
                                  "(its training step comes with K8-bwd)")
    _check(weights, x, h0, eps, inference, use_mode)
    if trace is not None and (trace.dtype != torch.int64 or trace.numel() != trace_size() or trace.device != h0.device
                              or not trace.is_contiguous()):
        raise ValueError(f"the trace must be a contiguous int64 tensor of {trace_size()} elements on {h0.device}")
    return _launch(weights, x, h0, eps, trace=trace, **kwargs)


def trace_size() -> int:
    return TRACE_STAGES * TRACE_PHASES + 2


def read_trace(trace: torch.Tensor) -> torch.Tensor:
    """``(9, 4)`` nanoseconds, summed over the launches that filled ``trace``: each stage's
    inputs in, products, finish and store, and barrier, as the first CTA saw them (its SM
    cycles, converted at the rate its clock ran over the whole loop)."""
    t = trace.detach().cpu().double()
    cycles, total_cycles, total_ns = t[:-2], t[-2], t[-1]
    return (cycles * (total_ns / total_cycles)).reshape(TRACE_STAGES, TRACE_PHASES)


def _check(weights, x, h0, eps, inference, use_mode) -> None:
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"vrnn_cell takes {N_WEIGHTS} weights, got {len(weights)}")
    tensors = [*weights, x, h0] + ([eps] if eps is not None else [])
    if any(t.device != h0.device for t in tensors):
        raise ValueError("vrnn_cell: all inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the vrnn_cell kernel takes float32 inputs and weights only (the JAX cell is f32)")
    if x.ndim != 3 or h0.ndim != 2 or x.shape[0] != h0.shape[0]:
        raise ValueError(f"vrnn_cell takes x (B, T', X) and h0 (B, R), got {tuple(x.shape)}, {tuple(h0.shape)}")
    B, T = x.shape[:2]
    R, H, Z = h0.shape[1], weights[0].shape[1], weights[6].shape[1] // 2
    if (inference or not use_mode) and (eps is None or tuple(eps.shape) != (B, T, Z)):
        raise ValueError(f"vrnn_cell needs eps of shape ({B}, {T}, {Z}), got "
                         f"{None if eps is None else tuple(eps.shape)}")
    if tuple(weights[26].shape) != (R, 3 * R) or tuple(weights[0].shape) != (R, H) or weights[6].shape[0] != H:
        raise ValueError(f"vrnn_cell: for h0 of width {R} expected w_hh ({R}, {3 * R}) and the prior's first kernel "
                         f"({R}, {H}); got {tuple(weights[26].shape)}, {tuple(weights[0].shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(weights, x, h0, eps, *, inference, residual_posterior, condition_h_on_x, use_mode, sd_beta, sd_epsilon,
            trace):
    """One launch of K8 after the hoisted products; returns :class:`VRNNCellOutputs`."""
    weights = [w.contiguous() for w in weights]
    x, h0 = x.contiguous(), h0.contiguous()
    eps = eps.contiguous() if eps is not None and (inference or not use_mode) else None
    xpost, xg, qw0_h, w_ih_phi = _hoist(weights, x, inference, condition_h_on_x)
    kernel_weights = weights[:8] + [qw0_h] + weights[9:24] + [w_ih_phi] + weights[25:]
    B, T = x.shape[:2]
    R, H, Z = h0.shape[1], weights[0].shape[1], weights[6].shape[1] // 2
    dev = h0.device

    def out(width):
        return torch.empty((B, T, width), dtype=torch.float32, device=dev)

    outputs = [out(R), out(Z), out(H), out(Z) if inference else None, out(Z) if inference else None, out(Z), out(Z)]
    scratch = torch.empty(9 * B * H, dtype=torch.float32, device=dev)
    barrier = torch.empty(1, dtype=torch.int32, device=dev)
    w_ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    o_ptrs = (ctypes.c_void_p * len(outputs))(*(_ptr(o) for o in outputs))
    lib = cuda.library()
    cuda.count_launch("vrnn_cell")
    err = lib.blvm_vrnn_cell(
        ctypes.addressof(w_ptrs), h0.data_ptr(), _ptr(xpost), _ptr(xg), _ptr(eps), ctypes.addressof(o_ptrs),
        scratch.data_ptr(), barrier.data_ptr(), _ptr(trace), B, T, R, H, Z, int(inference), int(residual_posterior),
        int(use_mode), sd_beta, sd_epsilon, cuda.stream_handle(h0),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K8 (vrnn_cell): the weights of R={R}, H={H}, Z={Z} at B={B} do not fit the shared "
                           "memory of a grid of one CTA an SM that is all resident")
    cuda.check(err, "vrnn_cell")
    return VRNNCellOutputs(*outputs)
