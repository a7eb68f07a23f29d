"""K9: the SRNN's latent chain over a sequence (port of the ``nn.scan`` body of
``blvm_tpu/models/srnn.py`` ``_SRNNStep.__call__``, ``:68-96``, and of its prior-only
``prior_step``, ``:98-108``, ungated and without ``phi_z``: the model ``SRNNAudio`` builds).

Per step, from the previous sample ``z_{t-1} (B, Z)`` and the step's ``d_t`` and ``a_t``
``(B, R)``: the prior's 3-layer LeakyReLU MLP on ``[d_t, z_{t-1}]`` and its Gaussian head,
the posterior's on ``[a_t, z_{t-1}]`` (the prior mean added under ``residual_posterior``),
and ``z = mu + sd * eps_t``. In *prior* mode (generation) the posterior is skipped and
``z`` is the prior's sample, or its mean under ``use_mode``. Every head's
``sd = softplus(beta raw) / beta + sd_epsilon``.

``weights`` is the 16-tuple of :meth:`blvm_tpu_torch.models.srnn._SRNNStep.chain_weights`:
the prior MLP's three ``(kernel, bias)`` pairs (its first kernel ``(R + Z, H)``) and its
head's, then the posterior's, all in the flax ``(in, out)`` layout. The d and a parts of
the two first layers do not depend on z; every version computes them with their biases for
every step at once, before the chain (:func:`hoist`: ``xp = d W_p0[:R] + b_p0``, ``xq = a
W_q0[:R] + b_q0``), which changes the sums only by rounding against the JAX step. The chain
takes the *kernel weights*: the 14 with the two first kernels cut to their z rows and their
biases left out.

:func:`srnn_chain_plain` is the plain twin of K9, one step at a time, op for op the JAX
step after the hoist. :func:`srnn_chain` is the entry point: for CPU tensors the twin; for
CUDA tensors one launch of ``csrc/srnn_chain.cu`` (forward only: K9-bwd is not written yet,
so a call that needs a gradient on the card raises).
"""

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import softplus_beta

N_KERNEL_WEIGHTS = 14
# the trace's layout, K9's 4 stages (csrc/srnn_chain.cu: L1, L2, L3, the heads and z) x 4 phases (inputs in,
# products, finish and store, barrier)
TRACE_STAGES, TRACE_PHASES = 4, 4


class SRNNChainOutputs(NamedTuple):
    """Each ``(B, T', Z)``: the samples ``z`` and both heads' ``mu`` and ``sd``; ``enc_mu``
    (with the prior mean added under ``residual_posterior``) and ``enc_sd`` are None in
    prior mode."""

    z: torch.Tensor
    enc_mu: Optional[torch.Tensor]
    enc_sd: Optional[torch.Tensor]
    prior_mu: torch.Tensor
    prior_sd: torch.Tensor


def hoist(weights: Sequence[torch.Tensor], d: torch.Tensor, a: Optional[torch.Tensor], inference: bool):
    """``(xp, xq, kernel_weights)``: the d part of the prior's first layer with its bias,
    ``d W_p0[:R] + b_p0 (B, T', H)``, the a part of the posterior's (None in prior mode), and
    the 14 weights the chain keeps (both first kernels cut to their z rows, their biases out)."""
    pw0, pb0, qw0, qb0 = weights[0], weights[1], weights[8], weights[9]
    R = d.shape[-1]
    xp = d @ pw0[:R] + pb0
    xq = a @ qw0[:R] + qb0 if inference else None
    return xp, xq, (pw0[R:], *weights[2:8], qw0[R:], *weights[10:16])


def _leaky_relu(v):
    return F.leaky_relu(v, 0.01)


def _sd(raw, sd_beta: float, sd_epsilon: float):
    return softplus_beta(raw, sd_beta) + sd_epsilon


def srnn_chain_plain(kernel_weights: Sequence[torch.Tensor], xp: torch.Tensor, xq: Optional[torch.Tensor],
                     z0: torch.Tensor, eps: Optional[torch.Tensor], *, inference: bool, residual_posterior: bool,
                     use_mode: bool = False, sd_beta: float, sd_epsilon: float) -> SRNNChainOutputs:
    """The chain of K9 in plain PyTorch, one step at a time, from the hoisted products:
    ``xp``, ``xq (B, T', H)`` (``xq`` None in prior mode), ``z0 (B, Z)``, ``eps (B, T', Z)``
    (None in prior mode under ``use_mode``)."""
    pw0_z, pw1, pb1, pw2, pb2, pwh, pbh, qw0_z, qw1, qb1, qw2, qb2, qwh, qbh = kernel_weights
    Z = pwh.shape[1] // 2
    z = z0
    steps = []
    for t in range(xp.shape[1]):
        p1 = _leaky_relu(z @ pw0_z + xp[:, t])
        p2 = _leaky_relu(p1 @ pw1 + pb1)
        p3 = _leaky_relu(p2 @ pw2 + pb2)
        head = p3 @ pwh + pbh
        prior_mu, prior_sd = head[..., :Z], _sd(head[..., Z:], sd_beta, sd_epsilon)
        enc_mu = enc_sd = None
        if inference:
            q1 = _leaky_relu(z @ qw0_z + xq[:, t])
            q2 = _leaky_relu(q1 @ qw1 + qb1)
            q3 = _leaky_relu(q2 @ qw2 + qb2)
            head = q3 @ qwh + qbh
            enc_mu, enc_sd = head[..., :Z], _sd(head[..., Z:], sd_beta, sd_epsilon)
            if residual_posterior:
                enc_mu = enc_mu + prior_mu
            z = enc_mu + enc_sd * eps[:, t]
        else:
            z = prior_mu if use_mode else prior_mu + prior_sd * eps[:, t]
        steps.append((z, enc_mu, enc_sd, prior_mu, prior_sd))
    return SRNNChainOutputs(*(torch.stack(seq, dim=1) if seq[0] is not None else None for seq in zip(*steps)))


def srnn_chain(kernel_weights: Sequence[torch.Tensor], xp: torch.Tensor, xq: Optional[torch.Tensor],
               z0: torch.Tensor, eps: Optional[torch.Tensor], *, inference: bool, residual_posterior: bool,
               use_mode: bool = False, sd_beta: float, sd_epsilon: float,
               trace: Optional[torch.Tensor] = None) -> SRNNChainOutputs:
    """The chain over the ``T'`` steps of the hoisted ``xp (B, T', H)`` (and ``xq``) from
    ``z0 (B, Z)`` with the noise ``eps (B, T', Z)``: posterior samples (``inference``) or
    prior ones.

    CPU tensors: :func:`srnn_chain_plain`. CUDA tensors: one launch of K9, all float32, on a
    grid of one CTA an SM; ``trace``, an int64 tensor of :func:`trace_size` zeros on the card,
    receives the kernel's time by stage and phase (:func:`read_trace`). A call that needs a
    gradient on the card raises ``NotImplementedError`` (K9-bwd is the next slice's kernel).
    """
    kwargs = dict(inference=inference, residual_posterior=residual_posterior, use_mode=use_mode, sd_beta=sd_beta,
                  sd_epsilon=sd_epsilon)
    if not z0.is_cuda:
        return srnn_chain_plain(kernel_weights, xp, xq, z0, eps, **kwargs)
    tensors = [*kernel_weights, xp, z0] + [t for t in (xq, eps) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("srnn_chain (K9) has no backward on the card yet (K9-bwd is still to be "
                                  "written); run it under torch.no_grad() or on CPU tensors")
    _check(kernel_weights, xp, xq, z0, eps, inference, use_mode)
    _check_trace(trace, z0)
    return _launch(kernel_weights, xp, xq, z0, eps, trace=trace, **kwargs)


def trace_size() -> int:
    return TRACE_STAGES * TRACE_PHASES + 2


def read_trace(trace: torch.Tensor) -> torch.Tensor:
    """``(4, 4)`` nanoseconds, summed over the launches that filled ``trace``: each stage's
    inputs in, products, finish and store, and barrier, as the first CTA saw them (its SM
    cycles, converted at the rate its clock ran over the whole loop)."""
    t = trace.detach().cpu().double()
    cycles, total_cycles, total_ns = t[:-2], t[-2], t[-1]
    return (cycles * (total_ns / total_cycles)).reshape(-1, TRACE_PHASES)


def _check_trace(trace, z0) -> None:
    if trace is not None and (trace.dtype != torch.int64 or trace.numel() != trace_size() or trace.device != z0.device
                              or not trace.is_contiguous()):
        raise ValueError(f"the trace must be a contiguous int64 tensor of {trace_size()} elements on {z0.device}")


def _check(kernel_weights, xp, xq, z0, eps, inference, use_mode) -> None:
    if len(kernel_weights) != N_KERNEL_WEIGHTS:
        raise ValueError(f"srnn_chain takes {N_KERNEL_WEIGHTS} kernel weights, got {len(kernel_weights)}")
    tensors = [*kernel_weights, xp, z0] + [t for t in (xq, eps) if t is not None]
    if any(t.device != z0.device for t in tensors):
        raise ValueError("srnn_chain: all inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the srnn_chain kernel takes float32 inputs and weights only (the JAX step is f32)")
    if xp.ndim != 3 or z0.ndim != 2 or xp.shape[0] != z0.shape[0]:
        raise ValueError(f"srnn_chain takes xp (B, T', H) and z0 (B, Z), got {tuple(xp.shape)}, {tuple(z0.shape)}")
    B, T, H = xp.shape
    Z = z0.shape[1]
    expected = [(Z, H), (H, H), (H,), (H, H), (H,), (H, 2 * Z), (2 * Z,)] * 2
    wrong = [i for i, (w, shape) in enumerate(zip(kernel_weights, expected)) if tuple(w.shape) != shape]
    if wrong:
        raise ValueError(f"srnn_chain: for xp {tuple(xp.shape)} and z0 {tuple(z0.shape)} expected the kernel weights' "
                         f"shapes {expected}; weights {wrong} differ")
    if inference and (xq is None or tuple(xq.shape) != (B, T, H)):
        raise ValueError(f"srnn_chain in inference mode needs xq of shape ({B}, {T}, {H})")
    if (inference or not use_mode) and (eps is None or tuple(eps.shape) != (B, T, Z)):
        raise ValueError(f"srnn_chain needs eps of shape ({B}, {T}, {Z}), got "
                         f"{None if eps is None else tuple(eps.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(kernel_weights, xp, xq, z0, eps, *, inference, residual_posterior, use_mode, sd_beta, sd_epsilon,
            trace) -> SRNNChainOutputs:
    """One launch of K9 on the hoisted products."""
    kernel_weights = [w.contiguous() for w in kernel_weights]
    xp, z0 = xp.contiguous(), z0.contiguous()
    xq = xq.contiguous() if inference else None
    eps = eps.contiguous() if inference or not use_mode else None
    B, T, H = xp.shape
    Z = z0.shape[1]

    def out():
        return torch.empty((B, T, Z), dtype=torch.float32, device=z0.device)

    outputs = [out(), out() if inference else None, out() if inference else None, out(), out()]
    act = torch.empty(6 * B * H, dtype=torch.float32, device=z0.device)
    barrier = torch.empty(1, dtype=torch.int32, device=z0.device)
    w_ptrs = (ctypes.c_void_p * N_KERNEL_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    o_ptrs = (ctypes.c_void_p * len(outputs))(*(_ptr(o) for o in outputs))
    lib = cuda.library()
    cuda.count_launch("srnn_chain")
    err = lib.blvm_srnn_chain(
        ctypes.addressof(w_ptrs), xp.data_ptr(), _ptr(xq), z0.data_ptr(), _ptr(eps), ctypes.addressof(o_ptrs),
        act.data_ptr(), barrier.data_ptr(), _ptr(trace), B, T, H, Z, int(inference), int(residual_posterior),
        int(use_mode), sd_beta, sd_epsilon, cuda.stream_handle(z0),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K9 (srnn_chain): the weights of H={H}, Z={Z} at B={B} do not fit the shared memory of a "
                           "grid of one CTA an SM that is all resident")
    cuda.check(err, "srnn_chain")
    return SRNNChainOutputs(*outputs)
