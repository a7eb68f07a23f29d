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
step after the hoist; :func:`srnn_chain_backward_plain` the twin of K9-bwd, the reverse chain
one step at a time. :func:`srnn_chain` is the entry point: for CPU tensors the twin; for CUDA
tensors one launch of ``csrc/srnn_chain.cu``. Where a gradient is needed in inference mode it
runs :class:`SRNNChainFunction`: the forward saves what the backward needs
(:func:`srnn_chain_save`; K9's save mode on the card), the backward is one
:func:`srnn_chain_backward` (K9-bwd, ``csrc/srnn_chain_bwd.cu``, on the card) and the weight
gradients as sums over the ``B T'`` rows (:func:`chain_weight_grads`). The LeakyReLU's slope
at exactly 0 is 1 everywhere, as ``jax.nn.leaky_relu``'s gradient has it (torch's
``F.leaky_relu`` gives 0.01 there): at a fresh init, with zero biases and zero initial states,
the prior's first pre-activation is exactly 0 at the first step.
"""

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from blvm_tpu_torch.modules.common import leaky_relu
from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import softplus_beta
from blvm_tpu_torch.ops.vrnn import _field, _fields  # K8's (offset, width) layouts of a row-step

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


def save_fields(H: int, Z: int) -> Dict[str, Tuple[int, int]]:
    """``name: (offset, width)`` of a row-step of the saved forward (K9's save mode): the
    pre-activations of the prior's and the posterior's L1-L3 and both heads' raw sd."""
    return _fields([(n, H) for n in ("p1", "q1", "p2", "q2", "p3", "q3")] + [("raw_p", Z), ("raw_q", Z)])


def grad_fields(H: int, Z: int) -> Dict[str, Tuple[int, int]]:
    """``name: (offset, width)`` of a row-step of K9-bwd's output: the pre-activation gradients
    of both heads (mu then raw sd) and of the MLPs' L3 to L1 (``p1`` is also d xp, ``q1`` d xq)."""
    return _fields([("head_p", 2 * Z), ("head_q", 2 * Z)] + [(f"{m}{k}", H) for k in (3, 2, 1) for m in "pq"])


def _sd(raw, sd_beta: float, sd_epsilon: float):
    return softplus_beta(raw, sd_beta) + sd_epsilon


def srnn_chain_plain(kernel_weights: Sequence[torch.Tensor], xp: torch.Tensor, xq: Optional[torch.Tensor],
                     z0: torch.Tensor, eps: Optional[torch.Tensor], *, inference: bool, residual_posterior: bool,
                     use_mode: bool = False, sd_beta: float, sd_epsilon: float) -> SRNNChainOutputs:
    """The chain of K9 in plain PyTorch, one step at a time, from the hoisted products:
    ``xp``, ``xq (B, T', H)`` (``xq`` None in prior mode), ``z0 (B, Z)``, ``eps (B, T', Z)``
    (None in prior mode under ``use_mode``)."""
    return _chain_plain(kernel_weights, xp, xq, z0, eps, inference=inference, residual_posterior=residual_posterior,
                        use_mode=use_mode, sd_beta=sd_beta, sd_epsilon=sd_epsilon, save=False)[0]


def _chain_plain(kernel_weights, xp, xq, z0, eps, *, inference, residual_posterior, use_mode, sd_beta, sd_epsilon,
                 save: bool) -> Tuple[SRNNChainOutputs, Optional[torch.Tensor]]:
    """:func:`srnn_chain_plain` and, with ``save`` (inference mode), K9's save buffer ``(B, T',
    6H + 2Z)`` laid out as :func:`save_fields`, else None."""
    pw0_z, pw1, pb1, pw2, pb2, pwh, pbh, qw0_z, qw1, qb1, qw2, qb2, qwh, qbh = kernel_weights
    Z = pwh.shape[1] // 2
    z = z0
    steps, saved = [], []
    for t in range(xp.shape[1]):
        p1 = z @ pw0_z + xp[:, t]
        p2 = leaky_relu(p1) @ pw1 + pb1
        p3 = leaky_relu(p2) @ pw2 + pb2
        head = leaky_relu(p3) @ pwh + pbh
        prior_mu, raw_p = head[..., :Z], head[..., Z:]
        prior_sd = _sd(raw_p, sd_beta, sd_epsilon)
        enc_mu = enc_sd = None
        if inference:
            q1 = z @ qw0_z + xq[:, t]
            q2 = leaky_relu(q1) @ qw1 + qb1
            q3 = leaky_relu(q2) @ qw2 + qb2
            head = leaky_relu(q3) @ qwh + qbh
            enc_mu, raw_q = head[..., :Z], head[..., Z:]
            enc_sd = _sd(raw_q, sd_beta, sd_epsilon)
            if residual_posterior:
                enc_mu = enc_mu + prior_mu
            z = enc_mu + enc_sd * eps[:, t]
            if save:
                saved.append(torch.cat([p1, q1, p2, q2, p3, q3, raw_p, raw_q], dim=-1))
        else:
            z = prior_mu if use_mode else prior_mu + prior_sd * eps[:, t]
        steps.append((z, enc_mu, enc_sd, prior_mu, prior_sd))
    outputs = SRNNChainOutputs(*(torch.stack(seq, dim=1) if seq[0] is not None else None for seq in zip(*steps)))
    return outputs, torch.stack(saved, dim=1) if save else None


def srnn_chain_backward_plain(kernel_weights: Sequence[torch.Tensor], eps: torch.Tensor, saved: torch.Tensor,
                              grads: Sequence[Optional[torch.Tensor]], *, residual_posterior: bool,
                              sd_beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of K9-bwd: the reverse chain in plain PyTorch, one step at a time. From the kernel
    weights, the noise, what the forward saved (:func:`save_fields`) and the gradients of its five
    outputs (``z, enc_mu, enc_sd, prior_mu, prior_sd``; None for zero): ``(dpre (B, T', 4Z + 6H),
    dz0 (B, Z))``, ``dpre`` every step's pre-activation gradients laid out as :func:`grad_fields`."""
    pw0_z, pw1, _, pw2, _, pwh, _, qw0_z, qw1, _, qw2, _, qwh, _ = kernel_weights
    B, T, Z = eps.shape
    sf = save_fields(pw1.shape[0], Z)
    zero = torch.zeros((), dtype=saved.dtype, device=saved.device)
    g_z, g_qmu, g_qsd, g_pmu, g_psd = (zero if g is None else g for g in grads)

    def at(g, t):
        return g[:, t] if g.ndim else g

    def slope(d, pre):  # jax.nn.leaky_relu's gradient: 1 where pre >= 0
        return torch.where(pre >= 0, d, 0.01 * d)

    dz = torch.zeros((B, Z), dtype=saved.dtype, device=saved.device)
    steps = []
    for t in range(T - 1, -1, -1):
        s = saved[:, t]
        dz = dz + at(g_z, t)
        dmu_q = dz + at(g_qmu, t)
        dsd_q = dz * eps[:, t] + at(g_qsd, t)
        dmu_p = at(g_pmu, t) + dmu_q if residual_posterior else at(g_pmu, t) + torch.zeros_like(dz)
        d_head_p = torch.cat([dmu_p, at(g_psd, t) * torch.sigmoid(sd_beta * _field(s, sf, "raw_p"))], dim=-1)
        d_head_q = torch.cat([dmu_q, dsd_q * torch.sigmoid(sd_beta * _field(s, sf, "raw_q"))], dim=-1)
        d_p3 = slope(d_head_p @ pwh.T, _field(s, sf, "p3"))
        d_q3 = slope(d_head_q @ qwh.T, _field(s, sf, "q3"))
        d_p2 = slope(d_p3 @ pw2.T, _field(s, sf, "p2"))
        d_q2 = slope(d_q3 @ qw2.T, _field(s, sf, "q2"))
        d_p1 = slope(d_p2 @ pw1.T, _field(s, sf, "p1"))
        d_q1 = slope(d_q2 @ qw1.T, _field(s, sf, "q1"))
        dz = d_p1 @ pw0_z.T + d_q1 @ qw0_z.T
        steps.append(torch.cat([d_head_p, d_head_q, d_p3, d_q3, d_p2, d_q2, d_p1, d_q1], dim=-1))
    return torch.stack(steps[::-1], dim=1), dz


def chain_weight_grads(kernel_weights: Sequence[torch.Tensor], z0: torch.Tensor, z: torch.Tensor,
                       saved: torch.Tensor, dpre: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients of the 14 kernel weights: each kernel's is (its layer's input)^T (its
    pre-activation gradient), a sum over the ``B T'`` rows, one GEMM (cuBLAS on the card); the
    first kernels' z rows take ``z_{t-1}`` (``z`` shifted, ``z0`` first), the others the
    LeakyReLU of the saved pre-activation below; every bias's is that gradient's column sum, all
    six in one product with a row of ones."""
    B, T, Z = z.shape
    H = kernel_weights[1].shape[0]
    sf, gf = save_fields(H, Z), grad_fields(H, Z)
    rows = B * T
    dp = dpre.reshape(rows, -1)
    acts = leaky_relu(saved[..., :6 * H].reshape(rows, 6 * H))  # p1, q1, p2, q2, p3, q3, as save_fields
    z_prev = torch.cat([z0[:, None], z[:, :-1]], dim=1).reshape(rows, Z)
    bias = (torch.ones((1, rows), dtype=dpre.dtype, device=dpre.device) @ dp)[0]
    grads = []
    for m in "pq":
        grads.append(z_prev.t() @ _field(dp, gf, f"{m}1"))
        for below, name in ((f"{m}1", f"{m}2"), (f"{m}2", f"{m}3"), (f"{m}3", f"head_{m}")):
            grads.append(_field(acts, sf, below).t() @ _field(dp, gf, name))
            grads.append(_field(bias, gf, name).clone())
    return tuple(grads)


class SRNNChainFunction(torch.autograd.Function):
    """The chain in inference mode as one differentiable op over the hoisted products:
    ``apply(residual_posterior, sd_beta, sd_epsilon, xp, xq, z0, eps, *kernel_weights)`` -> the
    five outputs of :class:`SRNNChainOutputs`. The forward saves what the backward needs
    (:func:`srnn_chain_save`); the backward runs :func:`srnn_chain_backward` once and
    :func:`chain_weight_grads`, and returns the gradients of ``xp``, ``xq``, ``z0`` and the
    kernel weights (none for the noise ``eps``). An output gradient autograd has none for
    arrives as None and is read as zero."""

    @staticmethod
    def forward(ctx, residual_posterior, sd_beta, sd_epsilon, xp, xq, z0, eps, *kernel_weights):
        outputs, saved = srnn_chain_save(kernel_weights, xp, xq, z0, eps, residual_posterior=residual_posterior,
                                         sd_beta=sd_beta, sd_epsilon=sd_epsilon)
        ctx.set_materialize_grads(False)
        ctx.residual_posterior, ctx.sd_beta = residual_posterior, sd_beta
        ctx.save_for_backward(z0, eps, outputs.z, saved, *kernel_weights)
        return tuple(outputs)

    @staticmethod
    def backward(ctx, *grads):
        z0, eps, z, saved, *kernel_weights = ctx.saved_tensors
        dpre, dz0 = srnn_chain_backward(kernel_weights, eps, saved, grads, residual_posterior=ctx.residual_posterior,
                                        sd_beta=ctx.sd_beta)
        gf = grad_fields(kernel_weights[1].shape[0], z.shape[-1])
        weight_grads = chain_weight_grads(kernel_weights, z0, z, saved, dpre)
        return (None, None, None, _field(dpre, gf, "p1"), _field(dpre, gf, "q1"), dz0, None, *weight_grads)


def srnn_chain_save(kernel_weights: Sequence[torch.Tensor], xp: torch.Tensor, xq: torch.Tensor, z0: torch.Tensor,
                    eps: torch.Tensor, *, residual_posterior: bool, sd_beta: float,
                    sd_epsilon: float) -> Tuple[SRNNChainOutputs, torch.Tensor]:
    """The forward of :class:`SRNNChainFunction` (inference mode) from the hoisted products:
    ``(outputs, saved)``. CPU tensors: the twin with ``save``; CUDA tensors: one launch of K9 in
    save mode (its outputs the same bits as without)."""
    kwargs = dict(inference=True, residual_posterior=residual_posterior, use_mode=False, sd_beta=sd_beta,
                  sd_epsilon=sd_epsilon)
    if not z0.is_cuda:
        return _chain_plain(kernel_weights, xp, xq, z0, eps, save=True, **kwargs)
    return _launch(kernel_weights, xp, xq, z0, eps, trace=None, save=True, **kwargs)


def srnn_chain_backward(kernel_weights: Sequence[torch.Tensor], eps: torch.Tensor, saved: torch.Tensor,
                        grads: Sequence[Optional[torch.Tensor]], *, residual_posterior: bool, sd_beta: float,
                        trace: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dpre, dz0)`` as :func:`srnn_chain_backward_plain` gives them. CPU tensors: that twin;
    CUDA tensors: one launch of K9-bwd (float32; ``trace``, an int64 tensor of :func:`trace_size`
    zeros on the card, receives its time by stage and phase: the heads and z, L3, L2, L1)."""
    if not saved.is_cuda:
        return srnn_chain_backward_plain(kernel_weights, eps, saved, grads, residual_posterior=residual_posterior,
                                         sd_beta=sd_beta)
    _check_trace(trace, saved)
    B, T, Z = eps.shape
    H = kernel_weights[1].shape[0]
    kernel_weights = [w.contiguous() for w in kernel_weights]
    eps, saved = eps.contiguous(), saved.contiguous()
    grads = [None if g is None else g.contiguous() for g in grads]
    tensors = [*kernel_weights, eps, saved] + [g for g in grads if g is not None]
    if any(t.device != saved.device or t.dtype != torch.float32 for t in tensors):
        raise ValueError("srnn_chain_backward takes float32 tensors on one CUDA device")
    if (len(kernel_weights) != N_KERNEL_WEIGHTS or tuple(saved.shape) != (B, T, 6 * H + 2 * Z) or len(grads) != 5
            or any(g is not None and tuple(g.shape) != (B, T, Z) for g in grads)):
        raise ValueError(f"srnn_chain_backward: saved {tuple(saved.shape)} is not K9's save buffer for eps "
                         f"{tuple(eps.shape)} and H={H}, or the 5 output gradients do not match it")
    dpre = torch.empty((B, T, 4 * Z + 6 * H), dtype=torch.float32, device=saved.device)
    dz0 = torch.empty((B, Z), dtype=torch.float32, device=saved.device)
    barrier = torch.empty(1, dtype=torch.int32, device=saved.device)
    w_ptrs = (ctypes.c_void_p * N_KERNEL_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    g_ptrs = (ctypes.c_void_p * 5)(*(_ptr(g) for g in grads))
    lib = cuda.library()
    cuda.count_launch("srnn_chain_bwd")
    err = lib.blvm_srnn_chain_bwd(
        ctypes.addressof(w_ptrs), eps.data_ptr(), saved.data_ptr(), ctypes.addressof(g_ptrs), dpre.data_ptr(),
        dz0.data_ptr(), barrier.data_ptr(), _ptr(trace), B, T, H, Z, int(residual_posterior), sd_beta,
        cuda.stream_handle(saved),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K9-bwd (srnn_chain_bwd): the weights of H={H}, Z={Z} at B={B} do not fit the shared "
                           "memory of a grid of one CTA an SM that is all resident")
    cuda.check(err, "srnn_chain_bwd")
    return dpre, dz0


def srnn_chain(kernel_weights: Sequence[torch.Tensor], xp: torch.Tensor, xq: Optional[torch.Tensor],
               z0: torch.Tensor, eps: Optional[torch.Tensor], *, inference: bool, residual_posterior: bool,
               use_mode: bool = False, sd_beta: float, sd_epsilon: float,
               trace: Optional[torch.Tensor] = None) -> SRNNChainOutputs:
    """The chain over the ``T'`` steps of the hoisted ``xp (B, T', H)`` (and ``xq``) from
    ``z0 (B, Z)`` with the noise ``eps (B, T', Z)``: posterior samples (``inference``) or
    prior ones.

    Without a gradient: CPU tensors, :func:`srnn_chain_plain`; CUDA tensors, one launch of K9,
    all float32, on a grid of one CTA an SM; ``trace``, an int64 tensor of :func:`trace_size`
    zeros on the card, receives the kernel's time by stage and phase (:func:`read_trace`). With
    gradients enabled and an input or weight that requires one, in inference mode:
    :class:`SRNNChainFunction` (on the card K9 in save mode forward, K9-bwd backward; on the CPU
    their twins); the noise gets none. In prior mode (generation) only the CPU twin has a
    gradient, by autograd: on the card it raises ``NotImplementedError``, since no driver
    differentiates a generation.
    """
    kwargs = dict(inference=inference, residual_posterior=residual_posterior, use_mode=use_mode, sd_beta=sd_beta,
                  sd_epsilon=sd_epsilon)
    tensors = [*kernel_weights, xp, z0] + [t for t in (xq, eps) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors) and (inference or z0.is_cuda):
        if not inference:
            raise NotImplementedError("srnn_chain has a backward in inference mode only (K9-bwd); run the prior "
                                      "mode (generation) under torch.no_grad() on the card")
        if z0.is_cuda:
            _check(kernel_weights, xp, xq, z0, eps, inference, use_mode)
        outputs = SRNNChainFunction.apply(residual_posterior, sd_beta, sd_epsilon, xp, xq, z0, eps.detach(),
                                          *kernel_weights)
        return SRNNChainOutputs(*outputs)
    if not z0.is_cuda:
        return srnn_chain_plain(kernel_weights, xp, xq, z0, eps, **kwargs)
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


def _check_trace(trace, like) -> None:
    if trace is not None and (trace.dtype != torch.int64 or trace.numel() != trace_size()
                              or trace.device != like.device or not trace.is_contiguous()):
        raise ValueError(f"the trace must be a contiguous int64 tensor of {trace_size()} elements on {like.device}")


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
            trace, save=False):
    """One launch of K9 on the hoisted products: the outputs, and with ``save`` (inference mode)
    ``(outputs, saved)``, ``saved`` the ``(B, T', 6H + 2Z)`` buffer of :func:`save_fields`."""
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
    saved = torch.empty((B, T, 6 * H + 2 * Z), dtype=torch.float32, device=z0.device) if save else None
    barrier = torch.empty(1, dtype=torch.int32, device=z0.device)
    w_ptrs = (ctypes.c_void_p * N_KERNEL_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    o_ptrs = (ctypes.c_void_p * len(outputs))(*(_ptr(o) for o in outputs))
    lib = cuda.library()
    cuda.count_launch("srnn_chain")
    err = lib.blvm_srnn_chain(
        ctypes.addressof(w_ptrs), xp.data_ptr(), _ptr(xq), z0.data_ptr(), _ptr(eps), ctypes.addressof(o_ptrs),
        act.data_ptr(), _ptr(saved), barrier.data_ptr(), _ptr(trace), B, T, H, Z, int(inference),
        int(residual_posterior),
        int(use_mode), sd_beta, sd_epsilon, cuda.stream_handle(z0),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K9 (srnn_chain): the weights of H={H}, Z={Z} at B={B} do not fit the shared memory of a "
                           "grid of one CTA an SM that is all resident")
    cuda.check(err, "srnn_chain")
    return (SRNNChainOutputs(*outputs), saved) if save else SRNNChainOutputs(*outputs)
