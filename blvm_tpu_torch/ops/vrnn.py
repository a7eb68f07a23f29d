"""K8 and K8-bwd: the VRNN cell over a sequence and its backward through time (port of the
``nn.scan`` body of ``blvm_tpu/models/vrnn.py`` ``VRNNCell.__call__``, ``:77-92``, of its
prior-only ``generate_step``, ``:94-103``, and of the scan's autodiff backward).

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
and of the GRU's input product do not depend on ``h``; every version computes them for
every step at once, before the chain (:func:`hoist`), which changes the sums only by
rounding against the JAX step. The chain takes the *kernel weights*: the 28 with those two
kernels cut to their rows inside the chain.

:func:`vrnn_cell_plain` is the plain twin of K8, one step at a time, op for op the JAX
step; :func:`vrnn_cell_backward_plain` the plain twin of K8-bwd, the reverse chain one
step at a time. :func:`vrnn_cell` is the entry point: for CPU tensors the twin; for CUDA
tensors one launch of ``csrc/vrnn_cell.cu``. Where a gradient is needed (inference mode
only) it runs :class:`VRNNCellFunction`: the forward saves what the backward needs
(:func:`vrnn_cell_save`; K8's save mode on the card) and the backward is one
:func:`vrnn_cell_backward` (one launch of ``csrc/vrnn_cell_bwd.cu``, K8-bwd, on the card)
and the weight gradients as sums over the ``B T'`` rows (:func:`cell_weight_grads`).
"""

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import softplus_beta

N_WEIGHTS = 28
# the traces' layouts, stages x 4 phases (inputs in, products, finish and store, barrier): K8's 9 stages
# (csrc/vrnn_cell.cu), K8-bwd's 10 (csrc/vrnn_cell_bwd.cu: the GRU's elementwise stage, then 9 products)
TRACE_STAGES, BWD_TRACE_STAGES, TRACE_PHASES = 9, 10, 4


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


def _fields(widths) -> Dict[str, Tuple[int, int]]:
    out, offset = {}, 0
    for name, width in widths:
        out[name] = (offset, width)
        offset += width
    return out


def save_fields(R: int, H: int, Z: int) -> Dict[str, Tuple[int, int]]:
    """``name: (offset, width)`` of a row-step of the saved forward (K8's save mode): the
    prior's and posterior's L1-L3 activations, phi's L1-L3, both heads' raw sd, the GRU's
    r, u, n and ``gh_n = h W_hn + b_hn``."""
    return _fields([(n, H) for n in ("p_act0", "q_act0", "p_act1", "q_act1", "p_act2", "q_act2", "phi_act0",
                                     "phi_act1", "phi_act2")]
                   + [("raw_p", Z), ("raw_q", Z)] + [(n, R) for n in ("r", "u", "n", "gh_n")])


def grad_fields(R: int, H: int, Z: int) -> Dict[str, Tuple[int, int]]:
    """``name: (offset, width)`` of a row-step of K8-bwd's output: the pre-activation
    gradients of the GRU's input and hidden products (``gi`` is also d xg), phi's Dense_3
    to Dense_0, both heads (mu then raw sd), and the MLPs' Dense_2 to Dense_0 (``q0`` is
    also d xpost)."""
    return _fields([("gi", 3 * R), ("gh", 3 * R)] + [(f"phi{k}", H) for k in (3, 2, 1, 0)]
                   + [("head_p", 2 * Z), ("head_q", 2 * Z)] + [(f"{m}{k}", H) for k in (2, 1, 0) for m in "pq"])


def _field(buf: torch.Tensor, fields, name: str) -> torch.Tensor:
    offset, width = fields[name]
    return buf[..., offset:offset + width]


def hoist(weights, x, inference: bool, condition_h_on_x: bool):
    """``(xpost, xg, kernel_weights)``: the x parts of the posterior's first product,
    ``x W_q0[R:] (B, T', H)``, and of the GRU's input product, ``x W_ih[:X] (B, T', 3R)``,
    for all steps (None where the mode or the flags have none), and the 28 weights with
    both kernels cut to the rows that stay inside the chain."""
    w_post, w_ih, w_hh = weights[8], weights[24], weights[26]
    R, X = w_hh.shape[0], x.shape[-1]
    xpost = x @ w_post[R:] if inference else None
    xg, w_ih_phi = (x @ w_ih[:X], w_ih[X:]) if condition_h_on_x else (None, w_ih)
    return xpost, xg, (*weights[:8], w_post[:R], *weights[9:24], w_ih_phi, *weights[25:])


def _sd(raw, sd_beta: float, sd_epsilon: float):
    return softplus_beta(raw, sd_beta) + sd_epsilon


def vrnn_chain_plain(kernel_weights: Sequence[torch.Tensor], xpost: Optional[torch.Tensor],
                     xg: Optional[torch.Tensor], h0: torch.Tensor, eps: Optional[torch.Tensor], *, inference: bool,
                     residual_posterior: bool, use_mode: bool = False, sd_beta: float, sd_epsilon: float,
                     save: bool = False) -> Tuple[VRNNCellOutputs, Optional[torch.Tensor]]:
    """The chain of K8 in plain PyTorch, one step at a time, from the hoisted products:
    ``(outputs, saved)``, ``saved (B, T', *)`` laid out as :func:`save_fields` (K8's save
    mode) when ``save``, else None."""
    (pw0, pb0, pw1, pb1, pw2, pb2, pwh, pbh, qw0_h, qb0, qw1, qb1, qw2, qb2, qwh, qbh,
     fw0, fb0, fw1, fb1, fw2, fb2, fw3, fb3, w_ih_phi, b_ih, w_hh, b_hh) = kernel_weights
    Z = pwh.shape[1] // 2
    h = h0
    steps, saved = [], []
    T = (xpost if xpost is not None else xg if xg is not None else eps).shape[1]
    for t in range(T):
        p1 = torch.relu(h @ pw0 + pb0)
        p2 = torch.relu(p1 @ pw1 + pb1)
        p3 = torch.relu(p2 @ pw2 + pb2)
        head = p3 @ pwh + pbh
        prior_mu, raw_p = head[..., :Z], head[..., Z:]
        prior_sd = _sd(raw_p, sd_beta, sd_epsilon)
        enc_mu = enc_sd = q1 = q2 = q3 = raw_q = None
        if inference:
            q1 = torch.relu((h @ qw0_h + xpost[:, t]) + qb0)
            q2 = torch.relu(q1 @ qw1 + qb1)
            q3 = torch.relu(q2 @ qw2 + qb2)
            head = q3 @ qwh + qbh
            enc_mu, raw_q = head[..., :Z], head[..., Z:]
            enc_sd = _sd(raw_q, sd_beta, sd_epsilon)
            if residual_posterior:
                enc_mu = enc_mu + prior_mu
            z = enc_mu + enc_sd * eps[:, t]
        else:
            z = prior_mu if use_mode else prior_mu + prior_sd * eps[:, t]
        f1 = torch.relu(z @ fw0 + fb0)
        f2 = torch.relu(f1 @ fw1 + fb1)
        f3 = torch.relu(f2 @ fw2 + fb2)
        phi = torch.relu(f3 @ fw3 + fb3)
        gi = phi @ w_ih_phi
        if xg is not None:
            gi = gi + xg[:, t]
        i_r, i_z, i_n = (gi + b_ih).chunk(3, dim=-1)  # the GRU step, as ops/recurrent.py:gru_update
        h_r, h_z, h_n = (h @ w_hh + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        u = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - u) * n + u * h
        steps.append((h, z, phi, enc_mu, enc_sd, prior_mu, prior_sd))
        if save:
            saved.append(torch.cat([p1, q1, p2, q2, p3, q3, f1, f2, f3, raw_p, raw_q, r, u, n, h_n], dim=-1))
    outputs = VRNNCellOutputs(*(torch.stack(seq, dim=1) if seq[0] is not None else None for seq in zip(*steps)))
    return outputs, torch.stack(saved, dim=1) if save else None


def vrnn_cell_plain(weights: Sequence[torch.Tensor], x: torch.Tensor, h0: torch.Tensor, eps: Optional[torch.Tensor],
                    *, inference: bool, residual_posterior: bool, condition_h_on_x: bool, use_mode: bool = False,
                    sd_beta: float, sd_epsilon: float) -> VRNNCellOutputs:
    """The cell in plain PyTorch, one step at a time: the twin of K8. ``x (B, T', X)``,
    ``h0 (B, R)``, ``eps (B, T', Z)`` (None in prior mode under ``use_mode``)."""
    xpost, xg, kernel_weights = hoist(weights, x, inference, condition_h_on_x)
    return vrnn_chain_plain(kernel_weights, xpost, xg, h0, eps, inference=inference,
                            residual_posterior=residual_posterior, use_mode=use_mode, sd_beta=sd_beta,
                            sd_epsilon=sd_epsilon)[0]


def vrnn_cell_backward_plain(kernel_weights: Sequence[torch.Tensor], h0: torch.Tensor, eps: torch.Tensor,
                             h: torch.Tensor, phi: torch.Tensor, saved: torch.Tensor,
                             grads: Sequence[Optional[torch.Tensor]], *, residual_posterior: bool,
                             sd_beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of K8-bwd: the reverse chain in plain PyTorch, one step at a time. From the
    kernel weights, ``h0``, ``eps``, the forward's ``h`` and ``phi``, what it saved
    (:func:`save_fields`) and the gradients of its seven outputs (``h, z, phi, enc_mu, enc_sd,
    prior_mu, prior_sd``; None for zero): ``(dpre (B, T', *), dh0 (B, R))``, ``dpre`` every
    step's pre-activation gradients laid out as :func:`grad_fields`."""
    (pw0, _, pw1, _, pw2, _, pwh, _, qw0_h, _, qw1, _, qw2, _, qwh, _,
     fw0, _, fw1, _, fw2, _, fw3, _, w_ih_phi, _, w_hh, _) = kernel_weights
    B, T, R = h.shape
    sf = save_fields(R, phi.shape[-1], eps.shape[-1])
    g_h, g_z, g_phi, g_qmu, g_qsd, g_pmu, g_psd = (torch.zeros((), dtype=h.dtype, device=h.device) if g is None
                                                   else g for g in grads)

    def at(g, t):
        return g[:, t] if g.ndim else g

    def relu_grad(d, act):
        return d * (act > 0).to(d.dtype)

    dh = torch.zeros_like(h0)
    steps = []
    for t in range(T - 1, -1, -1):
        s = saved[:, t]
        r, u, n, gh_n = (_field(s, sf, k) for k in ("r", "u", "n", "gh_n"))
        h_prev = h0 if t == 0 else h[:, t - 1]
        dh = dh + at(g_h, t)
        dn = dh * (1.0 - u)
        du = dh * (h_prev - n)
        da_n = dn * (1.0 - n * n)
        da_r = da_n * gh_n * r * (1.0 - r)
        da_u = du * u * (1.0 - u)
        d_gi = torch.cat([da_r, da_u, da_n], dim=-1)
        d_gh = torch.cat([da_r, da_u, da_n * r], dim=-1)
        d_phi3 = relu_grad(d_gi @ w_ih_phi.T + at(g_phi, t), phi[:, t])
        d_phi2 = relu_grad(d_phi3 @ fw3.T, _field(s, sf, "phi_act2"))
        d_phi1 = relu_grad(d_phi2 @ fw2.T, _field(s, sf, "phi_act1"))
        d_phi0 = relu_grad(d_phi1 @ fw1.T, _field(s, sf, "phi_act0"))
        dz = d_phi0 @ fw0.T + at(g_z, t)
        dmu_q = dz + at(g_qmu, t)
        dsd_q = dz * eps[:, t] + at(g_qsd, t)
        dmu_p = at(g_pmu, t) + dmu_q if residual_posterior else at(g_pmu, t) + torch.zeros_like(dz)
        d_head_p = torch.cat([dmu_p, at(g_psd, t) * torch.sigmoid(sd_beta * _field(s, sf, "raw_p"))], dim=-1)
        d_head_q = torch.cat([dmu_q, dsd_q * torch.sigmoid(sd_beta * _field(s, sf, "raw_q"))], dim=-1)
        d_p2 = relu_grad(d_head_p @ pwh.T, _field(s, sf, "p_act2"))
        d_q2 = relu_grad(d_head_q @ qwh.T, _field(s, sf, "q_act2"))
        d_p1 = relu_grad(d_p2 @ pw2.T, _field(s, sf, "p_act1"))
        d_q1 = relu_grad(d_q2 @ qw2.T, _field(s, sf, "q_act1"))
        d_p0 = relu_grad(d_p1 @ pw1.T, _field(s, sf, "p_act0"))
        d_q0 = relu_grad(d_q1 @ qw1.T, _field(s, sf, "q_act0"))
        dh = ((dh * u + d_gh @ w_hh.T) + d_p0 @ pw0.T) + d_q0 @ qw0_h.T
        steps.append(torch.cat([d_gi, d_gh, d_phi3, d_phi2, d_phi1, d_phi0, d_head_p, d_head_q, d_p2, d_q2, d_p1,
                                d_q1, d_p0, d_q0], dim=-1))
    return torch.stack(steps[::-1], dim=1), dh


def cell_weight_grads(kernel_weights: Sequence[torch.Tensor], h0: torch.Tensor, h: torch.Tensor, z: torch.Tensor,
                      phi: torch.Tensor, saved: torch.Tensor, dpre: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients of the 28 kernel weights: each kernel's is (its layer's saved input)^T
    (its pre-activation gradient), a sum over the ``B T'`` rows, one GEMM (cuBLAS on the
    card); every bias's is that gradient's column sum, all 14 in one product with a row of
    ones (a column ``sum`` is ~10x slower on the card)."""
    B, T, R = h.shape
    H, Z = phi.shape[-1], z.shape[-1]
    sf, gf = save_fields(R, H, Z), grad_fields(R, H, Z)
    rows = B * T
    sv, dp = saved.reshape(rows, -1), dpre.reshape(rows, -1)
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1).reshape(rows, R)
    inputs = dict(p0=h_prev, p1=_field(sv, sf, "p_act0"), p2=_field(sv, sf, "p_act1"), head_p=_field(sv, sf, "p_act2"),
                  q0=h_prev, q1=_field(sv, sf, "q_act0"), q2=_field(sv, sf, "q_act1"), head_q=_field(sv, sf, "q_act2"),
                  phi0=z.reshape(rows, Z), phi1=_field(sv, sf, "phi_act0"), phi2=_field(sv, sf, "phi_act1"),
                  phi3=_field(sv, sf, "phi_act2"), gi=phi.reshape(rows, H), gh=h_prev)
    order = ("p0", "p1", "p2", "head_p", "q0", "q1", "q2", "head_q", "phi0", "phi1", "phi2", "phi3", "gi", "gh")
    bias = torch.ones((1, rows), dtype=dpre.dtype, device=dpre.device) @ dp
    grads = []
    for name, w in zip(order, kernel_weights[0::2]):
        grads.append((inputs[name].t() @ _field(dp, gf, name)).reshape(w.shape))
        grads.append(_field(bias[0], gf, name).clone())
    return tuple(grads)


class VRNNCellFunction(torch.autograd.Function):
    """The cell in inference mode as one differentiable op over the hoisted products:
    ``apply(residual_posterior, sd_beta, sd_epsilon, xpost, xg, h0, eps, *kernel_weights)``
    -> the seven outputs of :class:`VRNNCellOutputs`. The forward saves what the backward
    needs (:func:`vrnn_cell_save`); the backward runs :func:`vrnn_cell_backward` once and
    :func:`cell_weight_grads`, and returns the gradients of ``xpost``, ``xg``, ``h0`` and the
    kernel weights (none for the noise ``eps``)."""

    @staticmethod
    def forward(ctx, residual_posterior, sd_beta, sd_epsilon, xpost, xg, h0, eps, *kernel_weights):
        outputs, saved = vrnn_cell_save(kernel_weights, xpost, xg, h0, eps, residual_posterior=residual_posterior,
                                        sd_beta=sd_beta, sd_epsilon=sd_epsilon)
        ctx.residual_posterior, ctx.sd_beta, ctx.has_xg = residual_posterior, sd_beta, xg is not None
        ctx.save_for_backward(h0, eps, outputs.h, outputs.z, outputs.phi_z, saved, *kernel_weights)
        return tuple(outputs)

    @staticmethod
    def backward(ctx, *grads):
        h0, eps, h, z, phi, saved, *kernel_weights = ctx.saved_tensors
        dpre, dh0 = vrnn_cell_backward(kernel_weights, h0, eps, h, phi, saved,
                                       [None if g is None else g.contiguous() for g in grads],
                                       residual_posterior=ctx.residual_posterior, sd_beta=ctx.sd_beta)
        gf = grad_fields(h.shape[-1], phi.shape[-1], z.shape[-1])
        d_xg = _field(dpre, gf, "gi") if ctx.has_xg else None
        weight_grads = cell_weight_grads(kernel_weights, h0, h, z, phi, saved, dpre)
        return (None, None, None, _field(dpre, gf, "q0"), d_xg, dh0, None, *weight_grads)


def vrnn_cell(weights: Sequence[torch.Tensor], x: torch.Tensor, h0: torch.Tensor, eps: Optional[torch.Tensor], *,
              inference: bool, residual_posterior: bool, condition_h_on_x: bool, use_mode: bool = False,
              sd_beta: float, sd_epsilon: float, trace: Optional[torch.Tensor] = None) -> VRNNCellOutputs:
    """The cell over the ``T'`` steps of ``x (B, T', X)`` from ``h0 (B, R)`` with the noise
    ``eps (B, T', Z)``: posterior samples (``inference``) or prior ones.

    Without a gradient: CPU tensors, :func:`vrnn_cell_plain`; CUDA tensors, the hoisted
    products (cuBLAS) and one launch of K8, all float32, on a grid of one CTA an SM.
    ``trace``, an int64 tensor of :func:`trace_size` zeros on the card, receives the kernel's
    time by stage and phase (:func:`read_trace`). With gradients enabled and an input or
    weight that requires one: the hoisted products, then :class:`VRNNCellFunction` (on the
    card K8 in save mode forward, K8-bwd backward; on the CPU their twins). Only the
    inference mode has a backward (a generation runs without gradients); the noise gets none.
    """
    kwargs = dict(inference=inference, residual_posterior=residual_posterior, condition_h_on_x=condition_h_on_x,
                  use_mode=use_mode, sd_beta=sd_beta, sd_epsilon=sd_epsilon)
    tensors = [*weights, x, h0] + ([eps] if eps is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if not inference:
            raise NotImplementedError("the VRNN cell has a backward in inference mode only (K8-bwd); run the "
                                      "prior mode (generation) under torch.no_grad()")
        if h0.is_cuda:
            _check(weights, x, h0, eps, inference, use_mode)
        xpost, xg, kernel_weights = hoist(weights, x, inference, condition_h_on_x)
        outputs = VRNNCellFunction.apply(residual_posterior, sd_beta, sd_epsilon, xpost, xg, h0,
                                         None if eps is None else eps.detach(), *kernel_weights)
        return VRNNCellOutputs(*outputs)
    if not h0.is_cuda:
        return vrnn_cell_plain(weights, x, h0, eps, **kwargs)
    _check(weights, x, h0, eps, inference, use_mode)
    _check_trace(trace, h0, trace_size())
    xpost, xg, kernel_weights = hoist(weights, x.contiguous(), inference, condition_h_on_x)
    return _launch(kernel_weights, xpost, xg, h0, eps, inference=inference, residual_posterior=residual_posterior,
                   use_mode=use_mode, sd_beta=sd_beta, sd_epsilon=sd_epsilon, trace=trace)[0]


def vrnn_cell_save(kernel_weights: Sequence[torch.Tensor], xpost: torch.Tensor, xg: Optional[torch.Tensor],
                   h0: torch.Tensor, eps: torch.Tensor, *, residual_posterior: bool, sd_beta: float,
                   sd_epsilon: float) -> Tuple[VRNNCellOutputs, torch.Tensor]:
    """The forward of :class:`VRNNCellFunction` (inference mode) from the hoisted products:
    ``(outputs, saved)``. CPU tensors: :func:`vrnn_chain_plain` with ``save``; CUDA tensors:
    one launch of K8 in save mode."""
    kwargs = dict(residual_posterior=residual_posterior, sd_beta=sd_beta, sd_epsilon=sd_epsilon)
    if not h0.is_cuda:
        return vrnn_chain_plain(kernel_weights, xpost, xg, h0, eps, inference=True, save=True, **kwargs)
    return _launch(kernel_weights, xpost, xg, h0, eps, inference=True, use_mode=False, trace=None, save=True,
                   **kwargs)


def vrnn_cell_backward(kernel_weights: Sequence[torch.Tensor], h0: torch.Tensor, eps: torch.Tensor, h: torch.Tensor,
                       phi: torch.Tensor, saved: torch.Tensor, grads: Sequence[Optional[torch.Tensor]], *,
                       residual_posterior: bool, sd_beta: float,
                       trace: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dpre, dh0)`` as :func:`vrnn_cell_backward_plain` gives them. CPU tensors: that twin;
    CUDA tensors: one launch of K8-bwd (float32, contiguous; ``trace``, an int64 tensor of
    :func:`bwd_trace_size` zeros on the card, receives its time by stage and phase)."""
    if not h0.is_cuda:
        return vrnn_cell_backward_plain(kernel_weights, h0, eps, h, phi, saved, grads,
                                        residual_posterior=residual_posterior, sd_beta=sd_beta)
    _check_trace(trace, h0, bwd_trace_size())
    B, T, R = h.shape
    H, Z = phi.shape[-1], eps.shape[-1]
    kernel_weights = [w.contiguous() for w in kernel_weights]
    tensors = [*kernel_weights, h0, eps, h, phi, saved] + [g for g in grads if g is not None]
    if any(t.device != h0.device or t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError("vrnn_cell_backward takes contiguous float32 tensors on one CUDA device")
    if tuple(saved.shape) != (B, T, sum(w for _, w in save_fields(R, H, Z).values())) or len(grads) != 7:
        raise ValueError(f"vrnn_cell_backward: saved {tuple(saved.shape)} is not K8's save buffer for h "
                         f"{tuple(h.shape)}, or {len(grads)} output gradients where 7 are taken")
    dpre = torch.empty((B, T, sum(w for _, w in grad_fields(R, H, Z).values())), dtype=torch.float32,
                       device=h0.device)
    dh0 = torch.empty((B, R), dtype=torch.float32, device=h0.device)
    barrier = torch.empty(1, dtype=torch.int32, device=h0.device)
    w_ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    g_ptrs = (ctypes.c_void_p * 7)(*(_ptr(g) for g in grads))
    lib = cuda.library()
    cuda.count_launch("vrnn_cell_bwd")
    err = lib.blvm_vrnn_cell_bwd(
        ctypes.addressof(w_ptrs), h0.data_ptr(), eps.data_ptr(), h.data_ptr(), phi.data_ptr(), saved.data_ptr(),
        ctypes.addressof(g_ptrs), dpre.data_ptr(), dh0.data_ptr(), barrier.data_ptr(), _ptr(trace), B, T, R, H, Z,
        int(residual_posterior), sd_beta, cuda.stream_handle(h0),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K8-bwd (vrnn_cell_bwd): the weights of R={R}, H={H}, Z={Z} at B={B} do not fit the "
                           "shared memory of a grid of one CTA an SM that is all resident")
    cuda.check(err, "vrnn_cell_bwd")
    return dpre, dh0


def trace_size() -> int:
    return TRACE_STAGES * TRACE_PHASES + 2


def bwd_trace_size() -> int:
    return BWD_TRACE_STAGES * TRACE_PHASES + 2


def read_trace(trace: torch.Tensor) -> torch.Tensor:
    """``(stages, 4)`` nanoseconds, summed over the launches that filled ``trace`` (K8's 9
    stages or K8-bwd's 10): each stage's inputs in, products, finish and store, and barrier,
    as the first CTA saw them (its SM cycles, converted at the rate its clock ran over the
    whole loop)."""
    t = trace.detach().cpu().double()
    cycles, total_cycles, total_ns = t[:-2], t[-2], t[-1]
    return (cycles * (total_ns / total_cycles)).reshape(-1, TRACE_PHASES)


def _check_trace(trace, h0, size) -> None:
    if trace is not None and (trace.dtype != torch.int64 or trace.numel() != size or trace.device != h0.device
                              or not trace.is_contiguous()):
        raise ValueError(f"the trace must be a contiguous int64 tensor of {size} elements on {h0.device}")


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


def _launch(kernel_weights, xpost, xg, h0, eps, *, inference, residual_posterior, use_mode, sd_beta, sd_epsilon,
            trace, save=False):
    """One launch of K8 on the hoisted products: ``(VRNNCellOutputs, saved)``, ``saved`` the
    ``(B, T', *)`` buffer of :func:`save_fields` with ``save``, else None."""
    kernel_weights = [w.contiguous() for w in kernel_weights]
    h0 = h0.contiguous()
    eps = eps.contiguous() if eps is not None and (inference or not use_mode) else None
    xpost = xpost.contiguous() if xpost is not None else None
    xg = xg.contiguous() if xg is not None else None
    B, T = (xpost if xpost is not None else xg if xg is not None else eps).shape[:2]
    R, H, Z = h0.shape[1], kernel_weights[0].shape[1], kernel_weights[6].shape[1] // 2
    dev = h0.device

    def out(width):
        return torch.empty((B, T, width), dtype=torch.float32, device=dev)

    outputs = [out(R), out(Z), out(H), out(Z) if inference else None, out(Z) if inference else None, out(Z), out(Z)]
    act = (out(sum(w for _, w in save_fields(R, H, Z).values())) if save
           else torch.empty(9 * B * H, dtype=torch.float32, device=dev))
    barrier = torch.empty(1, dtype=torch.int32, device=dev)
    w_ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    o_ptrs = (ctypes.c_void_p * len(outputs))(*(_ptr(o) for o in outputs))
    lib = cuda.library()
    cuda.count_launch("vrnn_cell")
    err = lib.blvm_vrnn_cell(
        ctypes.addressof(w_ptrs), h0.data_ptr(), _ptr(xpost), _ptr(xg), _ptr(eps), ctypes.addressof(o_ptrs),
        act.data_ptr(), barrier.data_ptr(), _ptr(trace), B, T, R, H, Z, int(inference), int(residual_posterior),
        int(use_mode), int(save), sd_beta, sd_epsilon, cuda.stream_handle(h0),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K8 (vrnn_cell): the weights of R={R}, H={H}, Z={Z} at B={B} do not fit the shared "
                           "memory of a grid of one CTA an SM that is all resident")
    cuda.check(err, "vrnn_cell")
    return VRNNCellOutputs(*outputs), act if save else None
