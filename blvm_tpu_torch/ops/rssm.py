"""K10: a CW-VAE level's RSSM cell chain over a sequence (port of the ``nn.scan`` of ``blvm_tpu/modules/rssm.py``
``RSSMCell.__call__``, ``:46-62``, in ``CWVAE._run_level``, and of ``RSSMCell.generate``, ``:64-71``, in
``CWVAE.generate``), and K10-bwd, its backward through time.

Per step, from the carry ``(z_{t-1}, h_{t-1})`` (zeros at a reset): ``a = relu([z, context] Wg + bg)``, the GRU step
``h_t = GRUCell(a, h_{t-1})``, the prior's 3-layer ReLU MLP on ``h_t`` and its Gaussian head, the posterior's on
``[h_t, enc_t]`` (its mean plus the prior's under ``residual_posterior``, or the two precision-weighted under
``precision_posterior``), and ``z_t = mu + sd * eps_t``. In *prior* mode (generation) the posterior is skipped and
``z`` is the prior's sample, or its mean under ``use_mode``. Every head's ``sd = softplus(beta raw) / beta + eps``.

``weights`` is the 22-tuple of :meth:`blvm_tpu_torch.modules.rssm.RSSMCell.chain_weights` in the flax ``(in, out)``
layout. The context columns of ``gru_in`` and the enc columns of the posterior's first layer, with their biases,
do not depend on the carry: every version computes them for every step at once before the chain (:func:`hoist`),
which changes the sums only by rounding against the JAX step. The chain takes the 20 *kernel weights*.

:func:`rssm_chain_plain` is the plain twin of K10, one step at a time, op for op the JAX step after the hoist;
:func:`rssm_chain_backward_plain` the twin of K10-bwd, the reverse chain one step at a time. :func:`rssm_chain` is
the entry point: for CPU tensors the twin, for CUDA tensors one launch of ``csrc/rssm_cell.cu``, float32. Where a
gradient is needed in inference mode it runs :class:`RSSMChainFunction`: the forward saves what the backward needs
(:func:`rssm_chain_save`; K10's save mode on the card), the backward is one :func:`rssm_chain_backward` (K10-bwd,
``csrc/rssm_cell_bwd.cu``, on the card) and the kernel weights' gradients as sums over the ``B T'`` rows
(:func:`chain_weight_grads`). The hoisted products stay plain PyTorch, so autograd carries the gradients of ``xg``
and ``xq`` on into the context, the encodings and the hoisted weights. A prior-mode call under a gradient has
autograd's gradient of the twin on the CPU and raises on the card: no driver differentiates a generation.
"""

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import softplus_beta
from blvm_tpu_torch.ops.recurrent import gru_gates
from blvm_tpu_torch.ops.variational import precision_weighted_gaussian
from blvm_tpu_torch.ops.vrnn import _field, _fields  # K8's (offset, width) layouts of a row-step

N_KERNEL_WEIGHTS = 20
MAX_UNITS = 512  # csrc/rssm_cell.cu stages 8 rows of max(H, Z) floats in at most 16 loads a thread of 256


class RSSMChainOutputs(NamedTuple):
    """``z``, ``enc_mu``, ``enc_sd``, ``prior_mu``, ``prior_sd`` each ``(B, T', Z)`` and ``h (B, T', H)``;
    ``enc_mu`` (after the posterior's combination with the prior) and ``enc_sd`` are None in prior mode."""

    z: torch.Tensor
    h: torch.Tensor
    enc_mu: Optional[torch.Tensor]
    enc_sd: Optional[torch.Tensor]
    prior_mu: torch.Tensor
    prior_sd: torch.Tensor


def hoist(weights: Sequence[torch.Tensor], enc: Optional[torch.Tensor], context: torch.Tensor, inference: bool):
    """``(xg, xq, kernel_weights)``: ``xg = context Wg[Z:] + bg (B, T', H)`` (the bias alone where the context has
    no columns), ``xq = enc Wq0[H:] + bq0`` (None in prior mode), and the 20 weights the chain keeps (gru_in's z
    rows, the posterior's first kernel's h rows, neither bias)."""
    wg, bg, *gru, p0, pb0, p1, pb1, p2, pb2, ph, pbh, q0, qb0, q1, qb1, q2, qb2, qh, qbh = weights
    Z, H = ph.shape[1] // 2, p0.shape[0]
    xg = context @ wg[Z:] + bg
    xq = enc @ q0[H:] + qb0 if inference else None
    return xg, xq, (wg[:Z], *gru, p0, pb0, p1, pb1, p2, pb2, ph, pbh, q0[:H], q1, qb1, q2, qb2, qh, qbh)


def save_fields(H: int, Z: int) -> Dict[str, Tuple[int, int]]:
    """``name: (offset, width)`` of a row-step of the saved forward (K10's save mode, ``csrc/rssm_cell.cu``
    ``SAVE_*``): ``a`` (post-ReLU), the GRU's gates ``r``, ``u``, ``n`` and ``ghn = h W_hn + b_hn``, the six MLP
    layers' post-ReLU values, and both heads' pre-activations (the posterior's mean before the combination)."""
    return _fields([(n, H) for n in ("a", "r", "u", "n", "ghn", "p1", "q1", "p2", "q2", "p3", "q3")]
                   + [(n, Z) for n in ("mu_p", "raw_p", "mu_q", "raw_q")])


def grad_fields(H: int, Z: int) -> Dict[str, Tuple[int, int]]:
    """``name: (offset, width)`` of a row-step of K10-bwd's output: both heads' pre-activation gradients (mu then
    raw sd), the MLPs' L3 to L1 (``q1`` is also d xq), the GRU's ``gi`` and ``gh`` (its n part times r) and ``a``'s
    pre-activation (also d xg)."""
    return _fields([("head_p", 2 * Z), ("head_q", 2 * Z)] + [(f"{m}{k}", H) for k in (3, 2, 1) for m in "pq"]
                   + [("gi", 3 * H), ("gh", 3 * H), ("a", H)])


def _sd(raw, sd_beta: float, sd_epsilon: float):
    return softplus_beta(raw, sd_beta) + sd_epsilon


def _is_reset(resets: Optional[torch.Tensor], t: int) -> bool:
    return resets is not None and 0 <= t < resets.shape[0] and bool(resets[t])


def rssm_chain_plain(kernel_weights: Sequence[torch.Tensor], xg: torch.Tensor, xq: Optional[torch.Tensor],
                     z0: torch.Tensor, h0: torch.Tensor, eps: Optional[torch.Tensor],
                     resets: Optional[torch.Tensor] = None, *, inference: bool, residual_posterior: bool,
                     precision_posterior: bool, use_mode: bool = False, sd_beta: float,
                     sd_epsilon: float) -> RSSMChainOutputs:
    """The chain of K10 in plain PyTorch, one step at a time, from the hoisted ``xg``, ``xq (B, T', H)`` (``xq``
    None in prior mode), ``z0 (B, Z)``, ``h0 (B, H)``, ``eps (B, T', Z)`` (None in prior mode under ``use_mode``)
    and ``resets`` (None, or ``(T',)`` bools: the step starts from zeros)."""
    return _chain_plain(kernel_weights, xg, xq, z0, h0, eps, resets, inference=inference,
                        residual_posterior=residual_posterior, precision_posterior=precision_posterior,
                        use_mode=use_mode, sd_beta=sd_beta, sd_epsilon=sd_epsilon, save=False)[0]


def _chain_plain(kernel_weights, xg, xq, z0, h0, eps, resets, *, inference, residual_posterior, precision_posterior,
                 use_mode, sd_beta, sd_epsilon, save: bool) -> Tuple[RSSMChainOutputs, Optional[torch.Tensor]]:
    """:func:`rssm_chain_plain` and, with ``save`` (inference mode), K10's save buffer ``(B, T', 11H + 4Z)`` laid
    out as :func:`save_fields`, else None."""
    wg_z, w_ih, b_ih, w_hh, b_hh, p0, pb0, p1, pb1, p2, pb2, ph, pbh, q0_h, q1, qb1, q2, qb2, qh, qbh = kernel_weights
    Z = ph.shape[1] // 2
    z, h = z0, h0
    steps, saved = [], []
    for t in range(xg.shape[1]):
        if _is_reset(resets, t):
            z, h = torch.zeros_like(z), torch.zeros_like(h)
        a = torch.relu(z @ wg_z + xg[:, t])
        r, u, n, ghn = gru_gates(a @ w_ih + b_ih, h @ w_hh + b_hh)
        h = (1.0 - u) * n + u * h
        l1 = torch.relu(h @ p0 + pb0)
        l2 = torch.relu(l1 @ p1 + pb1)
        l3 = torch.relu(l2 @ p2 + pb2)
        head_p = l3 @ ph + pbh
        prior_mu, prior_sd = head_p[..., :Z], _sd(head_p[..., Z:], sd_beta, sd_epsilon)
        enc_mu = enc_sd = None
        if inference:
            m1 = torch.relu(h @ q0_h + xq[:, t])
            m2 = torch.relu(m1 @ q1 + qb1)
            m3 = torch.relu(m2 @ q2 + qb2)
            head_q = m3 @ qh + qbh
            enc_mu, enc_sd = head_q[..., :Z], _sd(head_q[..., Z:], sd_beta, sd_epsilon)
            if residual_posterior:
                enc_mu = enc_mu + prior_mu
            elif precision_posterior:
                enc_mu, enc_sd = precision_weighted_gaussian(enc_mu, enc_sd, prior_mu, prior_sd)
            z = enc_mu + enc_sd * eps[:, t]
            if save:
                saved.append(torch.cat([a, r, u, n, ghn, l1, m1, l2, m2, l3, m3, head_p, head_q], dim=-1))
        else:
            z = prior_mu if use_mode else prior_mu + prior_sd * eps[:, t]
        steps.append((z, h, enc_mu, enc_sd, prior_mu, prior_sd))
    outputs = RSSMChainOutputs(*(torch.stack(seq, dim=1) if seq[0] is not None else None for seq in zip(*steps)))
    return outputs, torch.stack(saved, dim=1) if save else None


def _previous(seq: torch.Tensor, first: torch.Tensor, resets: Optional[torch.Tensor]) -> torch.Tensor:
    """``(B, T', W)``: the carry entering each step, ``first`` then ``seq`` shifted by one, zeros at reset steps."""
    prev = torch.cat([first[:, None], seq[:, :-1]], dim=1)
    if resets is not None:
        prev = prev * (~resets.bool()).to(prev.dtype)[None, :, None]
    return prev


def rssm_chain_backward_plain(kernel_weights: Sequence[torch.Tensor], eps: torch.Tensor, saved: torch.Tensor,
                              h: torch.Tensor, h0: torch.Tensor, resets: Optional[torch.Tensor],
                              grads: Sequence[Optional[torch.Tensor]], *, residual_posterior: bool,
                              precision_posterior: bool, sd_beta: float,
                              sd_epsilon: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The twin of K10-bwd: the reverse chain in plain PyTorch, one step at a time, each stage's backward as JAX's
    autodiff of the step differentiates it (ReLU's gradient 0 at 0, softplus's 0.5 there). From the kernel weights,
    the noise, what the forward saved (:func:`save_fields`), its ``h``, ``h0``, the reset mask and the gradients of
    its six outputs (``z, h, enc_mu, enc_sd, prior_mu, prior_sd``; None for zero): ``(dpre (B, T', 13H + 4Z), dz0
    (B, Z), dh0 (B, H))``, ``dpre`` every step's pre-activation gradients laid out as :func:`grad_fields`."""
    wg_z, w_ih, _, w_hh, _, p0, _, p1, _, p2, _, ph, _, q0_h, q1, _, q2, _, qh, _ = kernel_weights
    B, T, Z = eps.shape
    H = h.shape[-1]
    sf = save_fields(H, Z)
    zero = torch.zeros((), dtype=saved.dtype, device=saved.device)
    g_z, g_h, g_qmu, g_qsd, g_pmu, g_psd = (zero if g is None else g for g in grads)
    h_prev = _previous(h, h0, resets)

    def at(g, t):
        return g[:, t] if g.ndim else g

    def relu_grad(d, act):  # jax.nn.relu's gradient: 0 where the pre-activation is <= 0
        return torch.where(act > 0, d, torch.zeros_like(d))

    dh_carry = torch.zeros((B, H), dtype=saved.dtype, device=saved.device)
    d_a_next = None
    steps = []
    for t in range(T - 1, -1, -1):
        f = functools.partial(_field, saved[:, t], sf)  # f(name): this step's saved field
        dz = at(g_z, t) + torch.zeros((B, Z), dtype=saved.dtype, device=saved.device)
        if d_a_next is not None and not _is_reset(resets, t + 1):
            dz = dz + d_a_next @ wg_z.T
        dmu_q, dsd_q = dz + at(g_qmu, t), dz * eps[:, t] + at(g_qsd, t)
        dmu_p, dsd_p = at(g_pmu, t) + torch.zeros_like(dz), at(g_psd, t) + torch.zeros_like(dz)
        dmu_q0, dsd_q0 = dmu_q, dsd_q
        if residual_posterior:
            dmu_p = dmu_p + dmu_q
        elif precision_posterior:  # the backward of precision_weighted_gaussian, op by op
            mu_q0, mu_p = f("mu_q"), f("mu_p")
            sd_q0, sd_p = _sd(f("raw_q"), sd_beta, sd_epsilon), _sd(f("raw_p"), sd_beta, sd_epsilon)
            pr_q, pr_p = 1.0 / (sd_q0 * sd_q0), 1.0 / (sd_p * sd_p)
            va = 1.0 / (pr_q + pr_p)
            dnum = dmu_q * va
            dva = dmu_q * (mu_q0 * pr_q + mu_p * pr_p) + dsd_q * 0.5 / torch.sqrt(va)
            dsum = -dva * va * va
            dpr_q, dpr_p = dnum * mu_q0 + dsum, dnum * mu_p + dsum
            dmu_q0, dmu_p = dnum * pr_q, dmu_p + dnum * pr_p
            dsd_q0, dsd_p = -2.0 * dpr_q * pr_q / sd_q0, dsd_p - 2.0 * dpr_p * pr_p / sd_p
        d_head_p = torch.cat([dmu_p, dsd_p * torch.sigmoid(sd_beta * f("raw_p"))], dim=-1)
        d_head_q = torch.cat([dmu_q0, dsd_q0 * torch.sigmoid(sd_beta * f("raw_q"))], dim=-1)
        d_p3, d_q3 = relu_grad(d_head_p @ ph.T, f("p3")), relu_grad(d_head_q @ qh.T, f("q3"))
        d_p2, d_q2 = relu_grad(d_p3 @ p2.T, f("p2")), relu_grad(d_q3 @ q2.T, f("q2"))
        d_p1, d_q1 = relu_grad(d_p2 @ p1.T, f("p1")), relu_grad(d_q2 @ q1.T, f("q1"))
        dh = d_p1 @ p0.T + d_q1 @ q0_h.T + at(g_h, t) + dh_carry
        r, u, n, ghn = f("r"), f("u"), f("n"), f("ghn")
        dn, du = dh * (1.0 - u), dh * (h_prev[:, t] - n)
        dan = dn * (1.0 - n * n)
        dar, dau = dan * ghn * r * (1.0 - r), du * u * (1.0 - u)
        d_gi, d_gh = torch.cat([dar, dau, dan], dim=-1), torch.cat([dar, dau, dan * r], dim=-1)
        d_a = relu_grad(d_gi @ w_ih.T, f("a"))
        dh_carry = torch.zeros_like(dh) if _is_reset(resets, t) else dh * u + d_gh @ w_hh.T
        d_a_next = d_a
        steps.append(torch.cat([d_head_p, d_head_q, d_p3, d_q3, d_p2, d_q2, d_p1, d_q1, d_gi, d_gh, d_a], dim=-1))
    dz0 = torch.zeros((B, Z), dtype=saved.dtype, device=saved.device) if _is_reset(resets, 0) else d_a_next @ wg_z.T
    return torch.stack(steps[::-1], dim=1), dz0, dh_carry


def chain_weight_grads(kernel_weights: Sequence[torch.Tensor], z0: torch.Tensor, h0: torch.Tensor, z: torch.Tensor,
                       h: torch.Tensor, resets: Optional[torch.Tensor], saved: torch.Tensor,
                       dpre: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients of the 20 kernel weights: each kernel's is (its layer's input)^T (its pre-activation gradient),
    a sum over the ``B T'`` rows, one GEMM (cuBLAS on the card): gru_in's z rows take ``z_{t-1}``, ``w_hh`` takes
    ``h_{t-1}`` (each the carry entering the step, zeros at a reset), ``w_ih`` the saved ``a``, both first layers'
    h rows ``h_t``, the others the saved activation below; every bias's is that gradient's column sum, all in one
    product with a row of ones."""
    B, T, Z = z.shape
    H = h.shape[-1]
    sf, gf = save_fields(H, Z), grad_fields(H, Z)
    rows = B * T
    dp = dpre.reshape(rows, -1)
    sv = saved.reshape(rows, -1)
    bias = (torch.ones((1, rows), dtype=dpre.dtype, device=dpre.device) @ dp)[0]
    z_prev = _previous(z, z0, resets).reshape(rows, Z)
    h_prev = _previous(h, h0, resets).reshape(rows, H)
    h_t = h.reshape(rows, H)

    def gemm(inputs, name):
        return inputs.t() @ _field(dp, gf, name)

    def bias_of(name):
        return _field(bias, gf, name).clone()

    grads = [gemm(z_prev, "a"), gemm(_field(sv, sf, "a"), "gi"), bias_of("gi"), gemm(h_prev, "gh"), bias_of("gh")]
    for m in "pq":
        grads.append(gemm(h_t, f"{m}1"))
        if m == "p":
            grads.append(bias_of("p1"))
        for below, name in ((f"{m}1", f"{m}2"), (f"{m}2", f"{m}3"), (f"{m}3", f"head_{m}")):
            grads.append(gemm(_field(sv, sf, below), name))
            grads.append(bias_of(name))
    return tuple(grads)


class RSSMChainFunction(torch.autograd.Function):
    """The chain in inference mode as one differentiable op over the hoisted products:
    ``apply(residual_posterior, precision_posterior, sd_beta, sd_epsilon, resets, xg, xq, z0, h0, eps,
    *kernel_weights)`` -> the six outputs of :class:`RSSMChainOutputs`. The forward saves what the backward needs
    (:func:`rssm_chain_save`); the backward runs :func:`rssm_chain_backward` once and :func:`chain_weight_grads`,
    and returns the gradients of ``xg``, ``xq``, ``z0``, ``h0`` and the kernel weights (none for the noise and the
    reset mask). An output gradient autograd has none for arrives as None and is read as zero."""

    @staticmethod
    def forward(ctx, residual_posterior, precision_posterior, sd_beta, sd_epsilon, resets, xg, xq, z0, h0, eps,
                *kernel_weights):
        kw = dict(residual_posterior=residual_posterior, precision_posterior=precision_posterior, sd_beta=sd_beta,
                  sd_epsilon=sd_epsilon)
        outputs, saved = rssm_chain_save(kernel_weights, xg, xq, z0, h0, eps, resets, **kw)
        ctx.set_materialize_grads(False)
        ctx.kw, ctx.resets = kw, resets
        ctx.save_for_backward(z0, h0, eps, outputs.z, outputs.h, saved, *kernel_weights)
        return tuple(outputs)

    @staticmethod
    def backward(ctx, *grads):
        z0, h0, eps, z, h, saved, *kernel_weights = ctx.saved_tensors
        dpre, dz0, dh0 = rssm_chain_backward(kernel_weights, eps, saved, h, h0, ctx.resets, grads, **ctx.kw)
        gf = grad_fields(h.shape[-1], z.shape[-1])
        weight_grads = chain_weight_grads(kernel_weights, z0, h0, z, h, ctx.resets, saved, dpre)
        return (None,) * 5 + (_field(dpre, gf, "a"), _field(dpre, gf, "q1"), dz0, dh0, None, *weight_grads)


def rssm_chain_save(kernel_weights: Sequence[torch.Tensor], xg: torch.Tensor, xq: torch.Tensor, z0: torch.Tensor,
                    h0: torch.Tensor, eps: torch.Tensor, resets: Optional[torch.Tensor] = None, *,
                    residual_posterior: bool, precision_posterior: bool, sd_beta: float,
                    sd_epsilon: float) -> Tuple[RSSMChainOutputs, torch.Tensor]:
    """The forward of :class:`RSSMChainFunction` (inference mode) from the hoisted products: ``(outputs, saved)``.
    CPU tensors: the twin with ``save``; CUDA tensors: one launch of K10 in save mode (its outputs the same bits as
    without)."""
    kw = dict(inference=True, residual_posterior=residual_posterior, precision_posterior=precision_posterior,
              use_mode=False, sd_beta=sd_beta, sd_epsilon=sd_epsilon)
    if not z0.is_cuda:
        return _chain_plain(kernel_weights, xg, xq, z0, h0, eps, resets, save=True, **kw)
    return _launch(kernel_weights, xg, xq, z0, h0, eps, resets, save=True, **kw)


def rssm_chain_backward(kernel_weights: Sequence[torch.Tensor], eps: torch.Tensor, saved: torch.Tensor,
                        h: torch.Tensor, h0: torch.Tensor, resets: Optional[torch.Tensor],
                        grads: Sequence[Optional[torch.Tensor]], *, residual_posterior: bool,
                        precision_posterior: bool, sd_beta: float,
                        sd_epsilon: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dpre, dz0, dh0)`` as :func:`rssm_chain_backward_plain` gives them. CPU tensors: that twin; CUDA tensors:
    one launch of K10-bwd, float32; a refused dtype or shape raises."""
    kw = dict(residual_posterior=residual_posterior, precision_posterior=precision_posterior, sd_beta=sd_beta,
              sd_epsilon=sd_epsilon)
    if not saved.is_cuda:
        return rssm_chain_backward_plain(kernel_weights, eps, saved, h, h0, resets, grads, **kw)
    B, T, Z = eps.shape
    H = h.shape[-1]
    kernel_weights = [w.contiguous() for w in kernel_weights]
    eps, saved, h, h0 = eps.contiguous(), saved.contiguous(), h.contiguous(), h0.contiguous()
    grads = [None if g is None else g.contiguous() for g in grads]
    tensors = [*kernel_weights, eps, saved, h, h0] + [g for g in grads if g is not None]
    if any(t.device != saved.device or t.dtype != torch.float32 for t in tensors):
        raise ValueError("rssm_chain_backward takes float32 tensors on one CUDA device")
    widths = (Z, H, Z, Z, Z, Z)
    if (len(kernel_weights) != N_KERNEL_WEIGHTS or tuple(saved.shape) != (B, T, 11 * H + 4 * Z)
            or tuple(h.shape) != (B, T, H) or tuple(h0.shape) != (B, H) or len(grads) != 6
            or any(g is not None and tuple(g.shape) != (B, T, w) for g, w in zip(grads, widths))
            or (resets is not None and tuple(resets.shape) != (T,))):
        raise ValueError(f"rssm_chain_backward: saved {tuple(saved.shape)} is not K10's save buffer for eps "
                         f"{tuple(eps.shape)} and h {tuple(h.shape)}, or the 6 output gradients, h0 or the resets do "
                         "not match it")
    resets = resets.to(device=saved.device, dtype=torch.int32).contiguous() if resets is not None else None
    dpre = torch.empty((B, T, 13 * H + 4 * Z), dtype=torch.float32, device=saved.device)
    dz0 = torch.empty((B, Z), dtype=torch.float32, device=saved.device)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=saved.device)
    barrier = torch.empty(1, dtype=torch.int32, device=saved.device)
    w_ptrs = (ctypes.c_void_p * N_KERNEL_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    g_ptrs = (ctypes.c_void_p * 6)(*(_ptr(g) for g in grads))
    lib = cuda.library()
    cuda.count_launch("rssm_chain_bwd")
    err = lib.blvm_rssm_chain_bwd(
        ctypes.addressof(w_ptrs), eps.data_ptr(), saved.data_ptr(), h.data_ptr(), h0.data_ptr(), _ptr(resets),
        ctypes.addressof(g_ptrs), dpre.data_ptr(), dz0.data_ptr(), dh0.data_ptr(), barrier.data_ptr(), B, T, H, Z,
        int(residual_posterior), int(precision_posterior), sd_beta, sd_epsilon, cuda.stream_handle(saved),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K10-bwd (rssm_chain_bwd): the weights of H={H}, Z={Z} at B={B} do not fit the shared "
                           "memory of a grid of one CTA an SM that is all resident")
    cuda.check(err, "rssm_chain_bwd")
    return dpre, dz0, dh0


def rssm_chain(kernel_weights: Sequence[torch.Tensor], xg: torch.Tensor, xq: Optional[torch.Tensor], z0: torch.Tensor,
               h0: torch.Tensor, eps: Optional[torch.Tensor], resets: Optional[torch.Tensor] = None, *,
               inference: bool, residual_posterior: bool, precision_posterior: bool, use_mode: bool = False,
               sd_beta: float, sd_epsilon: float) -> RSSMChainOutputs:
    """:func:`rssm_chain_plain`'s function.

    Without a gradient: CPU tensors, the twin; CUDA tensors, one launch of K10, float32, on a grid of one CTA an SM.
    With gradients enabled and an input or weight that requires one, in inference mode: :class:`RSSMChainFunction`
    (on the card K10 in save mode forward and K10-bwd backward; on the CPU their twins); the noise gets none. In
    prior mode only the CPU twin has a gradient, by autograd: on the card it raises ``NotImplementedError``. A
    refused dtype or shape raises."""
    kw = dict(inference=inference, residual_posterior=residual_posterior, precision_posterior=precision_posterior,
              use_mode=use_mode, sd_beta=sd_beta, sd_epsilon=sd_epsilon)
    tensors = [*kernel_weights, xg, z0, h0] + [t for t in (xq, eps) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors) and (inference or z0.is_cuda):
        if not inference:
            raise NotImplementedError("rssm_chain has a backward in inference mode only (K10-bwd); run the prior "
                                      "mode (generation) under torch.no_grad() on the card")
        if z0.is_cuda:
            _check(kernel_weights, xg, xq, z0, h0, eps, resets, inference, use_mode)
        outputs = RSSMChainFunction.apply(residual_posterior, precision_posterior, sd_beta, sd_epsilon, resets, xg, xq,
                                          z0, h0, eps.detach(), *kernel_weights)
        return RSSMChainOutputs(*outputs)
    if not z0.is_cuda:
        return rssm_chain_plain(kernel_weights, xg, xq, z0, h0, eps, resets, **kw)
    _check(kernel_weights, xg, xq, z0, h0, eps, resets, inference, use_mode)
    return _launch(kernel_weights, xg, xq, z0, h0, eps, resets, **kw)


def _check(kernel_weights, xg, xq, z0, h0, eps, resets, inference, use_mode) -> None:
    if len(kernel_weights) != N_KERNEL_WEIGHTS:
        raise ValueError(f"rssm_chain takes {N_KERNEL_WEIGHTS} kernel weights, got {len(kernel_weights)}")
    tensors = [*kernel_weights, xg, z0, h0] + [t for t in (xq, eps, resets) if t is not None]
    if any(t.device != z0.device for t in tensors):
        raise ValueError("rssm_chain: all inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors if t is not resets):
        raise NotImplementedError("the rssm_chain kernel (K10) takes float32 inputs and weights only (the JAX step is "
                                  "f32)")
    if xg.ndim != 3 or z0.ndim != 2 or h0.ndim != 2 or xg.shape[0] != z0.shape[0]:
        raise ValueError(f"rssm_chain takes xg (B, T', H), z0 (B, Z), h0 (B, H), got {tuple(xg.shape)}, "
                         f"{tuple(z0.shape)}, {tuple(h0.shape)}")
    B, T, H = xg.shape
    Z = z0.shape[1]
    expected = [(Z, H), (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,)] + [(H, H), (H,)] * 3 + [(H, 2 * Z), (2 * Z,)]
    expected += [(H, H)] + [(H, H), (H,)] * 2 + [(H, 2 * Z), (2 * Z,)]
    wrong = [i for i, (w, shape) in enumerate(zip(kernel_weights, expected)) if tuple(w.shape) != shape]
    if wrong or tuple(h0.shape) != (B, H):
        raise ValueError(f"rssm_chain: for xg {tuple(xg.shape)} and z0 {tuple(z0.shape)} expected h0 ({B}, {H}) and the "
                         f"kernel weights' shapes {expected}; weights {wrong} differ")
    if inference and (xq is None or tuple(xq.shape) != (B, T, H)):
        raise ValueError(f"rssm_chain in inference mode needs xq of shape ({B}, {T}, {H})")
    if (inference or not use_mode) and (eps is None or tuple(eps.shape) != (B, T, Z)):
        raise ValueError(f"rssm_chain needs eps of shape ({B}, {T}, {Z}), got {None if eps is None else tuple(eps.shape)}")
    if resets is not None and tuple(resets.shape) != (T,):
        raise ValueError(f"rssm_chain: resets must have shape ({T},), got {tuple(resets.shape)}")
    if max(H, Z) > MAX_UNITS:
        raise NotImplementedError(f"the rssm_chain kernel (K10) stages at most {MAX_UNITS} units a layer; got H={H}, "
                                  f"Z={Z}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(kernel_weights, xg, xq, z0, h0, eps, resets, *, inference, residual_posterior, precision_posterior,
            use_mode, sd_beta, sd_epsilon, save=False):
    """One launch of K10 on the hoisted products: the outputs, and with ``save`` (inference mode) ``(outputs,
    saved)``, ``saved`` the ``(B, T', 11H + 4Z)`` buffer of :func:`save_fields`."""
    kernel_weights = [w.contiguous() for w in kernel_weights]
    xg, z0, h0 = xg.contiguous(), z0.contiguous(), h0.contiguous()
    xq = xq.contiguous() if inference else None
    eps = eps.contiguous() if inference or not use_mode else None
    resets = resets.to(torch.int32).contiguous() if resets is not None else None
    B, T, H = xg.shape
    Z = z0.shape[1]

    def out(width):
        return torch.empty((B, T, width), dtype=torch.float32, device=z0.device)

    outputs = [out(Z), out(H), out(Z) if inference else None, out(Z) if inference else None, out(Z), out(Z)]
    act = torch.empty(10 * B * H, dtype=torch.float32, device=z0.device)
    saved = torch.empty((B, T, 11 * H + 4 * Z), dtype=torch.float32, device=z0.device) if save else None
    barrier = torch.empty(1, dtype=torch.int32, device=z0.device)
    w_ptrs = (ctypes.c_void_p * N_KERNEL_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    o_ptrs = (ctypes.c_void_p * len(outputs))(*(_ptr(o) for o in outputs))
    lib = cuda.library()
    cuda.count_launch("rssm_chain")
    err = lib.blvm_rssm_chain(
        ctypes.addressof(w_ptrs), xg.data_ptr(), _ptr(xq), z0.data_ptr(), h0.data_ptr(), _ptr(eps), _ptr(resets),
        ctypes.addressof(o_ptrs), act.data_ptr(), _ptr(saved), barrier.data_ptr(), B, T, H, Z, int(inference),
        int(residual_posterior), int(precision_posterior), int(use_mode), sd_beta, sd_epsilon, cuda.stream_handle(z0),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K10 (rssm_chain): the weights of H={H}, Z={Z} at B={B} do not fit the shared memory of a "
                           "grid of one CTA an SM that is all resident")
    cuda.check(err, "rssm_chain")
    return (RSSMChainOutputs(*outputs), saved) if save else RSSMChainOutputs(*outputs)
