"""K10: a CW-VAE level's RSSM cell chain over a sequence (port of the ``nn.scan`` of ``blvm_tpu/modules/rssm.py``
``RSSMCell.__call__``, ``:46-62``, in ``CWVAE._run_level``, and of ``RSSMCell.generate``, ``:64-71``, in
``CWVAE.generate``).

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
:func:`rssm_chain` is the entry point: for CPU tensors the twin (with autograd's gradient), for CUDA tensors one
launch of ``csrc/rssm_cell.cu``, float32. K10 has no backward yet: under a gradient on the card it raises.
"""

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.likelihoods import softplus_beta
from blvm_tpu_torch.ops.recurrent import gru_update
from blvm_tpu_torch.ops.variational import precision_weighted_gaussian

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


def rssm_chain_plain(kernel_weights: Sequence[torch.Tensor], xg: torch.Tensor, xq: Optional[torch.Tensor],
                     z0: torch.Tensor, h0: torch.Tensor, eps: Optional[torch.Tensor],
                     resets: Optional[torch.Tensor] = None, *, inference: bool, residual_posterior: bool,
                     precision_posterior: bool, use_mode: bool = False, sd_beta: float,
                     sd_epsilon: float) -> RSSMChainOutputs:
    """The chain of K10 in plain PyTorch, one step at a time, from the hoisted ``xg``, ``xq (B, T', H)`` (``xq``
    None in prior mode), ``z0 (B, Z)``, ``h0 (B, H)``, ``eps (B, T', Z)`` (None in prior mode under ``use_mode``)
    and ``resets`` (None, or ``(T',)`` bools: the step starts from zeros)."""
    wg_z, w_ih, b_ih, w_hh, b_hh, p0, pb0, p1, pb1, p2, pb2, ph, pbh, q0_h, q1, qb1, q2, qb2, qh, qbh = kernel_weights
    Z = ph.shape[1] // 2
    z, h = z0, h0
    steps = []
    for t in range(xg.shape[1]):
        if resets is not None and bool(resets[t]):
            z, h = torch.zeros_like(z), torch.zeros_like(h)
        a = torch.relu(z @ wg_z + xg[:, t])
        h = gru_update(a @ w_ih + b_ih, h @ w_hh + b_hh, h)
        head = torch.relu(torch.relu(torch.relu(h @ p0 + pb0) @ p1 + pb1) @ p2 + pb2) @ ph + pbh
        prior_mu, prior_sd = head[..., :Z], softplus_beta(head[..., Z:], sd_beta) + sd_epsilon
        enc_mu = enc_sd = None
        if inference:
            head = torch.relu(torch.relu(torch.relu(h @ q0_h + xq[:, t]) @ q1 + qb1) @ q2 + qb2) @ qh + qbh
            enc_mu, enc_sd = head[..., :Z], softplus_beta(head[..., Z:], sd_beta) + sd_epsilon
            if residual_posterior:
                enc_mu = enc_mu + prior_mu
            elif precision_posterior:
                enc_mu, enc_sd = precision_weighted_gaussian(enc_mu, enc_sd, prior_mu, prior_sd)
            z = enc_mu + enc_sd * eps[:, t]
        else:
            z = prior_mu if use_mode else prior_mu + prior_sd * eps[:, t]
        steps.append((z, h, enc_mu, enc_sd, prior_mu, prior_sd))
    return RSSMChainOutputs(*(torch.stack(seq, dim=1) if seq[0] is not None else None for seq in zip(*steps)))


def rssm_chain(kernel_weights: Sequence[torch.Tensor], xg: torch.Tensor, xq: Optional[torch.Tensor], z0: torch.Tensor,
               h0: torch.Tensor, eps: Optional[torch.Tensor], resets: Optional[torch.Tensor] = None, *,
               inference: bool, residual_posterior: bool, precision_posterior: bool, use_mode: bool = False,
               sd_beta: float, sd_epsilon: float) -> RSSMChainOutputs:
    """:func:`rssm_chain_plain`'s function. CPU tensors: the twin. CUDA tensors: one launch of K10, float32, on a
    grid of one CTA an SM; under a gradient it raises ``NotImplementedError`` (K10-bwd is not written yet), a refused
    dtype or shape raises too."""
    kw = dict(inference=inference, residual_posterior=residual_posterior, precision_posterior=precision_posterior,
              use_mode=use_mode, sd_beta=sd_beta, sd_epsilon=sd_epsilon)
    if not z0.is_cuda:
        return rssm_chain_plain(kernel_weights, xg, xq, z0, h0, eps, resets, **kw)
    tensors = [*kernel_weights, xg, z0, h0] + [t for t in (xq, eps) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("rssm_chain (K10) has no backward on the card yet; run the CW-VAE's forward under "
                                  "torch.no_grad() or torch.inference_mode()")
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
            use_mode, sd_beta, sd_epsilon) -> RSSMChainOutputs:
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
    barrier = torch.empty(1, dtype=torch.int32, device=z0.device)
    w_ptrs = (ctypes.c_void_p * N_KERNEL_WEIGHTS)(*(w.data_ptr() for w in kernel_weights))
    o_ptrs = (ctypes.c_void_p * len(outputs))(*(_ptr(o) for o in outputs))
    lib = cuda.library()
    cuda.count_launch("rssm_chain")
    err = lib.blvm_rssm_chain(
        ctypes.addressof(w_ptrs), xg.data_ptr(), _ptr(xq), z0.data_ptr(), h0.data_ptr(), _ptr(eps), _ptr(resets),
        ctypes.addressof(o_ptrs), act.data_ptr(), barrier.data_ptr(), B, T, H, Z, int(inference),
        int(residual_posterior), int(precision_posterior), int(use_mode), sd_beta, sd_epsilon, cuda.stream_handle(z0),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"K10 (rssm_chain): the weights of H={H}, Z={Z} at B={B} do not fit the shared memory of a "
                           "grid of one CTA an SM that is all resident")
    cuda.check(err, "rssm_chain")
    return RSSMChainOutputs(*outputs)
