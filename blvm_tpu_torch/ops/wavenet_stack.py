"""P2/P3: the fused WaveNet residual stack, its plain twin and its gradient.

One call runs a stack of ``L`` k=2 residual-GLU blocks (each K1's block, :func:`residual_glu_plain`) over
``x (B, T_in, C)`` and returns ``(out, summed, tapped)``: the last block's residual output
``(B, T_in - sum(dilations), C)``, the sum over the blocks, in block order, of each block's skip over the
last ``skip_size`` rows, ``(B, skip_size, S)`` in float32 (float64 for a float64 stack), and the skips of the
blocks listed in ``taps``. Given ``acc`` (the sum of earlier stacks), the blocks' skips are added into it in
place and it is returned as ``summed``, so that a model's five stacks leave one sum and no skip-sum adds.

CPU tensors run the twin :func:`wavenet_stack_plain` (autograd gives its gradient). CUDA tensors launch the
hand-written kernel ``csrc/wavenet_stack.cu`` (one cooperative launch a stack, float32 or bfloat16 at
C = half = R = S = 96, the run specs' width) or raise; with a gradient, :class:`WaveNetStackFunction`: its
forward is the kernel in save mode, which also keeps every block's input; its backward is :func:`stack_backward`, the
blocks' backward in reverse (:func:`residual_glu_backward`: in bf16 its warpgroup route, which writes each block's
gradients into its slot of the stacked gradients; in f32 K1-bwd and its weight-gradient GEMMs).
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.residual_glu import (_DTYPE_CODES, _aligned, residual_glu_backward,
                                             residual_glu_backward_plain, residual_glu_plain, wg_chain_backward,
                                             wg_route)

# the block parameters, in the order of residual_glu's arguments; stacked each keeps its flax shape behind the
# block axis
PARAM_NAMES = ("gate_kernel_t", "gate_kernel_s", "gate_bias_t", "gate_bias_s", "rs_kernel", "rs_bias")
MAX_LAYERS = 16  # csrc/wavenet_stack.cu: MAX_LAYERS
KERNEL_WIDTHS = (96,)  # the C = half = R = S it is instantiated for (the run specs')


def pack_blocks(blocks, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The blocks' parameters stacked on a leading block axis and cast to the compute dtype, in the order of
    :data:`PARAM_NAMES`: ``(L, 2, C, half)`` twice, ``(L, half)`` twice, ``(L, 1, half, R + S)``, ``(L, R + S)``.
    Entry ``[l]`` of each is block ``l``'s parameter as ``weights.load_jax_params`` set it (cast)."""
    return tuple(torch.stack([getattr(b, name) for b in blocks]).to(dtype) for name in PARAM_NAMES)


def wavenet_stack_plain(x: torch.Tensor, params: Sequence[torch.Tensor], dilations: Sequence[int], skip_size: int,
                        taps: Sequence[int] = (), acc: Optional[torch.Tensor] = None):
    """The twin: ``L`` :func:`residual_glu_plain` calls, the skip sum in block order (``acc += s``, or a widened
    copy of block 0's skip without ``acc``). Returns ``(out, summed, tapped)``; autograd gives its gradient."""
    o, summed, tapped = x, acc, {}
    for l, d in enumerate(dilations):
        o, s = residual_glu_plain(o, *(p[l] for p in params), dilation=d, skip_size=skip_size)
        if l in taps:
            tapped[l] = s
        if summed is None:
            summed = s.to(torch.promote_types(s.dtype, torch.float32), copy=True)
        else:
            summed += s
    return o, summed, [tapped[l] for l in taps]


def wavenet_stack(x: torch.Tensor, params: Sequence[torch.Tensor], dilations: Sequence[int], skip_size: int,
                  taps: Sequence[int] = (), acc: Optional[torch.Tensor] = None):
    """P2/P3, :func:`wavenet_stack_plain`'s function: ``(out, summed, tapped)``.

    ``params`` as :func:`pack_blocks` gives them, in ``x``'s dtype. CPU tensors: the twin. CUDA tensors: one
    launch of the kernel, with gradients enabled and an input that requires one through
    :class:`WaveNetStackFunction`; a CUDA tensor the kernel does not take raises."""
    if not x.is_cuda:
        return wavenet_stack_plain(x, params, dilations, skip_size, taps, acc)
    _check(x, params, dilations, skip_size, taps, acc)
    tensors = [x, *params] + ([acc] if acc is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out, summed, *tapped = WaveNetStackFunction.apply(x, acc, tuple(dilations), skip_size, tuple(taps), *params)
        return out, summed, tapped
    out, summed, _, tapped = _launch(x, params, dilations, skip_size, taps, acc, save=False)
    return out, summed, tapped


def _skip_grads(d_sum, d_taps, taps, L, dtype):
    """Each block's skip gradient: the summed skip's, cast to the compute dtype as the f32 sum's autograd casts it,
    plus the tap's where the block is tapped (``d_taps[i]`` of ``taps[i]``, None read as zero)."""
    d_skip = d_sum.to(dtype)
    return [d_skip + d_taps[taps.index(l)] if l in taps and d_taps[taps.index(l)] is not None else d_skip
            for l in range(L)]


def stack_backward(inputs, params, dilations, skip_size, taps, d_out, d_sum, d_taps):
    """The gradient of one stack from every block's input (``inputs``, as the save mode keeps them) and the
    gradients of its outputs: ``(d_x, grads)``, ``grads`` the six stacked ``(L, ...)`` gradients of ``params`` (the
    last, ``rs_bias``'s, included). The blocks' backward runs in reverse. CUDA tensors: in bf16 at C = 96 the
    warpgroup route over the whole chain (:func:`~blvm_tpu_torch.ops.residual_glu.wg_chain_backward`, each block's
    gradients written into its slot of the stacked tensors), else :func:`residual_glu_backward` block by block, its
    gradients stacked at the end. Its twin is :func:`stack_backward_plain`."""
    L, x0 = len(dilations), inputs[0]
    d_skips = _skip_grads(d_sum, d_taps, taps, L, x0.dtype)
    if wg_route(x0, params[0].shape[-1], params[4].shape[-1] - x0.shape[-1], True):
        grads = [torch.empty_like(p) for p in params]
        d_x = wg_chain_backward(inputs, _aligned(*params[:5]), *_aligned(d_out), _aligned(*d_skips), dilations,
                                skip_size, grads)
        return d_x, grads
    return _blockwise_backward(residual_glu_backward, inputs, params, dilations, skip_size, d_out, d_skips)


def stack_backward_plain(inputs, params, dilations, skip_size, taps, d_out, d_sum, d_taps):
    """The twin of :func:`stack_backward`: the warpgroup route's twin
    (:func:`~blvm_tpu_torch.ops.residual_glu.residual_glu_backward_plain`) block by block, its gradients stacked. In
    float64 it is the exact gradient (autograd of :func:`wavenet_stack_plain`)."""
    d_skips = _skip_grads(d_sum, d_taps, taps, len(dilations), inputs[0].dtype)
    return _blockwise_backward(residual_glu_backward_plain, inputs, params, dilations, skip_size, d_out, d_skips)


def _blockwise_backward(block_backward, inputs, params, dilations, skip_size, d_out, d_skips):
    grads, d_x = [[] for _ in params], d_out
    for l in reversed(range(len(dilations))):
        d_x, *block_grads = block_backward(inputs[l], *(p[l] for p in params[:5]), d_o=d_x, d_s=d_skips[l],
                                           dilation=dilations[l], skip_size=skip_size)
        for g, bg in zip(grads, block_grads):
            g.append(bg)
    return d_x, [torch.stack(g[::-1]) for g in grads]


class WaveNetStackFunction(torch.autograd.Function):
    """The kernel under autograd (CUDA tensors): ``apply(x, acc, dilations, skip_size, taps, *params)`` ->
    ``(out, summed, *tapped)``. The forward keeps every block's input, the same tensors the chain of
    ``ResidualGLUFunction`` launches saves: one launch of the kernel in save mode (its outputs the same bits as
    without). ``acc``, when given, is summed into in place (``mark_dirty``) and its
    gradient is the sum's. The backward is :func:`stack_backward`. Absent output gradients are read as zero."""

    @staticmethod
    def forward(ctx, x, acc, dilations, skip_size, taps, *params):
        out, summed, inputs, tapped = _launch(x, params, dilations, skip_size, taps, acc, save=True)
        if acc is not None:
            ctx.mark_dirty(acc)
        ctx.set_materialize_grads(False)
        ctx.geometry = (dilations, skip_size, taps, acc is not None, tuple(out.shape), tuple(summed.shape))
        ctx.save_for_backward(*inputs, *params)
        return (out, summed, *tapped)

    @staticmethod
    def backward(ctx, d_out, d_sum, *d_taps):
        dilations, skip_size, taps, accumulated, out_shape, sum_shape = ctx.geometry
        L = len(dilations)
        inputs, params = ctx.saved_tensors[:L], ctx.saved_tensors[L:]
        dtype, device = inputs[0].dtype, inputs[0].device
        d_x = d_out if d_out is not None else torch.zeros(out_shape, dtype=dtype, device=device)
        d_skip = d_sum if d_sum is not None else torch.zeros(sum_shape, device=device)
        d_x, grads = stack_backward(inputs, params, dilations, skip_size, taps, d_x, d_skip, d_taps)
        d_acc = d_sum if accumulated else None
        return (d_x, d_acc, None, None, None, *grads)


def _check(x, params, dilations, skip_size, taps, acc) -> None:
    """Raise for what the kernel does not take."""
    tensors = [x, *params] + ([acc] if acc is not None else [])
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in params) or any(t.device != x.device
                                                                                      for t in tensors):
        raise TypeError("wavenet_stack kernel: x and the weights must share one CUDA device and one dtype, float32 or "
                        f"bfloat16; got x {x.dtype} and weights {[t.dtype for t in params]}")
    L = len(dilations)
    if x.ndim != 3 or len(params) != len(PARAM_NAMES) or not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"wavenet_stack kernel takes x (B, T_in, C), {len(PARAM_NAMES)} stacked weights and 1 to "
                         f"{MAX_LAYERS} blocks; got x {tuple(x.shape)}, {len(params)} weights, {L} blocks")
    B, T_in, C = x.shape
    half, RS = params[0].shape[-1], params[4].shape[-1]
    expected = [(L, 2, C, half), (L, 2, C, half), (L, half), (L, half), (L, 1, half, RS), (L, RS)]
    if [tuple(t.shape) for t in params] != expected:
        raise ValueError(f"wavenet_stack kernel: weight shapes {[tuple(t.shape) for t in params]}, expected {expected}")
    if not (C == half == RS - C and C in KERNEL_WIDTHS):
        raise NotImplementedError(f"the wavenet_stack kernel takes C = half = R = S in {KERNEL_WIDTHS}; got C={C}, "
                                  f"half={half}, S={RS - C}")
    T_out = T_in - sum(dilations)
    if min(dilations) < 1 or not 1 <= skip_size <= T_out or any(not 0 <= l < L for l in taps):
        raise ValueError(f"wavenet_stack kernel: bad geometry T_in={T_in}, dilations={list(dilations)}, "
                         f"skip_size={skip_size}, taps={list(taps)}")
    if acc is not None and (acc.dtype != torch.float32 or tuple(acc.shape) != (B, skip_size, C)):
        raise ValueError(f"wavenet_stack kernel: acc must be float32 ({B}, {skip_size}, {C}); got {acc.dtype} "
                         f"{tuple(acc.shape)}")


def _launch(x, params, dilations, skip_size, taps, acc, save):
    """One launch of the kernel: ``(out, summed, inputs, tapped)``, ``inputs`` every block's input with ``save``
    (views of one buffer; block 0's is ``x``), else None. Arguments were checked by :func:`_check`."""
    x = x.contiguous()
    params = [p.contiguous() for p in params]
    B, T_in, C = x.shape
    L = len(dilations)
    lengths = [T_in]
    for d in dilations:
        lengths.append(lengths[-1] - d)

    def empty(*shape, dtype=x.dtype):
        return torch.empty(shape, dtype=dtype, device=x.device)

    out = empty(B, lengths[L], C)
    if save:  # one buffer holds blocks 1 .. L-1's inputs, which the backward reads
        buf = empty(B * C * sum(lengths[1:L]))
        sizes = [B * n * C for n in lengths[1:L]]
        inner = [v.view(B, n, C) for v, n in zip(torch.split(buf, sizes), lengths[1:L])] if L > 1 else []
    else:  # the residual stream in two buffers, in turn
        pair = [empty(B * lengths[1] * C) for _ in range(min(L - 1, 2))]
        inner = [pair[i % 2][: B * n * C].view(B, n, C) for i, n in enumerate(lengths[1:L])]
    io = [x, *inner, out]
    summed = acc if acc is not None else empty(B, skip_size, C, dtype=torch.float32)
    tapped = [empty(B, skip_size, C) for _ in taps]
    tap_ptrs = [None] * L
    for l, t in zip(taps, tapped):
        tap_ptrs[l] = t.data_ptr()
    barrier = empty(1, dtype=torch.int32)
    io_arr = (ctypes.c_void_p * (L + 1))(*(t.data_ptr() for t in io))
    tap_arr = (ctypes.c_void_p * L)(*tap_ptrs)
    dil_arr = (ctypes.c_int * L)(*dilations)
    lib = cuda.library()
    cuda.count_launch("wavenet_stack")
    err = lib.blvm_wavenet_stack(
        ctypes.addressof(io_arr), ctypes.addressof(tap_arr), *(p.data_ptr() for p in params), summed.data_ptr(),
        barrier.data_ptr(), ctypes.addressof(dil_arr), B, T_in, C, C, C, L, skip_size, int(acc is not None),
        _DTYPE_CODES[x.dtype], cuda.stream_handle(x),
    )
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError("wavenet_stack: a grid of one CTA an SM does not fit the card's shared memory")
    cuda.check(err, "wavenet_stack")
    return out, summed, ([x, *inner] if save else None), tapped
