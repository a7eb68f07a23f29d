"""The fast-generation frame loops on the card: K4, WaveNet's, and K12, STCN's.

K4 is the Fast-WaveNet frame loop (port of the frame loop of
``blvm_tpu/models/wavenet/wavenet.py`` ``WaveNet._generate_fast``, ``:279-380``).

:class:`WaveNetDecoder` holds what the frames of one ``generate`` call share: the
residual blocks' weights stacked and cast to the stack dtype once (not once a
frame), the causal tap's and the head's weights, and one circular buffer a block
at its own length ``d`` (5 x 1023 frames at the flagship width, where JAX pads
every block's buffer to 512). :meth:`WaveNetDecoder.run` launches the
hand-written kernel ``csrc/wavenet_decode.cu`` once a frame, with no
synchronisation and no host copy inside the loop. It raises on a model, tensor
or width the kernel does not take. The plain twin of the loop is
``WaveNet._generate_fast_plain``.

K12 is STCN's (``blvm_tpu/models/stcn/stcn.py`` ``STCN._generate_fast``, ``:486-644``):
:class:`STCNDecoder`, one launch of ``csrc/stcn_decode.cu`` a frame; its plain twin is
``STCN._generate_fast_plain``.
"""

import ctypes
from typing import List, Optional

import torch
import torch.nn.functional as F

from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense
from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops.variational import UNIFORM_MAPS, FrameKeys

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K4's limits (csrc/wavenet_decode.cu): MAX_WIDTH for C, half and S; MAX_COLS for pad8(C + S); DMOL_MAX_M
K4_MAX_WIDTH, K4_MAX_COLS, K4_MAX_MIX = 256, 512, 32


def _pad_cols(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim zero-padded to a multiple of 8 (the kernel loads 16 bytes a thread), contiguous."""
    return F.pad(t, (0, -t.shape[-1] % 8)).contiguous()


class WaveNetDecoder:
    """The frame loop of one fast generation on the card, primed by ``tails``
    (``ResidualStack(..., collect_tails=True)``: each block's last ``dilation``
    input frames, ``(B, d, C)``)."""

    def __init__(self, model, tails: List[torch.Tensor]):
        stack, head = model.res_stack, model.likelihood_head
        blocks = stack.blocks
        self.dtype = torch.bfloat16 if model.bf16 else torch.float32
        device = model.causal.Conv1d_0.kernel.device
        C, half = model.res_channels, blocks[0].gate_kernel_t.shape[-1]
        S = blocks[0].skip_channels
        if device.type != "cuda":
            raise ValueError(f"the wavenet_decode kernel runs on CUDA tensors; the model lies on {device}")
        if model.kernel_size != 2 or model.n_stack_frames != 1 or model.in_channels != 1:
            raise ValueError("the wavenet_decode kernel takes kernel_size 2, one input channel and one frame a step; "
                             f"got kernel_size={model.kernel_size}, in_channels={model.in_channels}, "
                             f"n_stack_frames={model.n_stack_frames}")
        if not isinstance(head, DiscretizedLogisticMixtureDense) or head.y_dim != 1:
            raise ValueError(f"the wavenet_decode kernel samples a DMoL head with y_dim 1, not {type(head).__name__}")
        if (max(C, half, S) > K4_MAX_WIDTH or C + S + (-(C + S) % 8) > K4_MAX_COLS or head.num_mix > K4_MAX_MIX
                or any(b.rs_bias is None for b in blocks)):
            raise ValueError(f"the wavenet_decode kernel takes C, half, S <= {K4_MAX_WIDTH}, C + S <= {K4_MAX_COLS}, "
                             f"num_mix <= {K4_MAX_MIX} and biased blocks; got C={C}, half={half}, S={S}, "
                             f"num_mix={head.num_mix}")
        B = tails[0].shape[0]
        self.dilations = [b.dilation for b in blocks]
        if [tuple(t.shape) for t in tails] != [(B, d, C) for d in self.dilations] or not 1 <= B <= 65535:
            raise ValueError(f"tails must be (B, dilation, C) per block, got {[tuple(t.shape) for t in tails]}")
        if any(t.device != device for t in tails):
            raise ValueError("the tails must lie on the model's device")

        def stacked(name):
            return torch.stack([getattr(b, name).detach() for b in blocks]).to(self.dtype)

        # [tanh | sigmoid] columns a tap, as JAX's decode step concatenates them (wavenet.py:327-333)
        self.w_gate = _pad_cols(torch.cat([stacked("gate_kernel_t"), stacked("gate_kernel_s")], dim=-1))  # (L, 2, C, 2h)
        self.b_gate = _pad_cols(torch.cat([stacked("gate_bias_t"), stacked("gate_bias_s")], dim=-1))
        self.w_rs = _pad_cols(stacked("rs_kernel")[:, 0])  # (L, half, R + S)
        self.b_rs = _pad_cols(stacked("rs_bias"))
        self.w_in = _pad_cols(stack.Conv1d_0.kernel.detach()[0].to(self.dtype))  # (C, C)
        self.b_in = stack.Conv1d_0.bias.detach().to(self.dtype).contiguous()
        causal = model.causal.Conv1d_0
        self.w_causal = causal.kernel.detach()[:, 0, :].float().contiguous()  # (2, C): taps x[t-2], x[t-1]
        self.b_causal = causal.bias.detach().float().contiguous()
        out = model.out_transform.Dense_0
        self.w_out, self.b_out = _pad_cols(out.kernel.detach().float()), out.bias.detach().float().contiguous()
        self.w_head = _pad_cols(head.Dense_0.kernel.detach().float())
        self.b_head = head.Dense_0.bias.detach().float().contiguous()
        self.buffers = torch.cat([t.to(self.dtype) for t in tails], dim=1).contiguous()  # (B, sum(d), C)
        offsets = [0, *torch.tensor(self.dilations).cumsum(0).tolist()[:-1]]
        self.dil_t = torch.tensor(self.dilations, dtype=torch.int32, device=device)
        self.off_t = torch.tensor(offsets, dtype=torch.int32, device=device)
        self.shape = (B, len(blocks), C, half, S, head.num_mix, self.buffers.shape[1])
        self.variance_scale, self.log_eps = model.variance_scale, head.log_epsilon
        self.device = device

    def run(self, x_last: torch.Tensor, pred0: torch.Tensor, n_frames: int, keys: FrameKeys) -> torch.Tensor:
        """Frames ``1 .. n_frames - 1`` after the primed frame 0 (``pred0``, ``(B,)``),
        from the history's last frame ``x_last`` ``(B,)``: one launch a frame.
        Returns all ``n_frames`` samples, ``(B, n_frames)`` float32."""
        B, L, C, half, S, M, D = self.shape
        if x_last.shape != (B,) or pred0.shape != (B,):
            raise ValueError(f"x_last and pred0 must be ({B},), got {tuple(x_last.shape)}, {tuple(pred0.shape)}")
        x = torch.empty((B, n_frames + 1), dtype=torch.float32, device=self.device)
        x[:, 0], x[:, 1] = x_last, pred0
        if keys.uniforms is not None:
            u_cat, u_log = keys.uniforms
            if u_cat.shape[:2] != (n_frames, B) or u_cat.shape[2] != M or u_cat.device != self.device:
                raise ValueError(f"uniforms must be ({n_frames}, {B}, {M}) on {self.device}, got {tuple(u_cat.shape)}")
            random_ptrs = (None, u_cat.data_ptr(), u_log.data_ptr())
        elif keys.seed is not None and keys.seed.device == self.device:
            random_ptrs = (keys.seed.data_ptr(), None, None)
        else:
            raise ValueError("the wavenet_decode kernel needs a Philox seed on the model's device or uniforms")
        lib = cuda.library()
        # every argument but the frame, converted once: the loop's host cost is the call itself
        head = [ctypes.c_void_p(t.data_ptr()) for t in (
            self.w_gate, self.b_gate, self.w_rs, self.b_rs, self.w_in, self.b_in, self.w_causal, self.b_causal,
            self.w_out, self.b_out, self.w_head, self.b_head, self.dil_t, self.off_t, self.buffers, x)]
        head += [ctypes.c_void_p(p) for p in random_ptrs]
        head += [ctypes.c_int(v) for v in (B, L, C, half, S, M, D, n_frames + 1)]
        tail = [ctypes.c_float(v) for v in (self.variance_scale, self.log_eps, *UNIFORM_MAPS)]
        tail += [ctypes.c_int(_DTYPE_CODES[self.dtype]), ctypes.c_void_p(cuda.stream_handle(x))]
        for frame in range(1, n_frames):
            cuda.count_launch("wavenet_decode")
            cuda.check(lib.blvm_wavenet_decode(*head, frame, *tail), "wavenet_decode")
        return x[:, 1:]



# K12's limits (csrc/stcn_decode.cu): MAX_B rows, MAX_LAT levels, MAX_ENC encoder blocks, KMAX the deepest product
K12_MAX_B, K12_MAX_LAT, K12_MAX_ENC, K12_KMAX = 8, 8, 64, 512


def _unit_major(kernel: torch.Tensor) -> torch.Tensor:
    """A flax ``(in, out)`` kernel as ``(out, in)``: one output unit's weights contiguous."""
    return kernel.detach().float().t().contiguous()


def pack_stcn_weights(model):
    """K12's weights, in its pointer order (``csrc/stcn_decode.cu`` Params), and its geometry:
    ``(weights, geometry)``. Gate kernels become ``(L, 2, half, 2C)`` (branch, unit, ``[old | h]``
    taps), the ``[r | s]`` and in_transform kernels unit-major, each level's two MLPs side by side
    (mean units, then scale units); the upsample and likelihood kernels stay ``(in, out)``.
    ``geometry`` is the encoder's dilations, each block's latent level (-1 for a block whose skip
    no level reads) and the latent widths."""

    def stack_blocks(stack):
        gate = torch.stack([torch.stack([torch.cat([b.gate_kernel_t[0], b.gate_kernel_t[1]]).t(),
                                         torch.cat([b.gate_kernel_s[0], b.gate_kernel_s[1]]).t()])
                            for b in stack.blocks])
        gate_b = torch.stack([torch.stack([b.gate_bias_t, b.gate_bias_s]) for b in stack.blocks])
        rs = torch.stack([b.rs_kernel[0].t() for b in stack.blocks])
        rs_b = torch.stack([b.rs_bias for b in stack.blocks])
        return [t.detach().float().contiguous() for t in (gate, gate_b, rs, rs_b)]

    causal = model.causal.Conv1d_0
    enc_in, dec_in = model.res_stack.Conv1d_0, model.out_transform.Conv1d_0
    weights = [causal.kernel.detach()[:, 0, :].float().contiguous(), causal.bias.detach().float().contiguous(),
               _unit_major(enc_in.kernel[0]), enc_in.bias.detach().float().contiguous(),
               *stack_blocks(model.res_stack),
               _unit_major(dec_in.kernel[0]), dec_in.bias.detach().float().contiguous(),
               *stack_blocks(model.out_transform)]
    for dense in (model.out_upsample.Dense_0, model.likelihood_module.Dense_0):
        weights += [dense.kernel.detach().float().contiguous(), dense.bias.detach().float().contiguous()]
    for l in range(model.n_latents):
        prior = getattr(model, f"prior_{l}")
        mu, sd = prior.MLP_0, prior.MLP_1
        for i in range(2):
            weights += [torch.cat([_unit_major(getattr(mu, f"Dense_{i}").kernel),
                                   _unit_major(getattr(sd, f"Dense_{i}").kernel)]),
                        torch.cat([getattr(mu, f"Dense_{i}").bias, getattr(sd, f"Dense_{i}").bias]).detach().float()]
        weights += [torch.stack([_unit_major(mu.Dense_2.kernel), _unit_major(sd.Dense_2.kernel)]),
                    torch.stack([mu.Dense_2.bias, sd.Dense_2.bias]).detach().float()]
    level_of = {block: l for l, block in enumerate(model.used_blocks)}
    n_enc = len(model.res_stack.blocks)
    geometry = ([b.dilation for b in model.res_stack.blocks] + [level_of.get(i, -1) for i in range(n_enc)]
                + list(model.latent_size))
    return [w.contiguous() for w in weights], geometry


class STCNDecoder:
    """The frame loop of one STCN fast generation on the card (K12), primed by ``enc_tails``
    (each encoder block's last ``dilation`` input frames, ``(B, d, C)``) and ``dec_tails``
    (each decode block's last input frame, ``(B, 1, C)``), from ``STCN._prime``.

    The weights are packed once a generation (:func:`pack_stcn_weights`), the encoder's
    circular buffers lie one after the other at their own lengths (155 frames at five stacks of
    dilations 1 .. 16, where JAX pads every buffer to 16). :meth:`run` launches
    ``csrc/stcn_decode.cu`` once a frame, frame 0 in its d-column mode, with no
    synchronisation and no host copy inside the loop. It raises on a model, tensor or width
    the kernel does not take: the windowed path serves those. The plain twin of the loop is
    ``STCN._generate_fast_plain``."""

    def __init__(self, model, enc_tails: List[torch.Tensor], dec_tails: List[torch.Tensor]):
        device = model.causal.Conv1d_0.kernel.device
        if device.type != "cuda":
            raise ValueError(f"the stcn_decode kernel runs on CUDA tensors; the model lies on {device}")
        C, half = model.res_channels, model.res_stack.blocks[0].gate_kernel_t.shape[-1]
        S = model.res_stack.blocks[0].skip_channels
        n_enc, n_lat = len(model.res_stack.blocks), model.n_latents
        if (model.kernel_size != 2 or model.n_stack_frames != 1 or model.in_channels != 1 or not model.dense
                or not model.top_down or model.bf16):
            raise ValueError("the stcn_decode kernel takes the dense top-down f32 model with kernel_size 2, one input "
                             f"channel and one frame a step; got kernel_size={model.kernel_size}, "
                             f"n_stack_frames={model.n_stack_frames}, in_channels={model.in_channels}, "
                             f"dense={model.dense}, top_down={model.top_down}, bf16={model.bf16}")
        head = model.likelihood_module
        if head.num_mix * 3 != head.Dense_0.kernel.shape[0] or head.num_mix > K4_MAX_MIX:
            raise ValueError(f"the stcn_decode kernel takes a DMoL head of <= {K4_MAX_MIX} mixtures on 3 M features")
        Z = sum(model.latent_size)
        if (n_lat > K12_MAX_LAT or n_enc > K12_MAX_ENC or 2 * C > K12_KMAX or half > K12_KMAX or Z > K12_KMAX
                or S + max(model.latent_size) > K12_KMAX or any(w % 4 for w in (C, half, S, *model.latent_size))):
            raise ValueError(f"the stcn_decode kernel takes <= {K12_MAX_LAT} levels, <= {K12_MAX_ENC} encoder blocks and "
                             f"products <= {K12_KMAX} deep, every width a multiple of 4; got C={C}, half={half}, S={S}, "
                             f"latent_size={model.latent_size}")
        B = enc_tails[0].shape[0]
        dilations = [b.dilation for b in model.res_stack.blocks]
        if ([tuple(t.shape) for t in enc_tails] != [(B, d, C) for d in dilations]
                or [tuple(t.shape) for t in dec_tails] != [(B, 1, C)] * len(dec_tails) or not 1 <= B <= K12_MAX_B):
            raise ValueError(f"tails must be (B <= {K12_MAX_B}, dilation, C) a block; got "
                             f"{[tuple(t.shape) for t in enc_tails]} and {[tuple(t.shape) for t in dec_tails]}")
        weights, geometry = pack_stcn_weights(model)
        self._weights = weights  # kept alive: the kernel reads them through the pointer array
        self.weight_ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
        self.geometry = (ctypes.c_int * len(geometry))(*geometry)
        f32 = dict(dtype=torch.float32, device=device)
        self.enc_buf = torch.cat([t.float() for t in enc_tails], dim=1).contiguous()  # (B, sum(d), C)
        self.dec_buf = torch.stack([t[:, 0].float() for t in dec_tails]).contiguous()  # (Ld, B, C)
        self.scratch = dict(h=torch.empty(B, C, **f32), act=torch.empty(B, half, **f32),
                            dcol=torch.empty(n_lat, B, S, **f32), hid_a=torch.empty(B, 2 * C, **f32),
                            hid_b=torch.empty(B, 2 * C, **f32), z=torch.empty(B, Z, **f32), skip=torch.empty(B, S, **f32))
        self.barrier = torch.zeros(1, dtype=torch.int32, device=device)
        self.shape = (B, C, half, S, n_enc, len(dec_tails), n_lat, head.num_mix)
        prior = getattr(model, "prior_0")
        self.scalars = (model.inv_std, prior.beta, prior.epsilon, head.log_epsilon)
        self.device, self.Z = device, Z

    def run(self, x_last: torch.Tensor, d_cols0: List[torch.Tensor], n_frames: int, eps: torch.Tensor,
            keys: FrameKeys, use_mode: bool = False, record: bool = False, trace: Optional[torch.Tensor] = None):
        """Frames ``0 .. n_frames - 1``: frame 0 from the encoder prime's columns ``d_cols0``
        (one ``(B, 1, S)`` a level), then one launch a frame from the history's last frame
        ``x_last`` ``(B,)``. ``eps`` ``(n_frames, B, Z)`` is the prior's noise; ``keys`` the
        sampler's stream (a Philox seed on the card, or uniforms). Returns ``(B, n_frames)``
        float32, or with ``record`` also each frame's z ``(n_frames, B, Z)`` and DMoL parameters
        ``(n_frames, B, 30)`` (logits, locs, clamped log-scales). ``trace``, an int64 tensor of 7 on
        the card, gathers the kernel's own account of its launches (``csrc/stcn_decode.cu``)."""
        B, C, half, S, n_enc, n_dec, n_lat, M = self.shape
        if x_last.shape != (B,) or [tuple(d.shape) for d in d_cols0] != [(B, 1, S)] * n_lat:
            raise ValueError(f"x_last must be ({B},) and d_cols0 {n_lat} x ({B}, 1, {S}); got {tuple(x_last.shape)}, "
                             f"{[tuple(d.shape) for d in d_cols0]}")
        if eps.shape != (n_frames, B, self.Z) or eps.dtype != torch.float32 or eps.device != self.device:
            raise ValueError(f"eps must be float32 ({n_frames}, {B}, {self.Z}) on {self.device}, got "
                             f"{eps.dtype}{tuple(eps.shape)} on {eps.device}")
        eps = eps.contiguous()
        x = torch.empty((B, n_frames + 1), dtype=torch.float32, device=self.device)
        x[:, 0] = x_last
        self.scratch["dcol"].copy_(torch.stack([d[:, 0] for d in d_cols0]))
        if keys.uniforms is not None:
            u_cat, u_log = keys.uniforms
            if u_cat.shape != (n_frames, B, M) or u_cat.device != self.device:
                raise ValueError(f"uniforms must be ({n_frames}, {B}, {M}) on {self.device}, got {tuple(u_cat.shape)}")
            random_ptrs = (None, u_cat.data_ptr(), u_log.data_ptr())
        elif keys.seed is not None and keys.seed.device == self.device:
            random_ptrs = (keys.seed.data_ptr(), None, None)
        else:
            raise ValueError("the stcn_decode kernel needs a Philox seed on the model's device or uniforms")
        z_out = torch.empty((n_frames, B, self.Z), dtype=torch.float32, device=self.device) if record else None
        params_out = torch.empty((n_frames, B, 3 * M), dtype=torch.float32, device=self.device) if record else None
        s = self.scratch
        state = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in (
            self.enc_buf, self.dec_buf, x, s["h"], s["act"], s["dcol"], s["hid_a"], s["hid_b"], s["z"], s["skip"],
            self.barrier)))
        lib = cuda.library()
        head = [self.weight_ptrs, self.geometry, state, ctypes.c_void_p(eps.data_ptr())]
        head += [ctypes.c_void_p(p) for p in random_ptrs]
        if trace is not None and (trace.shape != (7,) or trace.dtype != torch.int64 or trace.device != self.device):
            raise ValueError(f"trace must be an int64 (7,) tensor on {self.device}")
        head += [ctypes.c_void_p(t.data_ptr() if t is not None else None) for t in (z_out, params_out, trace)]
        head += [ctypes.c_int(v) for v in (B, C, half, S, n_enc, n_dec, n_lat, M, n_frames + 1)]
        tail = [ctypes.c_int(int(use_mode))]
        tail += [ctypes.c_float(v) for v in (*self.scalars, *UNIFORM_MAPS)]
        tail += [ctypes.c_void_p(cuda.stream_handle(x))]
        for frame in range(n_frames):
            cuda.count_launch("stcn_decode")
            cuda.check(lib.blvm_stcn_decode(*head, frame, int(frame == 0), *tail), "stcn_decode")
        return (x[:, 1:], z_out, params_out) if record else x[:, 1:]
