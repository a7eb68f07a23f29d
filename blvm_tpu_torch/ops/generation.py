"""The fast-generation frame loops on the card: K4, WaveNet's, and K12, STCN's.

K4 is the Fast-WaveNet frame loop (port of the frame loop of
``blvm_tpu/models/wavenet/wavenet.py`` ``WaveNet._generate_fast``, ``:279-380``).
:class:`WaveNetDecoder` holds what the frames of one ``generate`` call share and
picks K4's route by dtype and width (``csrc/wavenet_decode.cu``): bf16 at C = half =
S = 96, the flagship's, runs the resident route, one launch a generation on
clusters of CTAs with each block's weights in its CTA's shared memory
(:func:`pack_wavenet_resident`); f32 and other widths run the per-frame route, one
launch a frame over weights stacked and cast once, one circular buffer a block at
its own length ``d`` (5 x 1023 frames at the flagship width, where JAX pads every
block's buffer to 512). Neither synchronises inside the generation; the resident
route reads its status word once after the launch and raises if a wait timed out.
The wrapper raises on a model, tensor or width the kernels do not take. The plain
twin of the loop is ``WaveNet._generate_fast_plain``.

K12 is STCN's (``blvm_tpu/models/stcn/stcn.py`` ``STCN._generate_fast``, ``:486-644``):
:class:`STCNDecoder`, one cooperative launch of ``csrc/stcn_decode.cu`` a generation over
each CTA's weight stream (:func:`pack_stcn_stream`); its plain twin is
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
# K4's resident route: its width (C = half = S) and rows; the io CTA's padded head width
K4_RES_WIDTH, K4_RES_MAX_B, K4_RES_HEAD = 96, 8, 96
K4_RES_BOX = K4_RES_WIDTH * K4_RES_MAX_B // 2 + K4_RES_MAX_B * K4_RES_WIDTH  # tagged words of a mailbox
# how long one wait inside a persistent launch may spin before the launch gives up, in nanoseconds of the card's
# global timer (csrc/decode_common.cuh); read at each launch
WAIT_LIMIT_NS = 1_000_000_000
# shared memory a CTA may use on sm_90 (the 227 KB opt-in limit)
SMEM_OPTIN = 232448


def _pad_cols(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim zero-padded to a multiple of 8 (the kernel loads 16 bytes a thread), contiguous."""
    return F.pad(t, (0, -t.shape[-1] % 8)).contiguous()


def _random_ptrs(keys: FrameKeys, n_frames: int, B: int, M: int, device, name: str):
    """The sampler's pointers (seed, u_cat, u_log): a Philox seed on ``device`` or uniforms of ``n_frames`` rows."""
    if keys.uniforms is not None:
        u_cat, u_log = keys.uniforms
        if u_cat.shape[:2] != (n_frames, B) or u_cat.shape[2] != M or u_cat.device != device:
            raise ValueError(f"uniforms must be ({n_frames}, {B}, {M}) on {device}, got {tuple(u_cat.shape)}")
        return None, u_cat.data_ptr(), u_log.data_ptr()
    if keys.seed is not None and keys.seed.device == device:
        return keys.seed.data_ptr(), None, None
    raise ValueError(f"the {name} kernel needs a Philox seed on the model's device or uniforms")


def _raise_on_status(status: torch.Tensor, name: str) -> None:
    """Read a persistent launch's status word (the one wait on the host a generation) and raise if it is set."""
    code = int(status.item())
    if code:
        raise RuntimeError(f"CUDA kernel {name} gave up: status {code} (a wait outlasted its limit)")


def mma_fragments(a: torch.Tensor) -> torch.Tensor:
    """``a`` (..., M, K), M and K multiples of 16, as ``mma.sync`` m16n8k16 A fragments: (..., M / 16, K / 16, 32,
    8), lane l's eight values of a 16 x 16 tile in register order (rows g, g, g + 8, g + 8, g, g, g + 8, g + 8 and
    columns 2t, 2t + 1, 2t, 2t + 1, 2t + 8, 2t + 9, 2t + 8, 2t + 9 for g = l // 4, t = l % 4), contiguous."""
    lane = torch.arange(32, device=a.device)
    g, t = lane // 4, lane % 4
    rows = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], 1)
    cols = torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9, 2 * t + 8, 2 * t + 9], 1)
    *lead, M, K = a.shape
    tiles = a.reshape(*lead, M // 16, 16, K // 16, 16).transpose(-3, -2)
    return tiles[..., rows, cols].contiguous()


def _paired_rows(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Two flax ``(in, n)`` kernels as one ``(2 n, in)`` matrix whose 16-row tile mt holds units 8 mt .. 8 mt + 7
    of ``first``, then the same units of ``second``."""
    n = first.shape[1]
    return torch.stack([first.t().reshape(n // 8, 8, -1), second.t().reshape(n // 8, 8, -1)], 1).reshape(2 * n, -1)


def pack_wavenet_resident(model) -> dict:
    """K4's resident route's weights (``csrc/wavenet_decode.cu`` k4res::Args), bf16 blocks in fragment order:
    ``w_blocks`` (L, 3, 12, 6, 32, 8) the gate's old tap, its h tap ([tanh | sigmoid] units paired a tile) and
    [r | s]; ``b_blocks`` (L, 4, 96) b_t, b_s, b_r, b_s; ``w_in`` (6, 6, 32, 8) and ``b_in`` the in_transform;
    f32 ``w_causal`` (2, 96), ``b_causal``, ``w_out`` (96, 96), ``b_out``, ``w_head`` (96, 96) (3 M columns
    used), ``b_head``."""
    stack, head = model.res_stack, model.likelihood_head
    C = model.res_channels
    bf = torch.bfloat16

    def block(b):
        rs = b.rs_kernel.detach()[0]
        mats = [_paired_rows(b.gate_kernel_t.detach()[k], b.gate_kernel_s.detach()[k]) for k in (0, 1)]
        return torch.stack([*mats, _paired_rows(rs[:, :C], rs[:, C:])]).to(bf)

    w_blocks = mma_fragments(torch.stack([block(b) for b in stack.blocks]))
    b_blocks = torch.stack([torch.stack([b.gate_bias_t, b.gate_bias_s, b.rs_bias[:C], b.rs_bias[C:]])
                            for b in stack.blocks]).detach().to(bf).contiguous()
    causal, out = model.causal.Conv1d_0, model.out_transform.Dense_0
    return dict(
        w_blocks=w_blocks, b_blocks=b_blocks,
        w_in=mma_fragments(stack.Conv1d_0.kernel.detach()[0].t().to(bf)),
        b_in=stack.Conv1d_0.bias.detach().to(bf).contiguous(),
        w_causal=causal.kernel.detach()[:, 0, :].float().contiguous(), b_causal=causal.bias.detach().float().contiguous(),
        w_out=out.kernel.detach().float().contiguous(), b_out=out.bias.detach().float().contiguous(),
        w_head=F.pad(head.Dense_0.kernel.detach().float(), (0, K4_RES_HEAD - head.Dense_0.kernel.shape[1])).contiguous(),
        b_head=head.Dense_0.bias.detach().float().contiguous())


class WaveNetDecoder:
    """The frame loop of one fast generation on the card, primed by ``tails``
    (``ResidualStack(..., collect_tails=True)``: each block's last ``dilation``
    input frames, ``(B, d, C)``). ``resident`` says which route runs: the resident
    one (bf16 at C = half = S = 96, B <= 8) or the per-frame one."""

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
        self.resident = model.bf16 and C == half == S == K4_RES_WIDTH
        if self.resident and B > K4_RES_MAX_B:
            raise ValueError(f"the wavenet_decode kernel's resident route (bf16, C = {K4_RES_WIDTH}) takes at most "
                             f"{K4_RES_MAX_B} sequences, got {B}")
        if self.resident:
            self.weights = pack_wavenet_resident(model)
        else:
            def stacked(name):
                return torch.stack([getattr(b, name).detach() for b in blocks]).to(self.dtype)

            # [tanh | sigmoid] columns a tap, as JAX's decode step concatenates them (wavenet.py:327-333)
            self.w_gate = _pad_cols(torch.cat([stacked("gate_kernel_t"), stacked("gate_kernel_s")], dim=-1))
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

    def run(self, x_last: torch.Tensor, pred0: torch.Tensor, n_frames: int, keys: FrameKeys,
            trace: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Frames ``1 .. n_frames - 1`` after the primed frame 0 (``pred0``, ``(B,)``),
        from the history's last frame ``x_last`` ``(B,)``: one launch a generation on the
        resident route (then one wait on the host for its status word), one a frame on the
        per-frame route. Returns all ``n_frames`` samples, ``(B, n_frames)`` float32.
        ``trace`` (resident route), an int64 ``(8 ceil((L + 1) / 8), 4)`` tensor on the card,
        receives each CTA's SM cycles by phase (``csrc/wavenet_decode.cu``)."""
        B, L, C, half, S, M, D = self.shape
        if x_last.shape != (B,) or pred0.shape != (B,):
            raise ValueError(f"x_last and pred0 must be ({B},), got {tuple(x_last.shape)}, {tuple(pred0.shape)}")
        x = torch.empty((B, n_frames + 1), dtype=torch.float32, device=self.device)
        x[:, 0], x[:, 1] = x_last, pred0
        random_ptrs = _random_ptrs(keys, n_frames, B, M, self.device, "wavenet_decode")
        lib = cuda.library()
        stream = ctypes.c_void_p(cuda.stream_handle(x))
        maps = [ctypes.c_float(v) for v in (self.variance_scale, self.log_eps, *UNIFORM_MAPS)]
        if self.resident:
            if n_frames < 2:
                return x[:, 1:]
            w = self.weights
            boxes = torch.zeros((L + 1, K4_RES_BOX), dtype=torch.int64, device=self.device)
            status = torch.zeros(1, dtype=torch.int32, device=self.device)
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
                w["w_blocks"], w["b_blocks"], w["w_in"], w["b_in"], w["w_causal"], w["b_causal"], w["w_out"],
                w["b_out"], w["w_head"], w["b_head"], self.dil_t, self.off_t, self.buffers, boxes, x)]
            n_ctas = 8 * -(-(L + 1) // 8)
            if trace is not None and (trace.shape != (n_ctas, 4) or trace.dtype != torch.int64
                                      or trace.device != self.device):
                raise ValueError(f"trace must be an int64 ({n_ctas}, 4) tensor on {self.device}")
            ptrs += [ctypes.c_void_p(p) for p in random_ptrs] + [ctypes.c_void_p(status.data_ptr())]
            ptrs.append(ctypes.c_void_p(trace.data_ptr() if trace is not None else None))
            cuda.count_launch("wavenet_decode_resident")
            cuda.check(lib.blvm_wavenet_decode_resident(*ptrs, B, L, M, D, n_frames, *maps,
                                                        ctypes.c_longlong(WAIT_LIMIT_NS), stream),
                       "wavenet_decode_resident")
            _raise_on_status(status, "wavenet_decode_resident")
            return x[:, 1:]
        # every argument but the frame, converted once: the loop's host cost is the call itself
        head = [ctypes.c_void_p(t.data_ptr()) for t in (
            self.w_gate, self.b_gate, self.w_rs, self.b_rs, self.w_in, self.b_in, self.w_causal, self.b_causal,
            self.w_out, self.b_out, self.w_head, self.b_head, self.dil_t, self.off_t, self.buffers, x)]
        head += [ctypes.c_void_p(p) for p in random_ptrs]
        head += [ctypes.c_int(v) for v in (B, L, C, half, S, M, D, n_frames + 1)]
        tail = maps + [ctypes.c_int(_DTYPE_CODES[self.dtype]), stream]
        for frame in range(1, n_frames):
            cuda.count_launch("wavenet_decode")
            cuda.check(lib.blvm_wavenet_decode(*head, frame, *tail), "wavenet_decode")
        return x[:, 1:]


# K12's limits (csrc/stcn_decode.cu): MAX_B rows, MAX_LAT levels, MAX_ENC encoder and MAX_DEC decode blocks, KMAX the
# deepest product; its CTAs' warps, its ring's chunk slots, the head's padded width
K12_MAX_B, K12_MAX_LAT, K12_MAX_ENC, K12_MAX_DEC, K12_KMAX = 8, 8, 64, 16, 512
K12_WARPS, K12_RING, K12_MAX_D = 8, 3, 96


def _unit_major(kernel: torch.Tensor) -> torch.Tensor:
    """A flax ``(in, out)`` kernel as ``(out, in)``: one output unit's weights contiguous."""
    return kernel.detach().float().t().contiguous()


def stcn_stages(model) -> List[torch.Tensor]:
    """K12's products in a frame's order (``csrc/stcn_decode.cu``), each ``(NDOT, U, K)`` f32, one unit's
    column of each dot contiguous: the encoder's in_transform; each encoder block's gate ``(2, half, 2C)``
    (tanh and sigmoid dots, ``[old | h]`` taps) and ``[r | s]`` (``(1, C, half)`` for a block whose skip
    no level reads); each level from the top, its two MLPs side by side (mean units, then scale units)
    ``(1, 2H, S + z_cond)``, ``(1, 2H, H)``, ``(2, z_l, H)``; the decode in_transform ``(1, C, Z)``; each
    decode block's gate and ``[r | s]``."""
    C = model.res_channels
    used = set(model.used_blocks)

    def blocks(stack, keep_skip):
        out = []
        for i, b in enumerate(stack.blocks):
            gate = torch.stack([torch.cat([b.gate_kernel_t[0], b.gate_kernel_t[1]]).t(),
                                torch.cat([b.gate_kernel_s[0], b.gate_kernel_s[1]]).t()])
            rs = b.rs_kernel[0].t()
            out += [gate, (rs if keep_skip(i) else rs[:C])[None]]
        return out

    stages = [_unit_major(model.res_stack.Conv1d_0.kernel[0])[None], *blocks(model.res_stack, lambda i: i in used)]
    for l in reversed(range(model.n_latents)):
        prior = getattr(model, f"prior_{l}")
        mu, sd = prior.MLP_0, prior.MLP_1
        stages += [torch.cat([_unit_major(getattr(mu, f"Dense_{i}").kernel),
                              _unit_major(getattr(sd, f"Dense_{i}").kernel)])[None] for i in range(2)]
        stages.append(torch.stack([_unit_major(mu.Dense_2.kernel), _unit_major(sd.Dense_2.kernel)]))
    stages += [_unit_major(model.out_transform.Conv1d_0.kernel[0])[None], *blocks(model.out_transform, lambda i: True)]
    return [w.detach().float() for w in stages]


def pack_stcn_stream(stages: List[torch.Tensor], NB: int):
    """Each CTA's weight stream (``(NB, floats)``): stage after stage, CTA c's chunk holds the columns of its units
    u = c + NB w (warp w), ``[w][dot][K]``, every CTA's chunk as long as the widest's (zeros past U). Returns
    ``(stream, offsets)``, ``offsets`` the n_stages + 1 chunk boundaries in floats."""
    chunks, offsets = [], [0]
    for w in stages:
        ndot, U, K = w.shape
        nmax = -(-U // NB)
        padded = F.pad(w, (0, 0, 0, NB * nmax - U)).reshape(ndot, nmax, NB, K)
        chunks.append(padded.permute(2, 1, 0, 3).reshape(NB, nmax * ndot * K))
        offsets.append(offsets[-1] + chunks[-1].shape[1])
    return torch.cat(chunks, dim=1).contiguous(), offsets


def stcn_layout(offsets: List[int], B: int, head_floats: int):
    """K12's shared-memory split: ``(resident_floats, slot_floats)``, the longest prefix of whole chunks that fits
    beside the input rows, the prefetched old rows, the head and (unless every chunk fits) a ring of K12_RING slots
    of the widest chunk."""
    fixed = 16 + 2 * B * K12_KMAX + B * K12_KMAX // 2 + 2 * B * K12_MAX_D + head_floats
    budget = SMEM_OPTIN // 4 - fixed
    if offsets[-1] <= budget:
        return offsets[-1], 0
    slot = max(b - a for a, b in zip(offsets, offsets[1:]))
    if budget < K12_RING * slot:
        raise ValueError(f"the stcn_decode kernel's ring of {K12_RING} chunks of {slot} floats does not fit in shared "
                         f"memory beside B = {B} rows")
    return max(o for o in offsets if o <= budget - K12_RING * slot), slot


def _tagged(values: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """f32 ``values`` as tagged words (csrc/decode_common.cuh): the float's bits low, the tag high, int64."""
    bits = values.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (bits | (tags.to(torch.int64) << 32)).contiguous()


class STCNDecoder:
    """The frame loop of one STCN fast generation on the card (K12), primed by ``enc_tails``
    (each encoder block's last ``dilation`` input frames, ``(B, d, C)``) and ``dec_tails``
    (each decode block's last input frame, ``(B, 1, C)``), from ``STCN._prime``.

    The weights are laid out once a generation as each CTA's stream (:func:`pack_stcn_stream`,
    one CTA an SM, at most C of them), the encoder's circular buffers lie one after the other
    at their own lengths (155 frames at five stacks of dilations 1 .. 16, where JAX pads every
    buffer to 16). :meth:`run` launches ``csrc/stcn_decode.cu`` once a generation, frame 0 in
    its d-column mode, and reads its status word once after the launch. It raises on a model,
    tensor or width the kernel does not take: the windowed path serves those. The plain twin
    of the loop is ``STCN._generate_fast_plain``."""

    def __init__(self, model, enc_tails: List[torch.Tensor], dec_tails: List[torch.Tensor]):
        device = model.causal.Conv1d_0.kernel.device
        if device.type != "cuda":
            raise ValueError(f"the stcn_decode kernel runs on CUDA tensors; the model lies on {device}")
        C, half = model.res_channels, model.res_stack.blocks[0].gate_kernel_t.shape[-1]
        S = model.res_stack.blocks[0].skip_channels
        n_enc, n_dec, n_lat = len(model.res_stack.blocks), len(model.out_transform.blocks), model.n_latents
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
        NB = min(torch.cuda.get_device_properties(device).multi_processor_count, C)
        if (n_lat > K12_MAX_LAT or n_enc > K12_MAX_ENC or n_dec > K12_MAX_DEC or 2 * C > K12_KMAX or half > K12_KMAX
                or Z > K12_KMAX or S + max(model.latent_size) > K12_KMAX
                or any(w % 4 for w in (C, half, S, *model.latent_size))
                or max(half, C + S, 2 * C, Z) > NB * (K12_WARPS - 1)):
            raise ValueError(f"the stcn_decode kernel takes <= {K12_MAX_LAT} levels, <= {K12_MAX_ENC} encoder and "
                             f"<= {K12_MAX_DEC} decode blocks, products <= {K12_KMAX} deep and <= {K12_WARPS - 1} units "
                             f"a CTA, every width a multiple of 4; got C={C}, half={half}, S={S}, "
                             f"latent_size={model.latent_size}")
        B = enc_tails[0].shape[0]
        dilations = [b.dilation for b in model.res_stack.blocks]
        if ([tuple(t.shape) for t in enc_tails] != [(B, d, C) for d in dilations]
                or [tuple(t.shape) for t in dec_tails] != [(B, 1, C)] * n_dec or not 1 <= B <= K12_MAX_B):
            raise ValueError(f"tails must be (B <= {K12_MAX_B}, dilation, C) a block; got "
                             f"{[tuple(t.shape) for t in enc_tails]} and {[tuple(t.shape) for t in dec_tails]}")
        with torch.no_grad():
            self.stream, offsets = pack_stcn_stream(stcn_stages(model), NB)
            up, lik = model.out_upsample.Dense_0, model.likelihood_module.Dense_0
            head_w = torch.cat([t.detach().float().reshape(-1) for t in (up.kernel, lik.kernel, up.bias, lik.bias)])
            self.head = F.pad(head_w, (0, -head_w.numel() % 4)).contiguous()
            resident, slot = stcn_layout(offsets, B, self.head.numel())
            self.layout = (ctypes.c_int * (len(offsets) + 4))(
                *offsets, self.stream.shape[1], resident, slot, self.head.numel())

            def level_biases(l):
                mu, sd = getattr(model, f"prior_{l}").MLP_0, getattr(model, f"prior_{l}").MLP_1
                return [torch.cat([getattr(mu, f"Dense_{i}").bias, getattr(sd, f"Dense_{i}").bias]) for i in range(2)] + [
                    torch.stack([mu.Dense_2.bias, sd.Dense_2.bias])]

            def gate_biases(stack):
                return torch.stack([torch.stack([b.gate_bias_t, b.gate_bias_s]) for b in stack.blocks])

            causal = model.causal.Conv1d_0
            self._biases = [t.detach().float().contiguous() for t in (
                causal.kernel[:, 0, :], causal.bias, model.res_stack.Conv1d_0.bias, gate_biases(model.res_stack),
                torch.stack([b.rs_bias for b in model.res_stack.blocks]), model.out_transform.Conv1d_0.bias,
                gate_biases(model.out_transform), torch.stack([b.rs_bias for b in model.out_transform.blocks]),
                *[b for l in range(n_lat) for b in level_biases(l)])]
        self.bias_ptrs = (ctypes.c_void_p * len(self._biases))(*(t.data_ptr() for t in self._biases))
        level_of = {block: l for l, block in enumerate(model.used_blocks)}
        self.geometry = (ctypes.c_int * (2 * n_enc + n_lat))(
            *dilations, *[level_of.get(i, -1) for i in range(n_enc)], *model.latent_size)
        self.used = list(model.used_blocks)
        self.enc_tails, self.dec_tails = enc_tails, dec_tails
        self.shape = (B, C, half, S, n_enc, n_dec, n_lat, head.num_mix, NB)
        prior = getattr(model, "prior_0")
        self.scalars = (model.inv_std, prior.beta, prior.epsilon, head.log_epsilon)
        self.device, self.Z = device, Z

    def run(self, x_last: torch.Tensor, d_cols0: List[torch.Tensor], n_frames: int, eps: torch.Tensor,
            keys: FrameKeys, use_mode: bool = False, record: bool = False, trace: Optional[torch.Tensor] = None):
        """Frames ``0 .. n_frames - 1`` in one launch: frame 0 from the encoder prime's columns
        ``d_cols0`` (one ``(B, 1, S)`` a level), the rest from the history's last frame ``x_last``
        ``(B,)``. ``eps`` ``(n_frames, B, Z)`` is the prior's noise; ``keys`` the sampler's stream
        (a Philox seed on the card, or uniforms). Returns ``(B, n_frames)`` float32, or with
        ``record`` also each frame's z ``(n_frames, B, Z)`` and DMoL parameters ``(n_frames, B,
        30)`` (logits, locs, clamped log-scales). ``trace``, an int64 tensor of 7 on the card,
        gathers the kernel's own account of the launch (``csrc/stcn_decode.cu``). The buffers
        start from the primes' tails on every call."""
        B, C, half, S, n_enc, n_dec, n_lat, M, NB = self.shape
        if x_last.shape != (B,) or [tuple(d.shape) for d in d_cols0] != [(B, 1, S)] * n_lat:
            raise ValueError(f"x_last must be ({B},) and d_cols0 {n_lat} x ({B}, 1, {S}); got {tuple(x_last.shape)}, "
                             f"{[tuple(d.shape) for d in d_cols0]}")
        if eps.shape != (n_frames, B, self.Z) or eps.dtype != torch.float32 or eps.device != self.device:
            raise ValueError(f"eps must be float32 ({n_frames}, {B}, {self.Z}) on {self.device}, got "
                             f"{eps.dtype}{tuple(eps.shape)} on {eps.device}")
        if trace is not None and (trace.shape != (7,) or trace.dtype != torch.int64 or trace.device != self.device):
            raise ValueError(f"trace must be an int64 (7,) tensor on {self.device}")
        random_ptrs = _random_ptrs(keys, n_frames, B, M, self.device, "stcn_decode")
        eps = eps.contiguous()
        dev = self.device
        x = torch.empty((B, n_frames + 1), dtype=torch.float32, device=dev)
        x[:, 0] = x_last
        enc_buf = torch.cat([t.float() for t in self.enc_tails], dim=1).contiguous()  # (B, sum(d), C)
        dec_buf = torch.stack([t[:, 0].float() for t in self.dec_tails]).contiguous()  # (Ld, B, C)
        # frame 0's columns, tagged as the [r | s] stage of each level's block writes them in frame 0
        d_tags = torch.tensor([3 + 2 * self.used[l] for l in range(n_lat)], device=dev)[:, None, None]
        dcol = _tagged(torch.stack([d[:, 0] for d in d_cols0]), d_tags.expand(n_lat, B, S))
        words = [torch.zeros(n, dtype=torch.int64, device=dev) for n in (
            B * C, B * half, B * C, B * half)] + [dcol] + [torch.zeros(n, dtype=torch.int64, device=dev) for n in (
                B * 2 * C, B * 2 * C, B * self.Z, B * S)]
        barrier = torch.zeros(1, dtype=torch.int32, device=dev)
        status = torch.zeros(1, dtype=torch.int32, device=dev)
        z_out = torch.empty((n_frames, B, self.Z), dtype=torch.float32, device=dev) if record else None
        params_out = torch.empty((n_frames, B, 3 * M), dtype=torch.float32, device=dev) if record else None
        state = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in (enc_buf, dec_buf, x, *words, barrier)))
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (self.stream, self.head, eps)]
        ptrs += [ctypes.c_void_p(p) for p in random_ptrs]
        ptrs += [ctypes.c_void_p(t.data_ptr() if t is not None else None) for t in (z_out, params_out, trace, status)]
        scalars = [ctypes.c_float(v) for v in (*self.scalars, *UNIFORM_MAPS)]
        lib = cuda.library()
        cuda.count_launch("stcn_decode")
        cuda.check(lib.blvm_stcn_decode(self.bias_ptrs, self.geometry, self.layout, state, *ptrs, B, C, half, S,
                                        n_enc, n_dec, n_lat, M, NB, n_frames, int(use_mode), *scalars,
                                        ctypes.c_longlong(WAIT_LIMIT_NS), ctypes.c_void_p(cuda.stream_handle(x))),
                   "stcn_decode")
        _raise_on_status(status, "stcn_decode")
        return (x[:, 1:], z_out, params_out) if record else x[:, 1:]
