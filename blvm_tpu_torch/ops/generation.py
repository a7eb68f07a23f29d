"""K4: the Fast-WaveNet frame loop on the card (port of the frame loop of
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
"""

import ctypes
from typing import List

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

