"""WaveNet likelihood model (port of ``blvm_tpu/models/wavenet/wavenet.py``).

Same forward geometry as the JAX model: optional frame stacking, left-pad by the
receptive field, causal conv (drop last frame), residual stack with skips sliced
to the output region, skips summed in f32 in block order and scaled by
``variance_scale``, pointwise head, DMoL likelihood. The residual stack runs one fused
call a stack (P2, ``ops/wavenet_stack.py``) where its blocks allow it.

Kept quirk of the reference: ``variance_scale = sqrt(1/n_stacks * n_layers)``,
which operator precedence makes ``sqrt(n_layers/n_stacks)``.

``generate`` is ancestral sampling, fast (Fast-WaveNet: per-block circular
buffers; on CUDA its frame loop is the K4 kernel, ``ops/generation.py``) or
windowed (the oracle: the stacks over the receptive-field window, P3, and K3 a frame).
The embedding input is not ported yet.
"""

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from blvm_tpu_torch.evaluation.metrics import BitsPerDimMetric, LLMetric, LossMetric, drop_padded_rows
from blvm_tpu_torch.models.base import BaseModel
from blvm_tpu_torch.models.wavenet.modules import CausalConv1d, PointwiseTransform, ResidualStack
from blvm_tpu_torch.modules.distributions import get_likelihood_head
from blvm_tpu_torch.ops.generation import WaveNetDecoder
from blvm_tpu_torch.ops.padding import get_modulo_length
from blvm_tpu_torch.ops.sequence import sequence_mask, split_sequence, stack_tensor
from blvm_tpu_torch.ops.variational import FrameKeys


class InputSizeError(Exception):
    def __init__(self, input_size, receptive_field):
        message = "Input size has to be larger than receptive_field\n"
        message += f"Input size: {input_size}, Receptive fields size: {receptive_field}"
        super().__init__(message)


class WaveNet(BaseModel):
    """Keyword arguments and defaults are the flax ``WaveNet``'s fields.
    ``remat`` and ``fuse_gate_dots`` only schedule XLA and are ignored."""

    def __init__(
        self,
        likelihood: str = "DMoL",
        in_channels: int = 1,
        embedding_dim: Optional[int] = None,
        num_bins: int = 256,
        num_mix: int = 10,
        n_layers: int = 10,
        n_stacks: int = 5,
        res_channels: int = 512,
        skip_channels: Optional[int] = None,
        gate_channels: Optional[int] = None,
        kernel_size: int = 2,
        base_dilation: int = 2,
        n_stack_frames: int = 1,
        remat: bool = False,
        bf16: bool = False,
        fuse_gate_dots: bool = False,
        device=None,
    ):
        super().__init__(
            likelihood=likelihood, in_channels=in_channels, embedding_dim=embedding_dim, num_bins=num_bins,
            num_mix=num_mix, n_layers=n_layers, n_stacks=n_stacks, res_channels=res_channels,
            skip_channels=skip_channels, gate_channels=gate_channels, kernel_size=kernel_size,
            base_dilation=base_dilation, n_stack_frames=n_stack_frames, remat=remat, bf16=bf16,
            fuse_gate_dots=fuse_gate_dots,
        )
        if embedding_dim is not None:
            raise NotImplementedError("the embedding input (categorical WaveNet) is not ported yet")
        self.likelihood = likelihood
        self.in_channels, self.num_bins, self.num_mix = in_channels, num_bins, num_mix
        self.n_layers, self.n_stacks, self.res_channels = n_layers, n_stacks, res_channels
        self.kernel_size, self.base_dilation, self.n_stack_frames = kernel_size, base_dilation, n_stack_frames
        self.bf16 = bf16
        # reference precedence quirk: sqrt(1/n_stacks * n_layers) == sqrt(n_layers/n_stacks)
        self.variance_scale = math.sqrt(1 / n_stacks * n_layers)

        in_features = in_channels * n_stack_frames
        self.causal = CausalConv1d(in_features, res_channels, kernel_size=kernel_size, device=device)
        self.res_stack = ResidualStack(
            n_layers=n_layers, n_stacks=n_stacks, res_channels=res_channels, skip_channels=skip_channels,
            gate_channels=gate_channels, kernel_size=kernel_size, base_dilation=base_dilation,
            dtype=torch.bfloat16 if bf16 else None, device=device,
        )
        skip = skip_channels or res_channels
        self.out_transform = PointwiseTransform(skip, res_channels * n_stack_frames, device=device)
        self.likelihood_head = get_likelihood_head(likelihood, res_channels, y_dim=1, num_mix=num_mix,
                                                   num_bins=num_bins, device=device)

    @property
    def receptive_field(self) -> int:
        return (
            ResidualStack.compute_receptive_fields(self.n_layers, self.n_stacks, self.kernel_size, self.base_dilation)[-1]
            + self.kernel_size
            - 1
        )

    def compute_loss(self, y, x_sl, parameters):
        """Masked negative log-likelihood normalized by the sum of ``x_sl``."""
        seq_mask = sequence_mask(x_sl, max_len=y.shape[1], dtype=torch.float32)  # (B, T)
        log_prob_twise = self.likelihood_head.log_prob(y, parameters) * seq_mask  # (B, T)
        log_prob = log_prob_twise.reshape(y.shape[0], -1).sum(dim=1)  # (B,)
        loss = -log_prob.sum() / x_sl.sum()
        return loss, log_prob, log_prob_twise

    def _skip_sum(self, skips):
        """``sum(at_least_f32(s) for s in skips) * variance_scale``: a list of skips is
        accumulated in place into one f32 tensor (the same additions in the same order,
        without a widened copy of every skip); the fused stacks' f32 sum is scaled in place."""
        if isinstance(skips, torch.Tensor):
            summed = skips
        else:
            summed = skips[0].to(torch.promote_types(skips[0].dtype, torch.float32), copy=True)
            for s in skips[1:]:
                summed += s
        summed *= self.variance_scale
        return summed

    def _network(self, x, skip_size: int, pad_causal: bool):
        """Causal conv -> residual stack -> scaled f32 skip sum (in block order) -> head.
        Returns ``(logits, z)``, ``z`` every 5th block's skip (reference wavenet.py:215).
        A fused stack (k = 2, skip = res, gate = 2 res) runs one ``wavenet_stack`` call a
        stack, which sums the skips itself; else one block call a block."""
        output = self.causal(x, pad_causal=pad_causal)
        if self.res_stack.fused:
            summed, z = self.res_stack.forward_summed(output, skip_size, taps=range(0, len(self.res_stack.blocks), 5))
        else:
            summed = self.res_stack(output, skip_size)
            z = summed[::5]
        return self.out_transform(self._skip_sum(summed)), z

    def forward(
        self,
        x: torch.Tensor,  # (B, T) or (B, T, C), values in [-1, 1]
        x_sl: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        pad_causal: bool = True,
        pad_receptive_field: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        if y is None:
            y = x.detach()
            if not pad_receptive_field:
                y = y[:, self.receptive_field * self.n_stack_frames :]

        x_sl_strided = torch.ceil(x_sl / self.n_stack_frames).to(torch.int32)
        if self.n_stack_frames > 1:
            x, p = stack_tensor(x, self.n_stack_frames, axis=1)
        else:
            p = 0
        x = x[..., None] if x.ndim == 2 else x  # (B, T, 1)
        y = y[..., None] if y.ndim == 2 else y

        T = x.shape[1]
        if pad_receptive_field:
            skip_size = T
            x = F.pad(x, (0, 0, self.receptive_field, 0))
        else:
            skip_size = T - self.receptive_field
            # x_sl is in the sample domain; clamp so inactive rows (length 0 from
            # chunking) stay 0 and keep the loss denominator clean
            x_sl = torch.clamp(x_sl - self.n_stack_frames * self.receptive_field, min=0)

        if x.shape[1] - int(pad_causal) < self.receptive_field:
            raise InputSizeError(x.shape[1], self.receptive_field)

        logits, z = self._network(x, skip_size, pad_causal)

        if self.n_stack_frames > 1:
            B, Ts, _ = logits.shape
            logits = logits.reshape(B, Ts * self.n_stack_frames, self.res_channels)
            if p:
                logits = logits[:, :-p]

        parameters = self.likelihood_head(logits)
        predictions, predictions_mode = self.likelihood_head.sample_and_mode(generator, parameters)

        loss, log_prob, log_prob_twise = self.compute_loss(y, x_sl, parameters)

        mets = dict(loss=loss, log_prob=log_prob, x_sl=x_sl)
        outputs = SimpleNamespace(
            loss=loss,
            log_prob=log_prob,
            log_prob_twise=log_prob_twise,
            parameters=parameters,
            z=z,
            z_sl=x_sl_strided,
            y=y,
            predictions=predictions,
            predictions_mode=predictions_mode,
        )
        return loss, mets, outputs

    @staticmethod
    def build_metrics(mets: dict):
        mets = drop_padded_rows(mets)
        log_prob = mets["log_prob"]
        return [
            LossMetric(mets["loss"], weight_by=int(np.asarray(log_prob).shape[0])),
            LLMetric(log_prob),
            BitsPerDimMetric(log_prob, reduce_by=mets["x_sl"]),
        ]

    def split_sequence(self, x, x_sl, length: int):
        """Chunk a long (numpy) sequence for evaluation; the overlap is the full
        receptive field (``blvm_tpu`` ``WaveNet.split_sequence``)."""
        overlap = self.receptive_field * self.n_stack_frames
        length = get_modulo_length(length, stride=self.n_stack_frames)
        mode = "extend" if overlap >= length else "consume"
        return split_sequence(x, x_sl, length=length, overlap=overlap, mode=mode)

    def forward_split(self, x, x_sl, i_split: int, y=None, generator: Optional[torch.Generator] = None):
        return self(x, x_sl, y=y, pad_causal=True, pad_receptive_field=(i_split == 0), generator=generator)

    def generate(self, n_samples: int, n_frames: int = 16000, x: Optional[torch.Tensor] = None, fast: bool = True,
                 generator: Optional[torch.Generator] = None, uniforms=None) -> torch.Tensor:
        """Ancestral sampling of ``n_samples`` sequences: ``(n_samples, n_frames)`` in [-1, 1].

        ``x`` is the history, ``(n_samples, T >= receptive_field, in_channels *
        n_stack_frames)`` (zeros when None). ``generator`` (on the model's device;
        None is PyTorch's default) drives the sampler; ``uniforms``, ``(u_cat
        (n_frames, B, M), u_log (n_frames, B, 1))`` in [0, 1), replace its draws
        frame by frame (:class:`FrameKeys`), so two paths can be compared sample for sample.

        As in the JAX package, ``fast`` with ``kernel_size == 2`` and one frame a step
        runs Fast-WaveNet: one windowed forward primes per-block circular buffers and
        samples frame 0, then each frame costs one column of every block. Its frame
        loop is the K4 kernel on CUDA (:class:`WaveNetDecoder`, which raises on a
        model it does not take) and :meth:`_generate_fast_plain` on the CPU. Otherwise
        the windowed path re-runs the network over the receptive field every step
        (the fused stacks, P3, and K3 on CUDA); with ``n_stack_frames = s`` a step emits ``s`` frames.
        """
        device = self.causal.Conv1d_0.kernel.device
        keys = FrameKeys(generator, device, uniforms)
        if keys.uniforms is not None and keys.uniforms[0].shape[:2] != (n_frames, n_samples):
            raise ValueError(f"uniforms must be ({n_frames}, {n_samples}, M), got {tuple(keys.uniforms[0].shape)}")
        with torch.no_grad():
            if fast and self.kernel_size == 2 and self.n_stack_frames == 1:
                x = self._history(n_samples, x, self.in_channels)
                tails, pred0 = self._prime(x, keys)
                if x.is_cuda:
                    return WaveNetDecoder(self, tails).run(x[:, -1, 0], pred0.reshape(-1), n_frames, keys)
                return self._generate_fast_plain(x[:, -1:], pred0, tails, n_frames, keys)
            return self._generate_naive(n_samples, n_frames, x, keys)

    def _history(self, n_samples: int, x: Optional[torch.Tensor], channels: int) -> torch.Tensor:
        device = self.causal.Conv1d_0.kernel.device
        if x is None:
            return torch.zeros((n_samples, self.receptive_field, channels), dtype=torch.float32, device=device)
        return x.to(device, torch.float32)

    def _prediction_to_input(self, pred: torch.Tensor) -> torch.Tensor:
        """A step's samples ``(B, s, 1)`` as one input frame ``(B, 1, s)`` (the layout of ``stack_tensor``)."""
        return pred.reshape(pred.shape[0], 1, -1)

    def _sample(self, parameters, keys: FrameKeys, step: int, frames: int = 1) -> torch.Tensor:
        return self.likelihood_head.rsample(keys.generator, parameters, **keys.at(step, frames))

    def _emit_frame(self, skips, keys: FrameKeys, step: int) -> torch.Tensor:
        """Skip sum -> head -> sample for a single output column, ``(B, 1, 1)``."""
        return self._sample(self.likelihood_head(self.out_transform(self._skip_sum(skips))), keys, step)

    def _prime(self, x: torch.Tensor, keys: FrameKeys):
        """One windowed forward over the history ``x``: each block's last ``dilation``
        input frames (the circular buffers' seeds) and frame 0, ``(tails, pred0 (B, 1, 1))``."""
        skips, tails = self.res_stack(self.causal(x, pad_causal=False), 1, collect_tails=True)
        return tails, self._emit_frame(skips, keys, 0)

    def _generate_fast_plain(self, x_last, pred0, tails, n_frames: int, keys: FrameKeys,
                             forced: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Fast-WaveNet frame loop in plain PyTorch, op for op the JAX step
        (``blvm_tpu/models/wavenet/wavenet.py:350-375``): the twin of K4.

        ``x_last`` ``(B, 1, 1)`` is the history's last frame, ``pred0`` ``(B, 1, 1)``
        frame 0, ``tails`` the primed buffers. Block parameters are cast to the stack
        dtype; the causal tap runs in f32 and is cast before ``in_transform``; the
        skip sum is f32, from zeros in block order; the head runs on ``acc *
        variance_scale`` in f32. Block i's buffer holds ``dilation_i`` frames and
        slot ``idx % dilation_i`` holds ``x[t - dilation_i]``. ``forced`` ``(B,
        n_frames)``, teacher forcing: the next step sees ``forced[:, f]`` as frame f
        instead of its own sample (the card's comparison with K4 holds each frame to
        the kernel's from the same history). Returns ``(B, n_frames)``.
        """
        dtype = torch.bfloat16 if self.bf16 else torch.float32
        blocks = self.res_stack.blocks
        half, R = blocks[0].gate_kernel_t.shape[-1], self.res_channels
        params = [
            (torch.cat([b.gate_kernel_t[0], b.gate_kernel_s[0]], dim=-1).to(dtype),  # old tap [tanh | sigmoid]
             torch.cat([b.gate_kernel_t[1], b.gate_kernel_s[1]], dim=-1).to(dtype),  # current tap
             torch.cat([b.gate_bias_t, b.gate_bias_s]).to(dtype), b.rs_kernel[0].to(dtype), b.rs_bias.to(dtype))
            for b in blocks
        ]
        in_kernel = self.res_stack.Conv1d_0.kernel[0].to(dtype)
        in_bias = self.res_stack.Conv1d_0.bias.to(dtype)
        ck, cb = self.causal.Conv1d_0.kernel, self.causal.Conv1d_0.bias  # (2, 1, C), (C,)
        buffers = [t.to(dtype, copy=True) for t in tails]
        inv_std = torch.tensor(math.sqrt(0.5), dtype=dtype)  # JAX's Python constant takes h's dtype
        B = pred0.shape[0]

        def fed(f, pred):
            return pred if forced is None else forced[:, f].reshape(B, 1, 1).to(pred)

        prev2, prev1 = x_last, fed(0, pred0)
        preds = [pred0]
        for idx in range(n_frames - 1):
            c = prev2 @ ck[0] + prev1 @ ck[1] + cb  # causal k=2 conv, (B, 1, C), f32
            h = c.to(dtype) @ in_kernel + in_bias
            acc = torch.zeros((B, 1, blocks[0].skip_channels), dtype=torch.float32, device=h.device)
            for (w_old, w_cur, b_gate, w_rs, b_rs), buf, block in zip(params, buffers, blocks):
                slot = idx % block.dilation
                old = buf[:, slot : slot + 1].clone()  # x[t - d]
                buf[:, slot : slot + 1] = h
                gate = old @ w_old + h @ w_cur + b_gate
                act = torch.tanh(gate[..., :half]) * torch.sigmoid(gate[..., half:])
                rs = act @ w_rs + b_rs
                h = (h + rs[..., :R]) * inv_std
                acc = acc + rs[..., R:].float()
            pred = self._sample(self.likelihood_head(self.out_transform(acc * self.variance_scale)), keys, idx + 1)
            preds.append(pred)
            prev2, prev1 = prev1, fed(idx + 1, pred)
        return torch.cat(preds, dim=1).reshape(B, -1)

    def _generate_naive(self, n_samples: int, n_frames: int, x: Optional[torch.Tensor], keys: FrameKeys):
        """Ancestral sampling with a FIFO receptive-field window: every step re-runs
        the whole window (the reference's semantics; the oracle of the fast path, and
        the path of frame-stacked or k != 2 models). A step emits ``n_stack_frames``
        frames, which enter the window as one stacked frame."""
        s = self.n_stack_frames
        window = self._history(n_samples, x, self.in_channels * s)
        preds = []
        for step in range(n_frames // s):
            logits, _ = self._network(window, skip_size=1, pad_causal=False)
            if s > 1:
                logits = logits.reshape(n_samples, s, self.res_channels)
            pred = self._sample(self.likelihood_head(logits), keys, step, s)  # (B, s, 1)
            preds.append(pred)
            window = torch.cat([window[:, 1:], self._prediction_to_input(pred)], dim=1)
        return torch.cat(preds, dim=1).reshape(n_samples, -1)
