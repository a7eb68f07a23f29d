"""WaveNet likelihood model (port of ``blvm_tpu/models/wavenet/wavenet.py``).

Same forward geometry as the JAX model: optional frame stacking, left-pad by the
receptive field, causal conv (drop last frame), residual stack with skips sliced
to the output region, skips summed in f32 in block order and scaled by
``variance_scale``, pointwise head, DMoL likelihood.

Kept quirk of the reference: ``variance_scale = sqrt(1/n_stacks * n_layers)``,
which operator precedence makes ``sqrt(n_layers/n_stacks)``.

``generate`` (ancestral sampling, kernel K4) and the embedding input are not
ported yet.
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
from blvm_tpu_torch.ops.padding import get_modulo_length
from blvm_tpu_torch.ops.sequence import sequence_mask, split_sequence, stack_tensor


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

    def _network(self, x, skip_size: int, pad_causal: bool):
        """Causal conv -> residual stack -> scaled f32 skip sum (in block order) -> head.

        The sum accumulates in place into one f32 tensor: the same additions in the
        same order as ``sum(at_least_f32(s) for s in skips)``, without a widened copy
        of every skip."""
        output = self.causal(x, pad_causal=pad_causal)
        skip_connections = self.res_stack(output, skip_size)
        first = skip_connections[0]
        summed = first.to(torch.promote_types(first.dtype, torch.float32), copy=True)
        for s in skip_connections[1:]:
            summed += s
        summed *= self.variance_scale
        logits = self.out_transform(summed)
        return logits, skip_connections

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

        logits, skip_connections = self._network(x, skip_size, pad_causal)

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
            z=skip_connections[::5],  # every 5th skip (reference wavenet.py:215)
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
