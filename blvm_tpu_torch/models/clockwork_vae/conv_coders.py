"""Multi-level strided convolutional coders of the Clockwork-VAE (port of
``blvm_tpu/models/clockwork_vae/conv_coders.py``), channels-last ``(B, T, C)``.

* ``BlockSeparable``: a 1x1 expansion (x4, with bias), then the depthwise chain (ReLU, per-channel GroupNorm, the
  depthwise conv strided or transposed, + bias, ReLU, per-channel GroupNorm) that is K11 on the card
  (:func:`blvm_tpu_torch.ops.depthwise.depthwise_norm`), then the pointwise 1x1 back (no bias), added to the block's
  input resampled to its length (:func:`temporal_residual_add`).
* ``ConvCoder1d``: levels of blocks whose strides factor each level's stride into ``stride_per_block`` pieces
  (:meth:`ConvCoder1d.level_geometry`, which refuses what the JAX package refuses), per-level 1x1 in and out
  projections; the transposed coder runs each level's blocks in reverse order and pads after them, where a negative
  padding crops.

Parameters keep the flax names (``levels_{l}_{b}/Conv1d_0/kernel``, ``levels_{l}_{b}/GroupNorm_0/scale``,
``levels_{l}_{b}/_DepthwiseSeparable_0/depthwise_kernel``, ``in_proj_{l}``, ``out_proj_{l}``, ...). The JAX
package's ``BlockSimple`` block, which ``CWVAEAudio`` never builds, is not ported (``block_type="BlockSimple"``
raises ``NotImplementedError``); nor are bf16 coders.
"""

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from blvm_tpu_torch.models.wavenet.modules import Conv1d
from blvm_tpu_torch.modules.common import torch_uniform_
from blvm_tpu_torch.ops.conv_arithmetic import compute_conv_attributes_single
from blvm_tpu_torch.ops import depthwise as depthwise_ops
from blvm_tpu_torch.ops.padding import pad_axis


class GroupNorm(nn.Module):
    """flax's ``GroupNorm(num_groups=C, epsilon=1e-5)`` parameters, ``scale`` ones and ``bias`` zeros at init; the
    block's chain (K11) applies them."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))


class _DepthwiseSeparable(nn.Module):
    """The depthwise conv ``(k, 1, C)`` with its bias, a GroupNorm and the pointwise 1x1 (no bias): the parameters of
    ``conv_coders.py:55-88``, whose chain :class:`BlockSeparable` runs through K11."""

    def __init__(self, channels: int, out_channels: int, kernel_size: int, device=None):
        super().__init__()
        self.depthwise_kernel = nn.Parameter(torch.empty(kernel_size, 1, channels, device=device))
        self.depthwise_bias = nn.Parameter(torch.zeros(channels, device=device))
        self.GroupNorm_0 = GroupNorm(channels, device=device)
        self.Conv1d_0 = Conv1d(channels, out_channels, kernel_size=1, use_bias=False, device=device)
        torch_uniform_(self.depthwise_kernel, kernel_size)


def temporal_residual_add(x: torch.Tensor, x_residual: torch.Tensor) -> torch.Tensor:
    """``TemporalResidual.add`` (``conv_coders.py:99-107``): ``x_residual + x``, with ``x`` resampled to
    ``x_residual``'s length by torch's nearest rule, the exact integer ``floor(i t_in / t_out)``, where they differ."""
    if x_residual.shape[1] == x.shape[1]:
        return x_residual + x
    t_in, t_out = x.shape[1], x_residual.shape[1]
    idx = (torch.arange(t_out, device=x.device) * t_in) // t_out
    return x_residual + x[:, idx]


class BlockSeparable(nn.Module):
    """``conv_coders.py:110-134``: 1x1 expansion to ``channels_factor * channels_bottleneck``, the depthwise chain
    (K11 on the card) and the pointwise 1x1 back, plus the temporal residual."""

    def __init__(self, channels_bottleneck: int, kernel_size: int, stride: int, dilation: int, transposed: bool,
                 channels_factor: int = 4, use_bias: bool = True, device=None):
        super().__init__()
        self.stride, self.dilation, self.transposed = stride, dilation, transposed
        channels_block = channels_factor * channels_bottleneck
        self.Conv1d_0 = Conv1d(channels_bottleneck, channels_block, kernel_size=1, use_bias=use_bias, device=device)
        self.GroupNorm_0 = GroupNorm(channels_block, device=device)
        self._DepthwiseSeparable_0 = _DepthwiseSeparable(channels_block, channels_bottleneck, kernel_size,
                                                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ds = self._DepthwiseSeparable_0
        z = depthwise_ops.depthwise_norm(self.Conv1d_0(x), self.GroupNorm_0.scale, self.GroupNorm_0.bias,
                                         ds.depthwise_kernel, ds.depthwise_bias, ds.GroupNorm_0.scale,
                                         ds.GroupNorm_0.bias, stride=self.stride, dilation=self.dilation,
                                         transposed=self.transposed)
        return temporal_residual_add(x, ds.Conv1d_0(z))


class ConvCoder1d(nn.Module):
    """Multi-level conv encoder or decoder with receptive-field bookkeeping (``conv_coders.py:167-341``)."""

    def __init__(self, strides: Sequence[int], channels: int = 128, kernel_size: int = 5, stride_per_block: int = 2,
                 dilation_factor: int = 1, num_blocks: int = 8,
                 channels_in: Union[int, Sequence[Optional[int]], None] = None,
                 channels_out: Union[int, Sequence[Optional[int]], None] = None, transposed: bool = False,
                 block_type: str = "BlockSeparable", device=None):
        super().__init__()
        if block_type != "BlockSeparable":
            if block_type == "BlockSimple":
                raise NotImplementedError("the CW-VAE coders' BlockSimple is not ported to blvm_tpu_torch (CWVAEAudio "
                                          "builds BlockSeparable only)")
            raise KeyError(block_type)
        self.strides, self.channels, self.kernel_size = tuple(strides), channels, kernel_size
        self.stride_per_block, self.dilation_factor, self.num_blocks = stride_per_block, dilation_factor, num_blocks
        self.channels_in, self.channels_out, self.transposed = channels_in, channels_out, transposed
        per_level_strides, _, _ = self.level_geometry(self.strides, kernel_size, stride_per_block, num_blocks,
                                                      dilation_factor)
        self.levels: List[List[BlockSeparable]] = []
        for l, block_strides in enumerate(per_level_strides):
            blocks = [BlockSeparable(channels, kernel_size, s, d, transposed, device=device) for s, d in block_strides]
            if transposed:
                blocks = blocks[::-1]  # strides applied in reverse; flax names the blocks in this order
            for b, block in enumerate(blocks):
                self.add_module(f"levels_{l}_{b}", block)
            self.levels.append(blocks)
        self.in_projs, self.out_projs = {}, {}
        for l, c in enumerate(self._channels_in_list()):
            if c is not None:
                self.in_projs[l] = Conv1d(c, channels, kernel_size=1, device=device)
                self.add_module(f"in_proj_{l}", self.in_projs[l])
        for l, c in enumerate(self._channels_out_list()):
            if c is not None:
                self.out_projs[l] = Conv1d(channels, c, kernel_size=1, device=device)
                self.add_module(f"out_proj_{l}", self.out_projs[l])

    @staticmethod
    def level_geometry(strides, kernel_size, stride_per_block, num_blocks, dilation_factor=1):
        """Per level ``(block_strides [(stride, dilation)], receptive_field, overall_receptive_field)``; refuses, as
        the JAX package does, strides that ``num_blocks`` blocks of ``stride_per_block`` cannot reach
        (``AssertionError``) or cannot factor (``ValueError``)."""
        if not all(stride_per_block**num_blocks >= s for s in strides):
            raise AssertionError(f"Not enough blocks per level for {strides=}")
        per_level_strides, rfs, overall_rfs = [], [], []
        overall_stride_in, overall_rf_in = 1, 1
        for l in range(len(strides)):
            remaining = strides[l]
            block_strides = []
            stride_in, rf_in = 1, 1
            for b in range(num_blocks):
                dilation = dilation_factor**b
                if remaining >= stride_per_block:
                    s = stride_per_block
                    remaining //= stride_per_block
                else:
                    if remaining != 1:
                        raise ValueError(f"remaining stride {remaining} is not 1 at level {l}, block {b}.")
                    s = 1
                block_strides.append((s, dilation))
                a = compute_conv_attributes_single(1, kernel_size, 0, s, dilation, overall_stride_in, overall_rf_in)
                overall_stride_in, overall_rf_in = a.stride, a.receptive_field
                a = compute_conv_attributes_single(1, kernel_size, 0, s, dilation, stride_in, rf_in)
                stride_in, rf_in = a.stride, a.receptive_field
            per_level_strides.append(block_strides)
            rfs.append(rf_in)
            overall_rfs.append(overall_rf_in)
        return per_level_strides, rfs, overall_rfs

    def _geometry(self):
        return self.level_geometry(self.strides, self.kernel_size, self.stride_per_block, self.num_blocks,
                                   self.dilation_factor)

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def receptive_fields(self) -> List[int]:
        return self._geometry()[1]

    @property
    def overall_receptive_fields(self) -> List[int]:
        return self._geometry()[2]

    @property
    def overall_receptive_field(self) -> int:
        return self.overall_receptive_fields[-1]

    def _channels_in_list(self):
        if self.channels_in is None:
            return [None] * self.num_levels
        if isinstance(self.channels_in, int):
            return [self.channels_in] + [None] * (self.num_levels - 1)
        return list(self.channels_in)

    def _channels_out_list(self):
        if self.channels_out is None:
            return [None] * self.num_levels
        if isinstance(self.channels_out, int):
            return [self.channels_out] * self.num_levels
        return list(self.channels_out)

    @property
    def e_size(self) -> List[int]:
        return [c if c is not None else self.channels for c in self._channels_out_list()]

    def pad_level(self, hidden: torch.Tensor, pad_left: int, pad_right: int) -> torch.Tensor:
        """Pad the time axis on the right and left (crop, when transposed)."""
        if not pad_left and not pad_right:
            return hidden
        if self.transposed:
            pad_left, pad_right = -pad_left, -pad_right
        return pad_axis(hidden, pad_left, pad_right, axis=1)

    def forward_level(self, hidden: torch.Tensor, level: int, pad_left: int = 0, pad_right: int = 0):
        """One level: in-projection and ReLU, [pad], blocks, [pad], out-projection and ReLU: ``(hidden,
        encoding)``, the encoding the out-projected hidden (the hidden itself without an out-projection)."""
        if level in self.in_projs:
            hidden = torch.relu(self.in_projs[level](hidden))
        if not self.transposed:
            hidden = self.pad_level(hidden, pad_left, pad_right)
        for block in self.levels[level]:
            hidden = block(hidden)
        if self.transposed:
            hidden = self.pad_level(hidden, pad_left, pad_right)
        encoding = torch.relu(self.out_projs[level](hidden)) if level in self.out_projs else hidden
        return hidden, encoding

    def forward(self, hidden: torch.Tensor, pad_left: Optional[List[int]] = None,
                pad_right: Optional[List[int]] = None) -> List[torch.Tensor]:
        """Every level in turn; returns the per-level encodings ``(B, T_l, C)``."""
        pad_left = pad_left or [0] * self.num_levels
        pad_right = pad_right or [0] * self.num_levels
        encodings = []
        for level in range(self.num_levels):
            hidden, encoding = self.forward_level(hidden, level, pad_left[level], pad_right[level])
            encodings.append(encoding)
        return encodings
