"""Frame-stacked autoregressive LSTM over waveforms (port of ``blvm_tpu/models/lstm.py``).

The waveform is stacked into ``stack_size``-frame vectors, embedded by a 3-layer
ReLU MLP, run through a (stacked) LSTM (K5 on the card), decoded by a 3-layer ReLU
MLP into ``3 * num_mix * stack_size`` values, unstacked into per-frame DMoL
parameters, and scored against the *next* stack (K2); the loss is the masked
``-log p`` over ``sum(x_sl)``. As in the JAX package, the post-LSTM dropout is
applied (the reference discarded it) and the carried state is always ``s_n``.
"""

from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from blvm_tpu_torch.evaluation.metrics import BitsPerDimMetric, LLMetric, LossMetric, drop_padded_rows
from blvm_tpu_torch.models.base import BaseModel
from blvm_tpu_torch.modules.common import MLP
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense
from blvm_tpu_torch.modules.recurrent import LSTM
from blvm_tpu_torch.ops.likelihoods import at_least_f32
from blvm_tpu_torch.ops.sequence import sequence_mask, stack_tensor
from blvm_tpu_torch.ops.variational import FrameKeys


class LSTMAudio(BaseModel):
    """Keyword arguments and defaults are the flax ``LSTMAudio``'s fields; ``unroll``
    only schedules XLA and is ignored."""

    def __init__(self, stack_size: int = 64, hidden_size: int = 256, num_layers: int = 1, dropout: float = 0.0,
                 num_mix: int = 10, num_bins: int = 256, bf16: bool = False, unroll: int = 1, device=None):
        super().__init__(stack_size=stack_size, hidden_size=hidden_size, num_layers=num_layers, dropout=dropout,
                         num_mix=num_mix, num_bins=num_bins, bf16=bf16, unroll=unroll)
        self.stack_size, self.hidden_size, self.num_layers = stack_size, hidden_size, num_layers
        self.dropout, self.num_mix, self.num_bins, self.bf16 = dropout, num_mix, num_bins, bf16
        dtype = torch.bfloat16 if bf16 else None
        H = hidden_size
        self.embedding = MLP(stack_size, [H] * 3, activation=F.relu, dtype=dtype, device=device)
        self.lstm = LSTM(H, H, num_layers=num_layers, dropout=dropout, dtype=dtype, device=device)
        # the reference applies ReLU after the decoder's last layer too (lstm.py:63)
        self.decoder = MLP(H, [H, H, 3 * num_mix * stack_size], activation=F.relu, device=device)
        self.likelihood = DiscretizedLogisticMixtureDense(3 * num_mix, y_dim=1, num_mix=num_mix, num_bins=num_bins,
                                                          device=device)

    def forward(
        self,
        x: torch.Tensor,  # (B, T) waveform in [-1, 1]
        x_sl: torch.Tensor,  # (B,)
        s_0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``(loss, mets, outputs)``. Dropout (``self.training``) and the reconstruction
        sample draw from ``generator``."""
        B = x.shape[0]
        S, M = self.stack_size, self.num_mix
        x_sl_stack = torch.ceil(x_sl / S).to(torch.int32)

        x_stack, _ = stack_tensor(x, S, axis=-1)  # (B, T', S)
        T_stack = x_stack.shape[1]
        x_input = x_stack[:, :-1]
        x_target = x_stack[:, 1:].detach().reshape(B, -1)  # (B, (T' - 1) S)

        e_stack = self.embedding(x_input)
        lstm_mask = sequence_mask(x_sl_stack - 1, max_len=T_stack - 1)
        h, s_n = self.lstm(e_stack, mask=lstm_mask, initial_state=s_0, deterministic=not self.training,
                           generator=generator)
        if self.dropout and self.training:
            keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - self.dropout
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)

        h = at_least_f32(h)  # the likelihood surface stays at least f32
        o = self.decoder(h).reshape(B, (T_stack - 1) * S, 3 * M)
        parameters = self.likelihood(o)
        sample, mode = self.likelihood.sample_and_mode(generator, parameters)

        # the reference's mask: x_sl clipped to the target length of an exactly padded batch,
        # (ceil(max(x_sl) / S) - 1) S (lstm.py:111-113), so the loss does not depend on the bucket
        t_max_stack = torch.ceil(x_sl.max() / S).to(torch.int32)
        eff_len = torch.minimum(x_sl, (t_max_stack - 1) * S)
        seq_mask = sequence_mask(eff_len, max_len=x_target.shape[1], dtype=torch.float32)
        log_prob = self.likelihood.log_prob(x_target[..., None], parameters)  # (B, (T' - 1) S)
        log_prob = (log_prob * seq_mask).sum(dim=1)
        loss = -log_prob.sum() / x_sl.sum()

        mets = dict(loss=loss, log_prob=log_prob, x_sl=x_sl)
        outputs = SimpleNamespace(loss=loss, ll=log_prob, z=h, z_sl=x_sl_stack, reconstruction_sample=sample,
                                  reconstruction_mode=mode, s_n=s_n)
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

    def generate(self, n_samples: int = 1, max_timesteps: int = 100, use_mode: bool = False,
                 x: Optional[torch.Tensor] = None, s_0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None, uniforms=None):
        """Ancestral rollout over ``max_timesteps`` stacks: embed the current stack, one
        LSTM step (one K5 launch with T = 1 a layer on the card), decode, the head, and
        one DMoL draw for the next stack (one K3 launch), fed back. Returns ``((x
        (B, max_timesteps * stack_size), x_sl (B,)), SimpleNamespace())`` as JAX does.

        ``x`` primes the rollout with one ``(B or 1, stack_size)`` stack (zeros, the
        mu-law origin, when None); ``s_0`` is the initial state (zeros). ``use_mode``
        takes each stack's DMoL mode instead of a sample. ``uniforms``, ``(u_cat (n, B,
        M), u_log (n, B, 1))`` with ``n = max_timesteps * stack_size`` frames, replace the
        sampler's draws (:class:`FrameKeys`), so two paths can be compared sample for sample.
        """
        S, H = self.stack_size, self.hidden_size
        device = self.lstm.w_hh_0.device
        if x is None:
            x = torch.zeros((n_samples, S), dtype=torch.float32, device=device)
        else:
            x = x.to(device, torch.float32)
            if x.shape[0] == 1 and n_samples > 1:
                x = x.expand(n_samples, S)
        B = x.shape[0]
        if s_0 is None:
            s_0 = (torch.zeros((self.num_layers, B, H), dtype=torch.float32, device=device),) * 2
        keys = FrameKeys(generator, device, uniforms)
        if keys.uniforms is not None and keys.uniforms[0].shape[:2] != (max_timesteps * S, B):
            raise ValueError(f"uniforms must be ({max_timesteps * S}, {B}, M), got {tuple(keys.uniforms[0].shape)}")
        stacks, state = [], s_0
        with torch.no_grad():
            for step in range(max_timesteps):
                e = self.embedding(x)  # (B, H)
                h, state = self.lstm(e[:, None, :], initial_state=state)
                o = self.decoder(at_least_f32(h)).reshape(B, S, 3 * self.num_mix)
                params = self.likelihood(o)
                if use_mode:
                    x = self.likelihood.mode(params)
                else:
                    x = self.likelihood.rsample(keys.generator, params, **keys.at(step, S))
                x = x.reshape(B, S)
                stacks.append(x)
        x_out = torch.cat(stacks, dim=1) if stacks else torch.zeros((B, 0), device=device)
        x_sl = torch.full((B,), x_out.shape[1], dtype=torch.int32, device=device)
        return (x_out, x_sl), SimpleNamespace()

    def split_sequence_args(self):
        """Chunk geometry of the chunked test pass: no overlap, strideable by stack."""
        return dict(overlap=0, mode="consume")

    def example_inputs(self):
        device = self.lstm.w_hh_0.device
        x = torch.zeros((1, 4 * self.stack_size), dtype=torch.float32, device=device)
        x_sl = torch.full((1,), 4 * self.stack_size, dtype=torch.int32, device=device)
        return (x, x_sl), {"generator": None}
