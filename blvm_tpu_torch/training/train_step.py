"""The training step on one device (port of ``blvm_tpu/parallel/train_step.py:make_train_step``).

Forward, loss, backward, optimizer chain and metric aggregation, eagerly: one
call of ``step(state, batch, scalars)`` updates ``state`` in place and returns
``(state, mets)``. With ``accum > 1`` the batch rows split into ``accum`` equal
microbatches whose gradients are weighted by ``loss_weight`` (the frames of each
microbatch for the audio models), so the one update is the full-batch update.
The microbatch weights are host numbers, so the loop over them never waits on the
device.
"""

from typing import Callable, Optional

import numpy as np
import torch

from blvm_tpu_torch.training.optim import global_norm
from blvm_tpu_torch.training.train_state import TrainState

MICROBATCH_SPAN = "train_step.microbatch"  # the torch.profiler span of one microbatch's forward and backward


def _split_rows(batch: dict, accum: int):
    """``accum`` microbatches of a batch of tensors, split on axis 0."""
    parts = {k: v.chunk(accum, dim=0) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def _host_weight(w) -> np.float32:
    """A microbatch's weight as a float32 host number, as JAX takes it (``jnp.asarray(w, jnp.float32)``).
    A tensor must lie on the CPU: reading one from the card would make the host wait on the device once
    a microbatch."""
    if isinstance(w, torch.Tensor):
        if w.device.type != "cpu":
            raise ValueError(f"loss_weight gave a tensor on {w.device}: give a host number (or a CPU tensor), "
                             "so that the step never waits on the device")
        w = w.detach().numpy()
    return np.float32(w)


def make_train_step(
    loss_fn: Callable,
    log_norms: bool = False,
    accum: int = 1,
    loss_weight: Optional[Callable] = None,
    accum_unroll: bool = False,
):
    """Build ``step(state, batch, scalars) -> (state, mets)``.

    Args:
        loss_fn: ``loss_fn(model, generator, batch, scalars) -> (loss, (mets, outputs))``.
        log_norms: add ``grad_norm`` and ``param_norm`` to ``mets``, both taken
            before the update (the gradient's before clipping).
        accum: gradient-accumulation microbatches; the batch's leading axis must
            divide by it.
        loss_weight: ``loss_weight(microbatch, mets) -> scalar`` on the host (a
            number or a CPU tensor; one on the card raises) weighting each
            microbatch's gradient (default: equal weights). A microbatch of weight
            0 (only padding rows) adds nothing, not even a NaN, to the gradient or
            to the scalar metrics; the test is on the host, so it costs no wait.
        accum_unroll: accepted and ignored; it only schedules XLA in the JAX package.

    Per-example metric leaves (leading dim = microbatch rows) are concatenated to
    the full batch; scalar leaves are weight-averaged over the microbatches.
    """
    del accum_unroll
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")

    def step(state: TrainState, batch, scalars):
        model, generator = state.model, state.generator
        state.optimizer.zero_grad()
        if accum == 1:
            loss, (mets, _) = loss_fn(model, generator, batch, scalars)
            loss.backward()
        else:
            b0 = next(iter(batch.values())).shape[0]
            if b0 % accum != 0:
                raise ValueError(f"batch size {b0} not divisible by accum={accum}")
            b_micro = b0 // accum
            weights, per_mb = [], []
            for mb in _split_rows(batch, accum):
                # a profiler span a microbatch, so that a trace shows what the loop waits on (nothing, on the card)
                with torch.profiler.record_function(MICROBATCH_SPAN):
                    loss_i, (mets_i, _) = loss_fn(model, generator, mb, scalars)
                    w = _host_weight(1.0 if loss_weight is None else loss_weight(mb, mets_i))
                    if w > 0:  # the gradient of w * loss_i is w * g_i
                        (loss_i * float(w)).backward()
                    else:  # padding only: no backward (its loss is 0/0) and masked out of the scalar metrics
                        mets_i = {k: v if v.ndim >= 1 and v.shape[0] == b_micro else torch.zeros_like(v)
                                  for k, v in mets_i.items()}
                weights.append(w)
                per_mb.append(mets_i)
            w_sum = np.sum(weights, dtype=np.float32)
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if grads:  # one multi-tensor launch, not one a parameter
                torch._foreach_div_(grads, float(w_sum))
            mets = {}
            for name in per_mb[0]:
                leaves = [m[name] for m in per_mb]
                if leaves[0].ndim >= 1 and leaves[0].shape[0] == b_micro:
                    mets[name] = torch.cat(leaves)
                else:
                    mets[name] = sum(float(w / w_sum) * leaf for w, leaf in zip(weights, leaves))
        mets = {k: v.detach() for k, v in mets.items()}
        if log_norms:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            mets["grad_norm"] = global_norm(grads)
            mets["param_norm"] = global_norm([p.detach() for p in model.parameters()])
        return state.apply_gradients(), mets

    return step
