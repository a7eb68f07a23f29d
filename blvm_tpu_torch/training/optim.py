"""Optimizer chain and learning-rate schedules (port of ``blvm_tpu/training/optim.py``).

The JAX package composes an optax chain: value clip -> global-norm clip ->
optimizer, optionally under ``optax.apply_if_finite``. Here the same chain acts
on the parameters' ``.grad`` in place before one ``torch.optim`` step:

- the value clip is ``optax.clip``: each element into [-v, v];
- the norm clip is ``optax.clip_by_global_norm``: ``g / ||g|| * max_norm`` only
  when ``||g|| >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` would divide
  by ``||g|| + 1e-6`` and scale below the threshold too);
- ``skip_nonfinite_updates`` is ``optax.apply_if_finite``: a non-finite gradient
  leaves the parameters and the optimizer state (Adam's moments and step
  count) untouched, so the step is skipped entirely; after more than
  ``MAX_CONSECUTIVE_ERRORS`` non-finite steps in a row the update is taken.
  The decision stays on the device, as JAX's does: the finite flag and the
  counters are device tensors; the parameters and Adam's state are copied,
  stepped, and put back with ``torch.where`` where the update is dropped, so a
  train step never waits on the card for it.

``torch.optim.Adam`` is optax's ``adam`` (eps outside the square root,
``eps_root = 0``); the optimizer is a library call in the JAX package too.
Under ``skip_nonfinite_updates`` on the card it is built ``capturable``, which
keeps its step count on the device.
"""

import math
from typing import Callable, Iterable, Optional

import torch

MAX_CONSECUTIVE_ERRORS = 10_000  # the JAX package's apply_if_finite setting


class EpochSchedule:
    """A learning-rate schedule denominated in EPOCHS, matching the reference's
    ``lr_scheduler.step()`` cadence (once per epoch, after the training section).

    ``factor(n)`` is the decay multiplier after ``n`` ``step()`` calls (torch
    ``get_last_lr`` semantics); the lr used DURING 1-indexed epoch ``k`` is
    therefore ``lr0 * factor(k - 1)``.
    """

    def __init__(self, init_value: float, factor):
        self.init_value = float(init_value)
        self.factor = factor

    def lr_at_epoch(self, epoch: int) -> float:
        return self.init_value * float(self.factor(max(0, int(epoch) - 1)))


def get_lr_schedule(name: Optional[str], learning_rate: float, **kwargs):
    """Resolve an LR schedule by name; None -> constant learning rate.

    Torch names (``MultiStepLR``, ``ExponentialLR``, ``StepLR``,
    ``CosineAnnealingLR``, ``MultiplicativeLR``) return an :class:`EpochSchedule`:
    the reference steps these once per EPOCH, so their milestones, step sizes and
    ``T_max`` are epoch counts. The JAX package's per-optimizer-step optax
    schedules are not ported and raise ``NotImplementedError``.
    """
    if name is None:
        return learning_rate

    def multistep(milestones=(), gamma=0.1):
        milestones = sorted(int(m) for m in milestones)
        return lambda n: gamma ** sum(1 for m in milestones if m <= n)

    def exponential(gamma=1.0):
        return lambda n: gamma**n

    def steplr(step_size=1, gamma=0.1):
        return lambda n: gamma ** (n // int(step_size))

    def cosine(T_max, eta_min=0.0):
        lr0 = learning_rate
        return lambda n: (eta_min + 0.5 * (lr0 - eta_min) * (1 + math.cos(math.pi * n / T_max))) / lr0

    torch_map = {
        "MultiStepLR": multistep,
        "ExponentialLR": exponential,
        "MultiplicativeLR": lambda lr_lambda=1.0: exponential(lr_lambda),
        "StepLR": steplr,
        "CosineAnnealingLR": cosine,
    }
    if name in torch_map:
        return EpochSchedule(learning_rate, torch_map[name](**kwargs))
    raise NotImplementedError(f"LR schedule {name!r}: the per-step optax schedules are not ported to blvm_tpu_torch")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all elements of all tensors, from one multi-tensor
    launch of the tensors' norms (not a reduction and an add a tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class ClippedOptimizer:
    """The chain bound to parameters: :meth:`step` clips the parameters' ``.grad``
    in place (value, then global norm) and takes one optimizer step, or, when
    ``skip_nonfinite_updates`` is set and a gradient is not finite, leaves the
    parameters and Adam's state as they were. ``notfinite_count`` (consecutive
    non-finite steps) and ``total_notfinite`` are then int32 device tensors,
    ``apply_if_finite``'s state; read them only where they are logged."""

    def __init__(self, params, learning_rate: float, clip_grad_norm: Optional[float],
                 clip_grad_value: Optional[float], skip_nonfinite_updates: bool, **adam_kwargs):
        self.params = list(params)
        device = self.params[0].device if self.params else torch.device("cpu")
        # a host step count would make Adam read it back from the card on every step it may drop
        capturable = adam_kwargs.pop("capturable", False) or (skip_nonfinite_updates and device.type == "cuda")
        self.optimizer = torch.optim.Adam(self.params, lr=learning_rate, capturable=capturable, **adam_kwargs)
        self.clip_grad_norm, self.clip_grad_value = clip_grad_norm, clip_grad_value
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.notfinite_count = self.total_notfinite = 0
        if skip_nonfinite_updates:
            self.notfinite_count = torch.zeros((), dtype=torch.int32, device=device)
            self.total_notfinite = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    @learning_rate.setter
    def learning_rate(self, value: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = value

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        """Clip and step. Returns whether the update was applied: True, or under
        ``skip_nonfinite_updates`` a bool device tensor."""
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        apply = True
        if self.skip_nonfinite_updates and grads:
            # optax.apply_if_finite on the device: 0 * g is 0 where g is finite and NaN elsewhere, so the
            # norms of 0 * g are all finite exactly when every element of every gradient is
            finite = torch.isfinite(torch.stack(torch._foreach_norm(torch._foreach_mul(grads, 0.0)))).all()
            zero = torch.zeros_like(self.notfinite_count)
            self.notfinite_count = torch.where(finite, zero, self.notfinite_count + 1)
            self.total_notfinite = torch.where(finite, self.total_notfinite, self.total_notfinite + 1)
            apply = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        # multi-tensor ops: a few launches a step however many gradients, the same elementwise math
        with torch.no_grad():
            if self.clip_grad_value:
                torch._foreach_clamp_min_(grads, -self.clip_grad_value)
                torch._foreach_clamp_max_(grads, self.clip_grad_value)
            if self.clip_grad_norm:
                norm = global_norm(grads)
                keep = norm < self.clip_grad_norm  # a device scalar: no host sync
                # g / norm * max_norm above the threshold, as optax; g / 1 * 1 (exactly g) below it
                one = torch.ones((), dtype=norm.dtype, device=norm.device)
                torch._foreach_div_(grads, torch.where(keep, one, norm))
                torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(one, self.clip_grad_norm)))
            if not self.skip_nonfinite_updates:
                self.optimizer.step()
            elif grads:
                self._step_if(params, apply)
        return apply

    def _step_if(self, params, apply: torch.Tensor) -> None:
        """One Adam step of ``params`` that is kept only where the device flag ``apply`` is true: else the
        parameters and every tensor of Adam's state (moments, step count) keep their values exactly, and a
        state that the step created reads as Adam's fresh one, zeros (a NaN gradient's NaNs never stay)."""
        def tensors():  # the parameters and Adam's state, by (parameter, name)
            return {(i, name): t for i, p in enumerate(params)
                    for name, t in (("param", p.detach()), *self.optimizer.state[p].items())}

        before = tensors()
        kept = {key: torch.empty_like(t) for key, t in before.items()}
        torch._foreach_copy_(list(kept.values()), list(before.values()))
        self.optimizer.step()
        after = tensors()
        restore = [torch.where(apply, t, kept[key] if key in kept else torch.zeros_like(t)) for key, t in after.items()]
        torch._foreach_copy_(list(after.values()), restore)


def get_optimizer(
    name: str,
    learning_rate: float,
    clip_grad_norm: Optional[float] = None,
    clip_grad_value: Optional[float] = None,
    skip_nonfinite_updates: bool = False,
    **kwargs,
) -> Callable[[Iterable[torch.nn.Parameter]], ClippedOptimizer]:
    """The chain value clip -> global-norm clip -> optimizer by name, optionally
    skipping non-finite updates. Returns ``init(params) -> ClippedOptimizer``, as
    an optax transformation waits for ``init(params)``. Adam (the drivers'
    default, as ``Adam`` or optax's ``adam``) is the optimizer ported so far;
    ``kwargs`` are ``torch.optim.Adam``'s."""
    if name not in ("Adam", "adam"):
        raise NotImplementedError(f"optimizer {name!r} is not ported to blvm_tpu_torch (only Adam)")

    def init(params) -> ClippedOptimizer:
        return ClippedOptimizer(params, learning_rate, clip_grad_norm, clip_grad_value, skip_nonfinite_updates, **kwargs)

    return init
