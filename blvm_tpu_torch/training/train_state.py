"""Train state (port of ``blvm_tpu/training/train_state.py``).

The JAX package keeps parameters, optimizer state, step counter and PRNG key in
one pytree that its jitted step donates. Here the model owns its parameters,
the optimizer chain its state, and the generator stands for the key; the state
is updated in place.
"""

from dataclasses import dataclass

import torch
from torch import nn

from blvm_tpu_torch.training.optim import ClippedOptimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ClippedOptimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, *, model: nn.Module, tx, generator: torch.Generator) -> "TrainState":
        """``tx`` is :func:`blvm_tpu_torch.training.optim.get_optimizer`'s ``init``."""
        return cls(model=model, optimizer=tx(model.parameters()), generator=generator)

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' ``.grad``; the step counts
        up whether or not a non-finite gradient made the chain skip it."""
        self.optimizer.step()
        self.step += 1
        return self
