"""Scalar schedules for the KL weight (beta) and the free-nats budget.

Copy of ``blvm_tpu/training/annealers.py`` (the JAX package cannot be imported
without JAX): a constant phase of ``constant_steps`` at ``start_value``, then a
half cosine from ``start_value`` to ``end_value`` over ``anneal_steps``.
"""

import math


class Annealer:
    """Base annealer: ``value`` is None until the first ``step()``."""

    value = None

    def step(self) -> float:
        raise NotImplementedError()

    def state_dict(self) -> dict:
        return {"steps": getattr(self, "steps", 0), "value": self.value}

    def load_state_dict(self, state: dict) -> None:
        self.steps = state["steps"]
        self.value = state["value"]

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class CosineAnnealer(Annealer):
    def __init__(self, anneal_steps: int, constant_steps: int = 0, start_value: float = 0, end_value: float = 1):
        super().__init__()
        self.validate_inputs(anneal_steps, constant_steps, start_value, end_value)
        self.anneal_steps = anneal_steps
        self.constant_steps = constant_steps
        self.start_value = start_value
        self.end_value = end_value
        self.steps = 0
        self.value = None

    @staticmethod
    def validate_inputs(anneal_steps, constant_steps, start_value, end_value):
        if anneal_steps < 0 or constant_steps < 0:
            raise ValueError(f"steps must be positive but got {anneal_steps=}, {constant_steps=}")
        if not math.isfinite(start_value) or not math.isfinite(end_value):
            raise ValueError(f"start_value and end_value must be finite but got {start_value=}, {end_value=}")

    def step(self) -> float:
        self.steps += 1
        if self.steps >= self.anneal_steps + self.constant_steps:
            self.value = self.end_value
        elif self.steps <= self.constant_steps:
            self.value = self.start_value
        else:
            self.value = self.end_value + 0.5 * (self.start_value - self.end_value) * (
                1 + math.cos((self.steps - self.constant_steps - 1) / self.anneal_steps * math.pi)
            )
        return self.value

    def __repr__(self):
        return (
            f"CosineAnnealer(anneal_steps={self.anneal_steps}, constant_steps={self.constant_steps} "
            f"start_value={self.start_value}, end_value={self.end_value})"
        )
