"""Model base: configuration and the forward contract (port of ``blvm_tpu/models/base.py``).

A model's ``forward(x, x_sl, ...)`` returns ``(loss, mets, outputs)``: ``mets`` is
a dict of tensors (the per-example values the metrics need) and ``outputs`` a
``SimpleNamespace``. ``build_metrics(mets)`` turns host (numpy) ``mets`` into the
list of :class:`~blvm_tpu_torch.evaluation.metrics.Metric` the tracker merges.

Checkpoint input/output comes with the training slice; parameters move between
the packages through :mod:`blvm_tpu_torch.weights`.
"""

from torch import nn


class BaseModel(nn.Module):
    """End-use model that remembers the configuration it was built with."""

    def __init__(self, **config):
        super().__init__()
        self.config = dict(config)  # the flax dataclass fields; a checkpoint will store them

    @staticmethod
    def build_metrics(mets: dict):
        raise NotImplementedError
