"""Metric tracker: per-source merging and the epoch summary.

The part of ``blvm_tpu/evaluation/tracker.py`` the test pass uses, with the same
merge semantics: ``update(metrics, source)`` merges a step's metrics into the
source's accumulators (exact weighted means); ``values`` holds the merged
values and ``log()`` the epoch summary with step counts and durations. The JSONL
and wandb sinks, console progress lines and epoch resets come with the training
slice.
"""

import time
from collections import defaultdict
from typing import Dict, List

from blvm_tpu_torch.evaluation.metrics import Metric


class Tracker:
    def __init__(self):
        self.metrics: Dict[str, Dict[str, Metric]] = defaultdict(dict)  # source -> name -> Metric
        self.start_time: Dict[str, float] = {}
        self.end_time: Dict[str, float] = {}
        self.steps: Dict[str, int] = defaultdict(int)

    def update(self, metrics: List[Metric], source: str):
        """Merge one step's metrics into ``source``'s accumulators."""
        names = [m.name for m in metrics]
        if len(names) != len(set(names)):
            raise ValueError(f"Metrics must have unique names, got {names}")
        now = time.time()
        self.start_time.setdefault(source, now)
        self.end_time[source] = now
        self.steps[source] += 1
        for metric in metrics:
            if metric.name in self.metrics[source]:
                self.metrics[source][metric.name].update(metric)
            else:
                self.metrics[source][metric.name] = metric.copy()

    @property
    def values(self) -> Dict[str, Dict[str, float]]:
        return {source: {m.name: m.value for m in ms.values()} for source, ms in self.metrics.items()}

    def log(self) -> Dict[str, Dict[str, float]]:
        """The epoch summary: per-source values with step counts and durations."""
        values = self.values
        for source in values:
            values[source]["steps"] = self.steps[source]
            values[source]["epoch_duration"] = self.end_time[source] - self.start_time[source]
        return values
