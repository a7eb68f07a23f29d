"""Self-aggregating metric objects with exact weighted running means.

Copy of the parts of ``blvm_tpu/evaluation/metrics.py`` the ported test passes
use (numpy only; the JAX package cannot be imported without JAX). A metric is
built fresh each step from host values and merged into an accumulator with
``update``; running means are exact weighted means, not EMAs.

  * ``reduce_by``: divisor of the summed values (e.g. the sum of sequence lengths).
  * ``weight_by``: merge weight for the running mean (defaults to reduce_by).
  * ``BitsPerDimMetric``: negated log-likelihoods divided by ln 2, running mean
    with ``reduce_by = x_sl``, i.e. bits per frame.
  * ``ErrorRateMetric``: accumulated edit distance over reference length (WER or
    CER by the tokenizer), from :func:`edit_distances`, the JAX package's
    Levenshtein DP with each row taken as whole numpy arrays.
"""

import math
from copy import deepcopy
from typing import List, Sequence, Set

import numpy as np


def drop_padded_rows(mets: dict) -> dict:
    """Remove zero-length padded example rows from a host-side step-metric dict,
    so per-example means are not diluted by padding rows (frame-normalized
    metrics are exact either way). Filters every array leaf whose leading dim,
    or second dim for stacked per-layer arrays, is the batch size."""
    x_sl = np.asarray(mets["x_sl"])
    active = x_sl > 0
    if bool(active.all()):
        return mets
    B = x_sl.shape[0]

    def _filter(v):
        if isinstance(v, (list, tuple)):
            return type(v)(_filter(u) for u in v)
        a = np.asarray(v)
        if a.ndim >= 1 and a.shape[0] == B:
            return a[active]
        if a.ndim >= 2 and a.shape[1] == B:
            return a[:, active]
        return v

    return {k: _filter(v) for k, v in mets.items()}


def _to_host(x):
    """Convert arrays to numpy; pass floats through."""
    if x is None or isinstance(x, (int, float)):
        return x
    return np.asarray(x)


def _sum_and_numel(values):
    values = _to_host(values)
    if isinstance(values, np.ndarray):
        return float(values.sum()), int(values.size)
    return float(values), 1


def _resolve(x, default):
    x = _to_host(x)
    if isinstance(x, np.ndarray):
        return float(x.sum())
    return float(x) if x else default


class Metric:
    base_tags: Set[str] = set()
    _str_value_fmt = "<.3"

    def __init__(
        self,
        name: str,
        tags: Set[str] = None,
        get_best: str = None,
        log_to_console: bool = True,
        log_to_framework: bool = True,
    ):
        self.name = name
        self.tags = self.base_tags if tags is None else (set(tags) | self.base_tags)
        self.get_best = GET_BEST[get_best] if get_best is not None else GET_BEST["none"]
        self.log_to_console = log_to_console
        self.log_to_framework = log_to_framework

    @property
    def value(self):
        raise NotImplementedError()

    @property
    def str_value(self):
        return f"{self.value:{self._str_value_fmt}f}"

    def update(self, metric: "Metric"):
        raise NotImplementedError()

    def copy(self):
        return deepcopy(self)

    def __repr__(self):
        return f"{self.__class__.__name__}(name={self.name}, value={self.str_value})"


def min_value(metrics: List[Metric]):
    return min(metrics, key=lambda m: m.value)


def max_value(metrics: List[Metric]):
    return max(metrics, key=lambda m: m.value)


def no_value(metrics: List[Metric]):
    return None


GET_BEST = dict(none=no_value, min=min_value, max=max_value)


def edit_distances(refs: Sequence[Sequence], hyps: Sequence[Sequence]) -> np.ndarray:
    """The Levenshtein distance of each ``(ref, hyp)`` pair, the integers of the JAX package's
    two-row DP (``blvm_tpu/evaluation/metrics.py:135-148``), all pairs at once: row ``i`` of every
    pair's DP is ``t = [i, min(prev[1:] + 1, prev[:-1] + cost)]`` and then
    ``curr = minimum.accumulate(t - j) + j`` (the insertions along the row), ``j = arange(len(t))``;
    a pair whose reference has fewer than ``i`` tokens keeps its last row. Tokens are compared by
    equality (any hashable: words, characters, indices)."""
    n = len(refs)
    if n == 0:
        return np.zeros(0, np.int64)
    vocab: dict = {}

    def encode(seq):
        return [vocab.setdefault(tok, len(vocab)) for tok in seq]

    ref_ids, hyp_ids = [encode(r) for r in refs], [encode(h) for h in hyps]
    ref_len = np.asarray([len(r) for r in ref_ids], np.int64)
    hyp_len = np.asarray([len(h) for h in hyp_ids], np.int64)
    width = int(hyp_len.max()) + 1
    hyp = np.full((n, width - 1), -1, np.int64)
    ref = np.full((n, max(int(ref_len.max()), 1)), -2, np.int64)
    for k, (r, h) in enumerate(zip(ref_ids, hyp_ids)):
        hyp[k, : len(h)] = h
        ref[k, : len(r)] = r
    j = np.arange(width, dtype=np.int64)
    prev = np.tile(j, (n, 1))
    t = np.empty_like(prev)
    for i in range(1, int(ref_len.max()) + 1):
        t[:, 0] = i
        np.minimum(prev[:, 1:] + 1, prev[:, :-1] + (hyp != ref[:, i - 1 : i]), out=t[:, 1:])
        curr = np.minimum.accumulate(t - j, axis=1) + j
        prev = np.where((i <= ref_len)[:, None], curr, prev)
    return prev[np.arange(n), hyp_len]


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two sequences."""
    return int(edit_distances([ref], [hyp])[0])


class ErrorRateMetric(Metric):
    """Accumulated edit-distance error rate (WER/CER via tokenizer choice)."""

    def __init__(self, refs, hyps, tokenizer, name="er", tags=None):
        super().__init__(name=name, tags=tags, get_best="min")
        ref_tokens, hyp_tokens = [tokenizer(r) for r in refs], [tokenizer(h) for h in hyps]
        self._edits = int(edit_distances(ref_tokens, hyp_tokens).sum())
        self._len = sum(len(r) for r in ref_tokens)

    @property
    def value(self):
        return self._edits / self._len if self._len else float("nan")

    def update(self, metric: Metric):
        self._edits += metric._edits
        self._len += metric._len


class RunningMeanMetric(Metric):
    def __init__(self, values, name, tags=None, reduce_by=None, weight_by=None, get_best=None, log_to_console=True, log_to_framework=True):
        """Exact weighted running mean: value = sum(values) / reduce_by, merged
        across steps with weights ``weight_by`` (reference ``metrics.py:209-264``)."""
        super().__init__(name=name, tags=tags, get_best=get_best, log_to_console=log_to_console, log_to_framework=log_to_framework)
        value, numel = _sum_and_numel(values)
        reduce_by = _resolve(reduce_by, numel)
        self.weight_by = _resolve(weight_by, reduce_by)
        self.running_mean = value / reduce_by

    @property
    def value(self):
        return self.running_mean

    def update(self, metric: Metric):
        d = self.weight_by + metric.weight_by
        w1 = self.weight_by / d
        w2 = metric.weight_by / d
        self.running_mean = self.running_mean * w1 + metric.running_mean * w2
        self.weight_by = d


class EMAMetric(Metric):
    """An exponential moving average over steps: ``value = sum(values) / reduce_by`` of the first
    step, then ``w new + (1 - w) old`` with ``w`` the mean of the two steps' ``weight_by`` (the
    CW-VAE's "elbo ema (bpt)")."""

    def __init__(self, values, name, tags=None, reduce_by=None, weight_by=None, get_best=None, log_to_console=True,
                 log_to_framework=True):
        super().__init__(name=name, tags=tags, get_best=get_best, log_to_console=log_to_console,
                         log_to_framework=log_to_framework)
        value, numel = _sum_and_numel(values)
        reduce_by = _resolve(reduce_by, numel)
        self.weight_by = _resolve(weight_by, reduce_by)
        self.ema = value / reduce_by

    @property
    def value(self):
        return self.ema

    def update(self, metric: Metric):
        avg_weight = (self.weight_by + metric.weight_by) / 2
        self.ema = avg_weight * metric.ema + (1 - avg_weight) * self.ema


class LossMetric(RunningMeanMetric):
    base_tags = {"losses"}

    def __init__(self, values, name="loss", tags=None, reduce_by=None, weight_by=None, get_best="min", **kwargs):
        super().__init__(values=values, name=name, tags=tags, reduce_by=reduce_by, weight_by=weight_by, get_best=get_best, **kwargs)


class LLMetric(RunningMeanMetric):
    base_tags = {"log_likelihoods"}

    def __init__(self, values, name="ll", tags=None, reduce_by=None, weight_by=None, get_best="max", **kwargs):
        super().__init__(values=values, name=name, tags=tags, reduce_by=reduce_by, weight_by=weight_by, get_best=get_best, **kwargs)


class KLMetric(RunningMeanMetric):
    base_tags = {"kl_divergences"}

    def __init__(self, values, name="kl", tags=None, reduce_by=None, weight_by=None, get_best=None, **kwargs):
        super().__init__(values=values, name=name, tags=tags, reduce_by=reduce_by, weight_by=weight_by, get_best=get_best, **kwargs)


class BitsPerDimMetric(RunningMeanMetric):
    """Nats to bits with a running mean over ``reduce_by`` frames: bits/frame
    when reduce_by is the sum of sequence lengths."""

    _str_value_fmt = "<5.3"

    def __init__(self, values, name="bpd", tags=None, reduce_by=None, weight_by=None, get_best="min", **kwargs):
        values = _to_host(values)
        if isinstance(values, np.ndarray):
            values = -values / math.log(2)
        else:
            values = -float(values) / math.log(2)
        super().__init__(values=values, name=name, tags=tags, reduce_by=reduce_by, weight_by=weight_by, get_best=get_best, **kwargs)


class LatestMeanMetric(Metric):
    """The mean of the latest step's values; ``update`` replaces it (a schedule's value)."""

    def __init__(self, values, name, tags=None, reduce_by=None, get_best=None, log_to_console=True, log_to_framework=True):
        super().__init__(name=name, tags=tags, get_best=get_best, log_to_console=log_to_console, log_to_framework=log_to_framework)
        value, numel = _sum_and_numel(values)
        reduce_by = _resolve(reduce_by, numel)
        self.latest = value / reduce_by

    @property
    def value(self):
        return self.latest

    def update(self, metric: Metric):
        self.latest = metric.latest
