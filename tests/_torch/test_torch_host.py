"""The port's copies of the host code against the JAX package's originals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.data import transforms as jax_transforms
from blvm_tpu.evaluation import metrics as jax_metrics
from blvm_tpu.ops import conv_arithmetic as jax_conv
from blvm_tpu.ops import padding as jax_padding
from blvm_tpu.ops import sequence as jax_sequence
from blvm_tpu_torch.data.transforms import MuLawDecode, MuLawEncode
from blvm_tpu_torch.evaluation import metrics
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.ops import conv_arithmetic, padding, sequence
from blvm_tpu_torch.ops.likelihoods import _row_view


@pytest.mark.parametrize("stride", [1, 3])
def test_sequence_mask(stride):
    x_sl = np.array([7, 0, 12], np.int32)
    ref = np.asarray(jax_sequence.sequence_mask(jnp.asarray(x_sl), max_len=6, stride=stride))
    np.testing.assert_array_equal(sequence.sequence_mask(torch.from_numpy(x_sl), max_len=6, stride=stride).numpy(), ref)


@pytest.mark.parametrize("axis", [1, -1])
def test_stack_unstack_round_trip(axis):
    x = np.random.default_rng(0).normal(size=(2, 10, 3)).astype(np.float32)
    ref, ref_pad = jax_sequence.stack_tensor(jnp.asarray(x), 4, axis=axis)
    got, pad = sequence.stack_tensor(torch.from_numpy(x), 4, axis=axis)
    assert pad == ref_pad
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = sequence.unstack_tensor(got, 4, pad, axis=axis)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("mode,length,overlap", [("consume", 12, 5), ("extend", 4, 9)])
def test_split_sequence(mode, length, overlap):
    x = np.arange(2 * 30, dtype=np.float32).reshape(2, 30)
    x_sl = np.array([30, 17], np.int32)
    ref_chunks, ref_lens = jax_sequence.split_sequence(x, x_sl, length=length, overlap=overlap, mode=mode)
    chunks, lens = sequence.split_sequence(x, x_sl, length=length, overlap=overlap, mode=mode)
    assert len(chunks) == len(ref_chunks) > 1
    for a, b, la, lb in zip(chunks, ref_chunks, lens, ref_lens):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(la, np.asarray(lb))


def test_integer_arithmetic_copies():
    dil = [1, 2, 4, 8] * 2
    assert conv_arithmetic.compute_conv_attributes([2] * 8, [0] * 8, [1] * 8, dil, return_all=True) == [
        conv_arithmetic.ConvAttributes(*vars(a).values())
        for a in jax_conv.compute_conv_attributes([2] * 8, [0] * 8, [1] * 8, dil, return_all=True)
    ]
    for length, stride in [(16000, 1), (16000, 64), (100, 7)]:
        assert padding.get_modulo_length(length, stride) == jax_padding.get_modulo_length(length, stride)
    assert sequence.update_running_variance(1.0, 3, 2.0, 2.0, 5, 1.0) == jax_sequence.update_running_variance(
        1.0, 3, 2.0, 2.0, 5, 1.0
    )


def test_mu_law_matches_jax_numpy_path():
    x = np.random.default_rng(1).uniform(-1, 1, 1000).astype(np.float64)
    for bits in (8, 16):
        enc, jenc = MuLawEncode(bits), jax_transforms.MuLawEncode(bits)
        np.testing.assert_allclose(enc(x), jenc(x), rtol=1e-12)
        np.testing.assert_allclose(MuLawDecode(bits)(enc(x)), x, atol=1e-9)


def test_metrics_and_tracker_match_jax():
    """Two steps merged per source: loss, ll and bits/frame as exact weighted
    means, padded rows (x_sl = 0) dropped from per-example means."""
    steps = [
        dict(loss=np.float32(2.5), log_prob=np.array([-100.0, -40.0, 0.0]), x_sl=np.array([50, 20, 0])),
        dict(loss=np.float32(1.5), log_prob=np.array([-30.0]), x_sl=np.array([30])),
    ]

    def build(m, mets):
        mets = m.drop_padded_rows(mets)
        lp = mets["log_prob"]
        return [m.LossMetric(mets["loss"], weight_by=lp.shape[0]), m.LLMetric(lp), m.BitsPerDimMetric(lp, reduce_by=mets["x_sl"])]

    tracker = Tracker()
    ref = {}
    for mets in steps:
        tracker.update(build(metrics, mets), source="test")
        for metric in build(jax_metrics, mets):
            ref[metric.name] = metric if metric.name not in ref else (ref[metric.name].update(metric) or ref[metric.name])
    values = tracker.values["test"]
    for name, metric in ref.items():
        assert values[name] == pytest.approx(metric.value, rel=1e-12)
    assert values["bpd"] == pytest.approx(170.0 / 100.0 / np.log(2))
    summary = tracker.log()
    assert summary["test"]["steps"] == 2 and "epoch_duration" in summary["test"]


def test_row_view_passes_head_slices_without_copy():
    params = torch.zeros(2, 5, 30)
    logits = params[..., :10]
    view, stride = _row_view(logits, 2)
    assert view.data_ptr() == params.data_ptr() and stride == 30
    view, stride = _row_view(params.transpose(0, 1)[..., :10], 2)  # not uniformly strided: copied
    assert view.is_contiguous() and stride == 10
