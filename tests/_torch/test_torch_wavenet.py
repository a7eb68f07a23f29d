"""The WaveNet slice end to end on CPU: the port against the JAX model, the frozen
reference golden, and the rf-chunked test pass against the full forward."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from blvm_tpu.models import WaveNet as JaxWaveNet
from blvm_tpu_torch import weights
from blvm_tpu_torch.evaluation.tracker import Tracker
from blvm_tpu_torch.experiments import wavenet_audio
from blvm_tpu_torch.models import WaveNet
from blvm_tpu_torch.models.wavenet import InputSizeError
from tests._torch.helpers import jax_forward, np32, torch_forward

GOLDEN = Path(__file__).resolve().parent.parent / "parity" / "goldens" / "wavenet.npz"
SMALL = dict(n_layers=3, n_stacks=2, res_channels=16, num_mix=3, num_bins=256)


def small_model(seed: int = 0, **kwargs):
    config = {**SMALL, **kwargs}
    model = WaveNet(**config)
    params = weights.random_jax_params(model, seed)
    weights.load_jax_params(model, params)
    return model, JaxWaveNet(**config), params


def waveforms(lengths, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.uniform(-1, 1, n)
    return x, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pad_receptive_field", [True, False])
def test_wavenet_matches_jax(pad_receptive_field, bf16):
    """f32: the network's sums run in another order than XLA's (~1e-6 relative on
    the head's inputs), which the 2^8-bin DMoL passes on at up to ~1e-4 per frame.
    bf16: the stack rounds at 2^-7 relative after every op in both packages, and a
    one-ulp difference moves a frame's log-mass by up to the JAX suite's bf16
    tolerance (5e-2); the per-row sums and the loss average those out (1e-3)."""
    model, jmodel, params = small_model(bf16=bf16)
    x, x_sl = waveforms([80, 60], seed=1)
    jloss, jmets, jout = jax_forward(jmodel, params, x, x_sl, pad_receptive_field=pad_receptive_field)
    loss, mets, out = torch_forward(model, x, x_sl, pad_receptive_field=pad_receptive_field)

    rel, frame = (1e-3, 5e-2) if bf16 else (1e-5, 1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rel)
    np.testing.assert_allclose(np32(mets["log_prob"]), np32(jmets["log_prob"]), rtol=rel)
    np.testing.assert_array_equal(mets["x_sl"].numpy(), np.asarray(jmets["x_sl"]))
    np.testing.assert_allclose(np32(out.log_prob_twise), np32(jout.log_prob_twise), rtol=0, atol=frame)
    np.testing.assert_allclose(np32(out.predictions_mode), np32(jout.predictions_mode), rtol=0, atol=frame)
    assert out.predictions.shape == jout.predictions.shape
    assert (out.predictions.abs() <= 1).all()
    assert len(out.z) == len(jout.z) and out.y.shape == jout.y.shape


def test_frame_stacked_wavenet_matches_jax():
    model, jmodel, params = small_model(n_stack_frames=4)
    x, x_sl = waveforms([130, 101], seed=2)
    jloss, jmets, jout = jax_forward(jmodel, params, x, x_sl)
    loss, mets, out = torch_forward(model, x, x_sl)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(np32(out.log_prob_twise), np32(jout.log_prob_twise), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.z_sl.numpy(), np.asarray(jout.z_sl))


def test_frozen_reference_golden_replays_through_weights_bridge():
    """``tests/parity/goldens/wavenet.npz`` holds the torch reference's weights,
    inputs and numbers; same tolerances as tests/parity/test_goldens.py:66-71."""
    data = np.load(GOLDEN)
    meta = json.loads(bytes(data["meta"]).decode())
    model = WaveNet(**meta["kwargs"])
    weights.load_jax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p|")})
    loss, mets, _ = torch_forward(model, data["x"], data["x_sl"], **meta["call_kwargs"])
    np.testing.assert_allclose(float(loss), float(data["g|loss"]), rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(mets["log_prob"].numpy(), data["g|log_prob"], rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("mode", ["consume", "extend"])
def test_chunked_eval_equals_full_forward(mode):
    """Chunks with receptive-field overlap reproduce the full forward's summed
    log-prob and score every sample exactly once (tests/models/test_wavenet.py:206-240)."""
    model, _, _ = small_model()
    rf = model.receptive_field
    x, x_sl = waveforms([3 * rf + 20, 2 * rf + 5], seed=23)
    _, mets_full, _ = torch_forward(model, x, x_sl)

    length = rf + 24 if mode == "consume" else rf // 2
    chunks, lens = model.split_sequence(x, x_sl, length=length)
    assert len(chunks) >= 2
    total_lp, total_frames = 0.0, 0
    for i, (xs, sl) in enumerate(zip(chunks, lens)):
        with torch.inference_mode():
            _, mets, _ = model.forward_split(torch.from_numpy(xs), torch.from_numpy(np.asarray(sl, np.int32)), i_split=i)
        total_lp += float(mets["log_prob"].sum())
        total_frames += int(mets["x_sl"].sum())
    np.testing.assert_allclose(total_lp, float(mets_full["log_prob"].sum()), rtol=1e-6, atol=1e-3)
    assert total_frames == int(x_sl.sum())


def test_test_pass_split_eval_matches_whole_batch():
    """The driver-level test pass: rf-chunked (--split_eval) and one-forward
    scoring give the same bits/frame; flags of experiments/benchmarks.txt parse."""
    argv = ("--likelihood DMoL --input_coding mu_law --n_stacks 2 --n_layers 3 --res_channels 16 --num_bits 8 "
            "--num_mix 3 --random_segment_size 40 --seed 0 --dataset timit --epochs 3").split()
    with pytest.warns(UserWarning, match="--dataset"):
        args = wavenet_audio.build_args(argv)
    model = wavenet_audio.build_model(args, device="cpu")
    weights.load_jax_params(model, weights.random_jax_params(model, args.seed))
    rng = np.random.default_rng(4)
    batch = wavenet_audio.make_batch([rng.uniform(-0.5, 0.5, n) for n in (150, 97, 121)], args)

    results = {}
    for split_eval in (True, False):
        args.split_eval = split_eval
        results[split_eval] = wavenet_audio.evaluate(model, args, [batch], Tracker(), source="test")
    for name in ("loss", "ll", "bpd"):
        assert np.isfinite(results[True][name])
    np.testing.assert_allclose(results[True]["bpd"], results[False]["bpd"], rtol=1e-6)


def test_flagship_flags_parse():
    line = Path(__file__).resolve().parent.parent.parent / "experiments" / "benchmarks.txt"
    spec = next(l for l in line.read_text().splitlines() if "TIMIT WaveNet mu-law s=1" in l)
    argv = spec.split('"')[-1].split()  # flags after --name "..."
    with pytest.warns(UserWarning):
        args = wavenet_audio.build_args(argv)
    assert (args.n_stacks, args.n_layers, args.res_channels, args.num_bits, args.num_mix) == (5, 10, 96, 16, 10)
    assert args.split_eval and args.random_segment_size == 16000 and args.likelihood == "DMoL"
    assert WaveNet(n_layers=10, n_stacks=5, res_channels=8).receptive_field == JaxWaveNet(
        n_layers=10, n_stacks=5, res_channels=8).receptive_field == 5117


def test_input_shorter_than_receptive_field_raises():
    model, _, _ = small_model()
    with pytest.raises(InputSizeError):
        torch_forward(model, np.zeros((1, 16), np.float32), np.array([16], np.int32), pad_receptive_field=False)
