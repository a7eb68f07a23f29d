"""The parameter bridge between flax trees and the port's modules."""

import jax
import numpy as np
import pytest

from blvm_tpu.models import WaveNet as JaxWaveNet
from blvm_tpu_torch import weights
from blvm_tpu_torch.models import WaveNet

CONFIG = dict(n_layers=2, n_stacks=2, res_channels=8, num_mix=3, num_bins=256)


def test_names_and_shapes_match_flax_init():
    """The port's parameter names and shapes are exactly those of a flax init."""
    x = np.zeros((1, 32), np.float32)
    variables = jax.eval_shape(
        lambda: JaxWaveNet(**CONFIG).init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, np.array([32], np.int32)
        )
    )
    flax_shapes = {k: tuple(v.shape) for k, v in weights.flatten(variables["params"]).items()}
    assert weights.param_shapes(WaveNet(**CONFIG)) == flax_shapes


@pytest.mark.parametrize("layout", ["nested", "flat"])
def test_round_trip(layout):
    model = WaveNet(**CONFIG)
    flat = weights.random_jax_params(model, seed=5)
    weights.load_jax_params(model, weights.unflatten(flat) if layout == "nested" else flat)
    back = weights.flatten(weights.export_jax_params(model))
    assert back.keys() == flat.keys()
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name])


def test_random_params_follow_fan_in_bounds():
    params = weights.random_jax_params(WaveNet(**CONFIG), seed=0)
    gate = params["res_stack/Conv1dResidualGLU_0/gate_kernel_t"]  # (2, 8, 8): fan-in 16
    assert np.abs(gate).max() <= 1 / np.sqrt(16) and np.abs(gate).max() > 0.9 / np.sqrt(16)
    bias = params["res_stack/Conv1dResidualGLU_0/rs_bias"]  # rs_kernel (1, 8, 16): fan-in 8
    assert np.abs(bias).max() <= 1 / np.sqrt(8)
    assert weights.random_jax_params(WaveNet(**CONFIG), seed=0).keys() == params.keys()


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_errors(fault):
    model = WaveNet(**CONFIG)
    flat = weights.random_jax_params(model, seed=1)
    before = weights.flatten(weights.export_jax_params(model))
    if fault == "missing":
        del flat["likelihood_head/Dense_0/bias"]
        error = KeyError
    elif fault == "extra":
        flat["res_stack/Conv1dResidualGLU_9/rs_bias"] = np.zeros(16, np.float32)
        error = KeyError
    else:
        flat["out_transform/Dense_0/kernel"] = np.zeros((8, 9), np.float32)
        error = ValueError
    with pytest.raises(error):
        weights.load_jax_params(model, flat)
    after = weights.flatten(weights.export_jax_params(model))
    for name in before:  # nothing was copied
        np.testing.assert_array_equal(after[name], before[name])
