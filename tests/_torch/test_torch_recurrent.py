"""The port's LSTM (``modules/recurrent.py`` over ``ops/recurrent.py``, K5's plain twin on
the CPU) against ``blvm_tpu.modules.recurrent.LSTM``, and the recurrent parameters'
init. Inputs and weights come from numpy seeds; each JAX reference compiles once,
in a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.modules.recurrent import LSTM as JaxLSTM
from blvm_tpu_torch import weights
from blvm_tpu_torch.models import LSTMAudio
from blvm_tpu_torch.modules.recurrent import LSTM
from blvm_tpu_torch.ops import recurrent as recurrent_ops

B, T, D, H = 3, 12, 5, 16
LENGTHS = np.asarray([12, 7, 1])
# name: (layers, dtype, ragged, initial state)
CASES = {
    "full": (1, None, False, False),
    "ragged": (1, None, True, False),
    "two_layers_initial_state": (2, None, True, True),
    "bf16_ragged": (1, "bfloat16", True, False),
}
# f32: the same ops in the same order, only the products' summation order differs; bf16:
# the JAX suite's tolerance for bf16 cores (one ulp of an O(1) value, 2^-8, amplified by a gate)
TOL = {None: dict(atol=1e-6, rtol=1e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _inputs(layers, ragged, initial, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < (LENGTHS if ragged else np.full(B, T))[:, None]).astype(np.float32)
    state = tuple(rng.normal(scale=0.5, size=(layers, B, H)).astype(np.float32) for _ in range(2)) if initial else None
    return x, mask, state


def _port(layers, dtype):
    model = LSTM(D, H, num_layers=layers, dtype=getattr(torch, dtype) if dtype else None)
    params = weights.random_jax_params(model, seed=layers)
    weights.load_jax_params(model, params)
    return model, params


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX outputs, ``(out, h_n, c_n)`` as numpy, and the f32 gradients."""
    results = {}
    for name, (layers, dtype, ragged, initial) in CASES.items():
        x, mask, state = _inputs(layers, ragged, initial)
        _, params = _port(layers, dtype)
        jmodel = JaxLSTM(hidden_size=H, num_layers=layers, dtype=getattr(jnp, dtype) if dtype else None)
        out, (h_n, c_n) = jax.jit(lambda p, x_, m_, s_: jmodel.apply({"params": p}, x_, mask=m_, initial_state=s_))(
            weights.unflatten(params), x, mask, state)
        results[name] = tuple(np.asarray(a, np.float32) for a in (out, h_n, c_n))

    layers, _, ragged, initial = CASES["two_layers_initial_state"]
    x, mask, state = _inputs(layers, ragged, initial)
    _, params = _port(layers, None)
    weight = np.random.default_rng(9).normal(size=(B, T, H)).astype(np.float32)
    jmodel = JaxLSTM(hidden_size=H, num_layers=layers)

    def scalar(p, x_, s_):
        out, (h_n, c_n) = jmodel.apply({"params": p}, x_, mask=mask, initial_state=s_)
        return (out * weight).sum() + (h_n * 0.3).sum() - (c_n * 0.7).sum()

    grads = jax.jit(jax.grad(scalar, argnums=(0, 1, 2)))(weights.unflatten(params), x, state)
    results["grads"] = jax.tree_util.tree_map(np.asarray, grads), weight
    return results


@pytest.mark.parametrize("case", list(CASES))
def test_lstm_matches_jax(jax_results, case):
    """Outputs, and the final state at each sequence's true end: ragged rows freeze
    their state past the length and output zeros there."""
    layers, dtype, ragged, initial = CASES[case]
    x, mask, state = _inputs(layers, ragged, initial)
    model, _ = _port(layers, dtype)
    with torch.no_grad():
        out, (h_n, c_n) = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                                initial_state=tuple(map(torch.from_numpy, state)) if state else None)
    assert out.shape == (B, T, H) and h_n.shape == c_n.shape == (layers, B, H)
    for got, ref in zip((out, h_n, c_n), jax_results[case]):
        np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])
    if ragged:
        assert not out[1, LENGTHS[1]:].any() and not out[2, LENGTHS[2]:].any()
        np.testing.assert_array_equal(h_n[-1, 1].float().numpy(), out[1, LENGTHS[1] - 1].float().numpy())


def test_lstm_gradients_match_jax(jax_results):
    """The gradient of a scalar of outputs and final state by every parameter, the input
    and the initial state, against ``jax.grad`` in f32 (atol 1e-5: sums over 12 steps)."""
    (jparams, jx, jstate), weight = jax_results["grads"]
    layers, _, ragged, initial = CASES["two_layers_initial_state"]
    x, mask, state = _inputs(layers, ragged, initial)
    model, _ = _port(layers, None)
    xt = torch.from_numpy(x).requires_grad_(True)
    st = tuple(torch.from_numpy(s).requires_grad_(True) for s in state)
    out, (h_n, c_n) = model(xt, mask=torch.from_numpy(mask), initial_state=st)
    ((out * torch.from_numpy(weight)).sum() + (h_n * 0.3).sum() - (c_n * 0.7).sum()).backward()
    flat = weights.flatten(jparams)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name], atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), jx, atol=1e-5, rtol=1e-5)
    for got, ref in zip(st, jstate):
        np.testing.assert_allclose(got.grad.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_lstm_names_and_shapes_match_flax_init():
    x = np.zeros((1, 4, D), np.float32)
    variables = jax.eval_shape(lambda: JaxLSTM(hidden_size=H, num_layers=2).init(jax.random.PRNGKey(0), x))
    flax_shapes = {k: tuple(v.shape) for k, v in weights.flatten(variables["params"]).items()}
    assert weights.param_shapes(LSTM(D, H, num_layers=2)) == flax_shapes


def test_random_jax_params_gives_recurrent_parameters_the_jax_bound():
    """``w_ih_*``, ``b_ih_*``, ``w_hh_*``, ``b_hh_*`` draw U(-1/sqrt(H), 1/sqrt(H))
    (``blvm_tpu/modules/recurrent.py:32-38``) whatever their fan-in: here ``w_ih_0``
    has 64 input rows (1/8 under the Dense rule) and the biases one dim (U(-1, 1));
    the Dense layers of a model keep U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    params = weights.random_jax_params(LSTM(64, H, num_layers=2), seed=0)
    assert set(params) == {f"{w}_{layer}" for w in ("w_ih", "b_ih", "w_hh", "b_hh") for layer in (0, 1)}
    for name, value in params.items():
        assert 0.9 / np.sqrt(H) < np.abs(value).max() <= 1 / np.sqrt(H), name
    params = weights.random_jax_params(LSTMAudio(stack_size=64, hidden_size=H, num_mix=3), seed=0)
    for name, value in params.items():
        fan_in = H if name.startswith("lstm/") else params[name.replace("bias", "kernel")].shape[0]
        assert np.abs(value).max() <= 1 / np.sqrt(fan_in), name


@pytest.mark.parametrize(
    "shape,error",
    [
        (dict(H=12), "multiple of 8 up to 256"),
        (dict(H=264), "multiple of 8 up to 256"),
        (dict(w_hh=(16, 32)), "expected w_hh"),
    ],
)
def test_kernel_refusals_name_what_it_takes(shape, error):
    """The checks K5's wrapper makes before a launch (run here on CPU tensors; on the
    card ``lstm_recurrence`` raises the same before it reaches the kernel)."""
    h = shape.get("H", 16)
    xw, b_hh, hc = torch.zeros(2, 3, 4 * h), torch.zeros(4 * h), torch.zeros(2, h)
    w_hh = torch.zeros(shape.get("w_hh", (h, 4 * h)))
    with pytest.raises(ValueError, match=error):
        recurrent_ops._check(xw, w_hh, b_hh, None, hc, hc)
