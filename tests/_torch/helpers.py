"""Shared helpers of the port's tests: the same numpy inputs and weights go
through the JAX package and its PyTorch port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blvm_tpu_torch import weights


def jax_forward(model, params, x, x_sl, **kwargs):
    """Jitted JAX WaveNet forward on numpy inputs: ``(loss, mets, outputs)``."""
    fn = jax.jit(lambda p, x_, s_: model.apply({"params": p}, x_, s_, rngs={"sample": jax.random.PRNGKey(0)}, **kwargs))
    return fn(weights.unflatten(params), jnp.asarray(x), jnp.asarray(x_sl))


def torch_forward(model, x, x_sl, **kwargs):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(x_sl)), **kwargs)


def np32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)
