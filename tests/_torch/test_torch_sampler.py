"""K3's plain twin: the DMoL sampler and mode on the CPU, with supplied uniforms and by distribution."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blvm_tpu.modules.distributions import DiscretizedLogisticMixtureDense as JaxDMoLHead
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense
from blvm_tpu_torch.ops.variational import dmol_mode, dmol_sample_and_mode, rsample_discretized_logistic_mixture

CHI2_9DOF_P001 = 27.877  # chi-square critical value, 9 degrees of freedom, p = 1e-3


def _head_params(N, M, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(N, M)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-0.9, 0.9, (N, 1, M)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-6, -1, (N, 1, M)).astype(np.float32)))


def test_twin_with_supplied_uniforms_is_the_formula():
    """Fed uniforms, the twin is deterministic and computes, in f32, the Gumbel-max
    pick of U[1e-5, 1 - 1e-5] noise and the clamped logistic of U[1e-8, 1 - 1e-8]."""
    N, M = 500, 10
    logits, locs, log_scales = _head_params(N, M, 0)
    rng = np.random.default_rng(1)
    u_cat, u_log = rng.random((N, M), np.float32), rng.random((N, 1), np.float32)
    uniforms = (torch.from_numpy(u_cat), torch.from_numpy(u_log))
    a = rsample_discretized_logistic_mixture(None, logits, locs, log_scales, uniforms=uniforms)
    b = rsample_discretized_logistic_mixture(torch.Generator().manual_seed(5), logits, locs, log_scales, uniforms=uniforms)
    assert torch.equal(a, b) and a.shape == (N, 1)

    u = np.float32(1e-5) + np.float32(1 - 2e-5) * u_cat
    pick = np.argmax(logits.numpy() - np.log(-np.log(u)), axis=-1)
    v = np.float32(1e-8) + np.float32(1 - 2e-8) * u_log[:, 0]
    rows = np.arange(N)
    x = locs.numpy()[rows, 0, pick] + np.exp(log_scales.numpy()[rows, 0, pick]) * (np.log(v) - np.log1p(-v))
    np.testing.assert_allclose(a.numpy()[:, 0], np.clip(x, -1, 1), rtol=0, atol=1e-5)


def test_sample_and_mode_on_the_cpu_is_the_twin_and_the_jax_mode():
    N, M = 300, 4
    params = _head_params(N, M, 2)
    gen_a, gen_b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    sample, mode = dmol_sample_and_mode(gen_a, *params)
    assert not sample.requires_grad and torch.equal(sample, rsample_discretized_logistic_mixture(gen_b, *params))
    assert torch.equal(mode, dmol_mode(params[0], params[1]))
    jmode = JaxDMoLHead(y_dim=1, num_mix=M).mode(tuple(jnp.asarray(p.numpy()) for p in params))
    np.testing.assert_array_equal(mode.numpy(), np.asarray(jmode))

    head = DiscretizedLogisticMixtureDense(8, y_dim=1, num_mix=M)
    s2, m2 = head.sample_and_mode(torch.Generator().manual_seed(9), params)
    assert torch.equal(s2, sample) and torch.equal(m2, mode)


def test_twin_component_frequencies_and_logistic_by_distribution():
    """With its own stream: the picked components follow softmax(logits)
    (chi-square at p = 1e-3), and a one-component draw follows the logistic
    (Kolmogorov-Smirnov at p = 1e-3). Fixed seeds."""
    N, M = 200_000, 10
    logits = torch.tensor([0.5, -1.0, 2.0, 0.0, 1.0, -0.3, 0.7, -2.0, 1.5, 0.2])
    locs = (torch.arange(M, dtype=torch.float32) / 10).expand(N, 1, M)
    log_scales = torch.full((N, 1, M), -9.0)  # components 0.1 apart, spread ~1e-4: the sample names its component
    sample = rsample_discretized_logistic_mixture(torch.Generator().manual_seed(0), logits.expand(N, M), locs, log_scales)
    counts = np.bincount(np.clip(np.rint(sample[:, 0].numpy() * 10), 0, M - 1).astype(int), minlength=M)
    p = torch.softmax(logits.double(), 0).numpy()
    chi2 = float(((counts - N * p) ** 2 / (N * p)).sum())
    assert chi2 < CHI2_9DOF_P001, chi2

    mu, scale = 0.1, 0.05
    x = rsample_discretized_logistic_mixture(torch.Generator().manual_seed(1), torch.zeros(N, 1),
                                             torch.full((N, 1, 1), mu), torch.full((N, 1, 1), math.log(scale)))
    xs = np.sort(x[:, 0].numpy().astype(np.float64))
    cdf = 1 / (1 + np.exp(-(xs - mu) / scale))
    i = np.arange(1, N + 1)
    ks = max((i / N - cdf).max(), (cdf - (i - 1) / N).max())
    assert ks < 1.95 / math.sqrt(N), ks
