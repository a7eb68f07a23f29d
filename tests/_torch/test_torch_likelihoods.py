"""K2's plain twin (DMoL log-mass) and the DMoL head against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blvm_tpu.modules.distributions import DiscretizedLogisticMixtureDense as JaxDMoLHead
from blvm_tpu.ops.likelihoods import discretized_logistic_mixture_ll as jax_dmol_ll
from blvm_tpu_torch.modules.distributions import DiscretizedLogisticMixtureDense, get_likelihood_head
from blvm_tpu_torch.ops import likelihoods
from blvm_tpu_torch.ops.variational import rsample_discretized_logistic_mixture


def dmol_inputs(case: str, num_bins: int, n: int = 2048, M: int = 10, seed: int = 0):
    """``(y (n, 1), logits (n, M), locs (n, 1, M), log_scales (n, 1, M))`` float32.

    random: locations near the target, as a fitted model puts them, scales
    over the head's whole range [-7, 1]. edges: targets on the lowest and
    highest bins (y = -1, +1) and tiny scales (log_scale = -7, the head's clamp)
    far from the target, where cdf_delta <= 1e-5 takes the midpoint pdf.
    """
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1, 1, (n, 1))
    logits = rng.normal(size=(n, M))
    log_scales = rng.uniform(-7, 1, (n, 1, M))
    locs = y[..., None] + 0.05 * rng.normal(size=(n, 1, M))
    if case == "edges":
        y[: n // 4] = -1.0
        y[n // 4 : n // 2] = 1.0
        y[n // 2 : 3 * n // 4] = rng.choice([2.0 / num_bins - 1.0, 1.0 - 2.0 / num_bins], (n // 4, 1))
        log_scales[3 * n // 4 :] = -7.0
        locs[3 * n // 4 :] = y[3 * n // 4 :, :, None] + rng.choice([-1, 1], (n - 3 * n // 4, 1, M)) * rng.uniform(
            0.01, 0.5, (n - 3 * n // 4, 1, M)
        )
    return tuple(a.astype(np.float32) for a in (y, logits, locs, log_scales))


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("num_bins", [256, 65536])
def test_dmol_twin_matches_jax(num_bins, case):
    """atol 1e-5 where the mass is well conditioned; where cdf_delta cancels, the
    bound of ``dmol_f32_error_bound`` (the libms' last-ulp differences in exp and
    sigmoid, amplified by the cancellation)."""
    inputs = dmol_inputs(case, num_bins)
    ref = np.asarray(jax.jit(lambda *a: jax_dmol_ll(*a, num_bins=num_bins))(*inputs))
    t = [torch.from_numpy(a) for a in inputs]
    got = likelihoods.discretized_logistic_mixture_ll(*t, num_bins=num_bins).numpy()
    bound = likelihoods.dmol_f32_error_bound(*t, num_bins=num_bins).numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= bound).all(), f"max err {err.max()} at bound {bound[err.argmax()]}"
    well_conditioned = bound < 1.5e-5
    if num_bins == 256:  # 2^16 bins cancel at almost every scale; 2^8 bins mostly do not
        assert well_conditioned.mean() > 0.1
    np.testing.assert_allclose(got[well_conditioned], ref[well_conditioned], rtol=0, atol=1e-5)


def test_dmol_ladder_branches_are_exercised():
    y, _, locs, log_scales = (torch.from_numpy(a) for a in dmol_inputs("edges", 65536))
    lp = likelihoods._dmol_elementwise(y[..., None].expand(*y.shape, 10), locs, log_scales, 65536)
    assert torch.isfinite(lp).all()
    inv = torch.exp(-log_scales)
    delta = torch.sigmoid(inv * (y[..., None] - locs + 1 / 65535)) - torch.sigmoid(inv * (y[..., None] - locs - 1 / 65535))
    assert (y < 2 / 65536 - 1).any() and (y > 1 - 2 / 65536).any()
    assert (delta <= 1e-5).any() and (delta > 1e-5).any()


def test_dmol_branch_flips_marks_only_frames_at_the_threshold():
    """A component whose cdf_delta is 1e-5 to float64 precision flags its frame;
    the same frame with the component on its target does not, nor does an edge
    bin, where the bin and not cdf_delta picks the branch."""
    num_bins = 256
    h = 1.0 / (num_bins - 1)
    lo, hi = 0.0, 20.0  # cdf_delta(c) = sigmoid(c + h) - sigmoid(c - h) falls with c > 0: bisect for 1e-5
    for _ in range(200):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if torch.sigmoid(torch.tensor(mid + h, dtype=torch.float64)) - torch.sigmoid(
            torch.tensor(mid - h, dtype=torch.float64)) > 1e-5 else (lo, mid)
    y = torch.tensor([[0.3], [0.3], [-1.0]], dtype=torch.float64)
    locs = y[..., None].expand(3, 1, 2).clone()  # a second, well-conditioned component in every frame
    locs[[0, 2], 0, 0] -= lo
    flips = likelihoods.dmol_branch_flips(y.float(), locs.float(), torch.zeros(3, 1, 2), num_bins)
    assert flips.tolist() == [True, False, False]


def test_dmol_log_prob_wrapper_on_cpu_is_the_twin():
    """On CPU tensors the K2 wrapper runs the plain twin, bit for bit."""
    t = [torch.from_numpy(a) for a in dmol_inputs("random", 65536, n=64)]
    np.testing.assert_array_equal(
        likelihoods.dmol_log_prob(*t, num_bins=65536).numpy(),
        likelihoods.discretized_logistic_mixture_ll(*t, num_bins=65536).numpy(),
    )


@pytest.mark.parametrize("num_mix", [3, 10])
def test_dmol_head_matches_jax(num_mix):
    """Parameter split, log-scale clamp at -7, log_prob and mode of the DMoL head."""
    rng = np.random.default_rng(1)
    C, num_bins = 8, 256
    x = rng.normal(size=(2, 5, C)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 5, 1)).astype(np.float32)
    kernel = rng.uniform(-1, 1, (C, 3 * num_mix)).astype(np.float32)
    bias = rng.uniform(-1, 1, (3 * num_mix,)).astype(np.float32)
    bias[2 * num_mix :] -= 7.0  # pushes some log-scales below the clamp at -7

    jhead = JaxDMoLHead(y_dim=1, num_mix=num_mix, num_bins=num_bins)
    variables = {"params": {"Dense_0": {"kernel": kernel, "bias": bias}}}


    @jax.jit
    def jax_head(variables, x, y):
        params = jhead.apply(variables, x)
        return params, jhead.log_prob(y, params), jhead.mode(params)

    jparams, jlp, jmode = jax_head(variables, jnp.asarray(x), jnp.asarray(y))

    head = DiscretizedLogisticMixtureDense(C, y_dim=1, num_mix=num_mix, num_bins=num_bins)
    with torch.no_grad():
        head.Dense_0.kernel.copy_(torch.from_numpy(kernel))
        head.Dense_0.bias.copy_(torch.from_numpy(bias))
        params = head(torch.from_numpy(x))
        lp = head.log_prob(torch.from_numpy(y), params)
        mode = head.mode(params)
    assert (params[2] >= -7.0).all() and (params[2] == -7.0).any()
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mode.numpy(), np.asarray(jmode), rtol=1e-6, atol=1e-6)


def test_dmol_sampler_distribution():
    """Samples lie in [-1, 1], pick components by their weights, and follow the
    picked logistic (compared by distribution: torch and JAX draw different bits)."""
    n = 20000
    logits = torch.log(torch.tensor([0.7, 0.3])).expand(n, 2)
    locs = torch.tensor([[-0.5, 0.5]]).expand(n, 1, 2)
    log_scales = torch.full((n, 1, 2), -4.0)
    g = torch.Generator().manual_seed(0)
    s = rsample_discretized_logistic_mixture(g, logits, locs, log_scales)[:, 0]
    assert s.shape == (n,) and (s.abs() <= 1).all()
    frac_left = (s < 0).float().mean().item()
    assert abs(frac_left - 0.7) < 0.02
    assert abs(s[s < 0].mean().item() + 0.5) < 0.01


def test_unported_heads_raise():
    with pytest.raises(NotImplementedError):
        get_likelihood_head("GMM", 8, y_dim=1)
    with pytest.raises(ValueError):
        get_likelihood_head("nope", 8, y_dim=1)
