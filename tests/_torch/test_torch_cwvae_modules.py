"""The CW-VAE slice's building blocks against the JAX package, on the CPU: the per-channel GroupNorm against
flax's, the depthwise convolutions (strided, dilated, transposed) against ``blvm_tpu.modules.convolutions``,
K11's plain twin (``ops/depthwise.py``) against the same chain built from the JAX pieces, ``BlockSeparable``
(encoder and transposed), ``ConvCoder1d`` over two levels with its right padding and its crop, the temporal
residual at a ratio that is not a power of two, and K10's plain twin (``ops/rssm.py``) against the JAX
``RSSMCell`` scanned over T' steps with the same noise: three posteriors, a context, resets, and the prior mode at
the mean; the refusals of the strides the coder cannot factor and of the card paths. Inputs and weights come from
numpy seeds; the JAX references compile once each, in module-scoped fixtures. GroupNorm runs over at least 30 rows
everywhere (it is ill-conditioned over a handful)."""

from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blvm_tpu.modules.rssm as jax_rssm
from blvm_tpu.models.clockwork_vae.conv_coders import BlockSeparable as JaxBlockSeparable
from blvm_tpu.models.clockwork_vae.conv_coders import ConvCoder1d as JaxConvCoder1d
from blvm_tpu.models.clockwork_vae.conv_coders import TemporalResidual
from blvm_tpu.modules import convolutions as jax_conv
from blvm_tpu_torch import weights
from blvm_tpu_torch.models.clockwork_vae.conv_coders import BlockSeparable, ConvCoder1d, temporal_residual_add
from blvm_tpu_torch.modules.convolutions import depthwise_conv1d, depthwise_conv_transpose1d, group_norm_channels
from blvm_tpu_torch.modules.rssm import RSSMCell
from blvm_tpu_torch.ops import depthwise as depthwise_ops
from blvm_tpu_torch.ops import rssm as rssm_ops

B, C, N, K = 3, 16, 61, 5  # the chain's rows: GroupNorm over >= 30 of them on both sides of the conv
H, Z, E, CTX, T = 16, 4, 8, 6, 12  # the RSSM cell: hidden, latent, enc and context widths, steps
# f32 throughout: the same ops in the same order, only summation orders differ (the GroupNorm's means, the convs'
# taps, the products; the hoisted gru_in and posterior columns)
TOL = dict(atol=1e-5, rtol=1e-5)
# name: (residual_posterior, precision_posterior, context, resets, inference)
RSSM_CASES = {
    "plain_posterior_with_context": (False, False, True, False, True),
    "residual_posterior": (True, False, False, False, True),
    "precision_posterior_with_context_and_resets": (False, True, True, True, True),
    "prior_at_the_mean_with_context": (False, True, True, False, False),
}
RESET_EVERY = 4


def _rng(seed):
    return np.random.default_rng(seed)


def _chain_params(seed=0, channels=C):
    rng = _rng(seed)
    return dict(scale1=1 + 0.2 * rng.normal(size=channels), bias1=0.2 * rng.normal(size=channels),
                kernel=rng.normal(scale=0.4, size=(K, 1, channels)), depthwise_bias=0.2 * rng.normal(size=channels),
                scale2=1 + 0.2 * rng.normal(size=channels), bias2=0.2 * rng.normal(size=channels))


def _f32(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def _jax_chain(u, p, stride, dilation, transposed):
    """K11's function from the JAX pieces (``conv_coders.py:121-134`` and ``:70-88`` between the 1x1s)."""
    gn = lambda x, s, b: fnn.GroupNorm(num_groups=x.shape[-1], epsilon=1e-5).apply(
        {"params": {"scale": s, "bias": b}}, x)
    g = gn(jax.nn.relu(u), p["scale1"], p["bias1"])
    if transposed:
        v = jax_conv.depthwise_conv_transpose1d(g, p["kernel"], stride=stride, padding=0, dilation=dilation)
    else:
        v = jax_conv.depthwise_conv1d(g, p["kernel"], stride=stride, dilation=dilation)
    return gn(jax.nn.relu(v + p["depthwise_bias"]), p["scale2"], p["bias2"])


CHAIN_CASES = {"strided": (4, 1, False), "dilated": (1, 2, False), "transposed": (4, 1, True),
               "transposed_dilated": (2, 3, True)}


@pytest.fixture(scope="module")
def jax_pieces():
    """One compile: flax's GroupNorm, the JAX depthwise convs, the JAX chain in every case, and the temporal
    residual at 61 -> 16 rows."""
    rng = _rng(1)
    u = rng.normal(scale=1.5, size=(B, N, C)).astype(np.float32) + 0.3
    p = _f32(_chain_params())

    def run(u_, p_):
        out = dict(
            gn=fnn.GroupNorm(num_groups=C, epsilon=1e-5).apply({"params": {"scale": p_["scale1"],
                                                                         "bias": p_["bias1"]}}, u_),
            conv=jax_conv.depthwise_conv1d(u_, p_["kernel"], stride=3, padding=(2, 1), dilation=2, impl="conv"),
            conv_t=jax_conv.depthwise_conv_transpose1d(u_, p_["kernel"], stride=4, dilation=2, impl="conv"),
            residual=TemporalResidual.add(u_, u_[:, :16] * 2.0),
        )
        for name, (s, d, tr) in CHAIN_CASES.items():
            out[name] = _jax_chain(u_, p_, s, d, tr)
        return out

    return u, p, jax.tree_util.tree_map(np.asarray, jax.jit(run)(u, p))


def test_group_norm_and_depthwise_convs_match_jax(jax_pieces):
    """``group_norm_channels`` against flax's ``GroupNorm(num_groups=C)`` (fast variance, f32); the depthwise conv
    with padding, stride and dilation and the transposed conv against the JAX functions; the temporal residual's
    nearest resampling at 61 -> 16 rows (``floor(i 61 / 16)``)."""
    u, p, ref = jax_pieces
    ut = torch.from_numpy(u)
    kernel = torch.from_numpy(p["kernel"])
    got = dict(
        gn=group_norm_channels(ut, torch.from_numpy(p["scale1"]), torch.from_numpy(p["bias1"])),
        conv=depthwise_conv1d(ut, kernel, stride=3, padding=(2, 1), dilation=2),
        conv_t=depthwise_conv_transpose1d(ut, kernel, stride=4, dilation=2),
        residual=temporal_residual_add(ut, ut[:, :16] * 2.0),
    )
    for name, value in got.items():
        assert value.shape == ref[name].shape, name
        np.testing.assert_allclose(value.numpy(), ref[name], err_msg=name, **TOL)
    idx = (np.arange(16) * N) // 16
    np.testing.assert_array_equal(got["residual"].numpy(), u[:, :16] * 2.0 + u[:, idx])


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_depthwise_norm_twin_matches_the_jax_chain(jax_pieces, case):
    """K11's twin, and its CPU entry point, against the JAX chain: relu, GroupNorm, the depthwise conv (strided,
    dilated, or transposed with its zero stuffing between normalized rows), + bias, relu, GroupNorm; the output
    length is :func:`depthwise_ops.output_length`'s."""
    u, p, ref = jax_pieces
    stride, dilation, transposed = CHAIN_CASES[case]
    args = [torch.from_numpy(v) for v in (u, p["scale1"], p["bias1"], p["kernel"], p["depthwise_bias"], p["scale2"],
                                          p["bias2"])]
    kw = dict(stride=stride, dilation=dilation, transposed=transposed)
    got = depthwise_ops.depthwise_norm_plain(*args, **kw)
    assert torch.equal(depthwise_ops.depthwise_norm(*args, **kw), got)
    assert got.shape == (B, depthwise_ops.output_length(N, K, stride, dilation, transposed), C) == ref[case].shape
    np.testing.assert_allclose(got.numpy(), ref[case], **TOL)


def _block_pair(transposed, seed):
    block = BlockSeparable(8, K, 4, 1, transposed)
    params = weights.random_jax_params(block, seed)
    rng = _rng(seed)
    for name in params:  # GroupNorm and the depthwise bias away from their init, to test their use
        if "GroupNorm" in name or name.endswith("depthwise_bias"):
            params[name] = (params[name] + 0.2 * rng.normal(size=params[name].shape)).astype(np.float32)
    weights.load_jax_params(block, params)
    return block, params


@pytest.fixture(scope="module")
def jax_blocks():
    """The JAX ``BlockSeparable`` encoder (stride 4) and transposed block, and a two-level ``ConvCoder1d`` encoder
    with right padding and its transposed decoder with the crop, one compile each."""
    rng = _rng(2)
    x_enc = rng.normal(size=(2, 130, 8)).astype(np.float32)
    x_dec = rng.normal(size=(2, 33, 8)).astype(np.float32)
    out = {}
    for transposed, x in ((False, x_enc), (True, x_dec)):
        _, params = _block_pair(transposed, 3 + transposed)
        jblock = JaxBlockSeparable(channels_bottleneck=8, kernel_size=K, stride=4, dilation=1, transposed=transposed)
        out[transposed] = x, np.asarray(jax.jit(lambda p_, x_: jblock.apply({"params": p_}, x_))(
            weights.unflatten(params), x))
    coder_kw = dict(strides=(16, 4), channels=8, kernel_size=K, stride_per_block=4, num_blocks=3)
    enc, dec = ConvCoder1d(channels_in=1, **coder_kw), ConvCoder1d(channels_in=(12, 12), channels_out=(8, None),
                                                                     transposed=True, **coder_kw)
    jenc = JaxConvCoder1d(channels_in=1, **coder_kw)
    jdec = JaxConvCoder1d(channels_in=(12, 12), channels_out=(8, None), transposed=True, **coder_kw)
    pe, pd = weights.random_jax_params(enc, 5), weights.random_jax_params(dec, 6)
    xs = rng.normal(size=(2, 2600, 1)).astype(np.float32)
    ctx = rng.normal(size=(2, 31, 12)).astype(np.float32)
    pads = [11, 3]

    def coders(pe_, pd_, xs_, ctx_):
        encodings = jenc.apply({"params": pe_}, xs_, pad_right=pads)
        _, context = jdec.apply({"params": pd_}, ctx_, level=1, pad_right=pads[1], method=JaxConvCoder1d.forward_level)
        return encodings, context

    out["coders"] = (pe, pd, xs, ctx, pads, jax.tree_util.tree_map(np.asarray, jax.jit(coders)(
        weights.unflatten(pe), weights.unflatten(pd), xs, ctx)))
    return out


@pytest.mark.parametrize("transposed", [False, True])
def test_block_separable_matches_jax(jax_blocks, transposed):
    """``BlockSeparable`` through K11's twin: the 1x1 expansion, the chain, the pointwise 1x1 and the temporal
    residual against the JAX block, strided (130 -> 32 rows) and transposed (33 -> 133 rows)."""
    x, ref = jax_blocks[transposed]
    block, _ = _block_pair(transposed, 3 + transposed)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_conv_coders_match_jax_with_padding_and_crop(jax_blocks):
    """A two-level encoder (strides 16 and 4 in blocks of 4, the in-projection at level 0) with its right padding
    a level, and the transposed decoder's level 1 (blocks in reverse, in-projection, the crop after them), against
    the JAX ``ConvCoder1d``; the geometry's receptive fields and ``e_size`` are JAX's."""
    pe, pd, xs, ctx, pads, (jencodings, jcontext) = jax_blocks["coders"]
    coder_kw = dict(strides=(16, 4), channels=8, kernel_size=K, stride_per_block=4, num_blocks=3)
    enc, dec = ConvCoder1d(channels_in=1, **coder_kw), ConvCoder1d(channels_in=(12, 12), channels_out=(8, None),
                                                                     transposed=True, **coder_kw)
    weights.load_jax_params(enc, pe)
    weights.load_jax_params(dec, pd)
    with torch.no_grad():
        encodings = enc(torch.from_numpy(xs), pad_right=pads)
        _, context = dec.forward_level(torch.from_numpy(ctx), level=1, pad_right=pads[1])
    for got, ref in zip(encodings, jencodings):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert context.shape == jcontext.shape
    np.testing.assert_allclose(context.numpy(), jcontext, **TOL)
    jenc = JaxConvCoder1d(channels_in=1, **coder_kw)
    assert (enc.receptive_fields, enc.overall_receptive_fields, enc.e_size, dec.e_size) == (
        jenc.receptive_fields, jenc.overall_receptive_fields, jenc.e_size, [8, 8])


@pytest.mark.parametrize("strides", [(64, 8), (256,), (64, 16)])
def test_level_geometry_refuses_what_jax_refuses(strides):
    """At the drivers' 3 blocks of stride 4 the JAX package cannot build strides [64, 8] (a remaining stride of 2)
    or [256] (too few blocks); the port raises the same errors; [64, 16] builds alike."""
    args = (strides, K, 4, 3)
    try:
        expected = JaxConvCoder1d.level_geometry(*args)
    except (AssertionError, ValueError) as err:
        with pytest.raises(type(err), match=str(err).split("[")[0].split("(")[0][:20]):
            ConvCoder1d.level_geometry(*args)
    else:
        assert ConvCoder1d.level_geometry(*args) == expected


def _cell(case, seed=7):
    residual, precision, context, _, _ = RSSM_CASES[case]
    cell = RSSMCell(Z, H, CTX if context else 0, E, residual_posterior=residual, precision_posterior=precision)
    params = weights.random_jax_params(cell, seed)
    weights.load_jax_params(cell, params)
    return cell, params


def _rssm_inputs(case, seed=8):
    rng = _rng(seed)
    _, _, context, _, _ = RSSM_CASES[case]
    return (rng.normal(size=(B, T, E)).astype(np.float32),
            rng.normal(size=(B, T, CTX if context else 0)).astype(np.float32),
            rng.normal(scale=0.5, size=(B, Z)).astype(np.float32), rng.normal(scale=0.5, size=(B, H)).astype(np.float32),
            rng.normal(size=(B, T, Z)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_rssm_runs():
    """Every case through the JAX ``RSSMCell`` (``__call__`` in inference mode, ``generate`` in prior mode) under
    ``jax.lax.scan``, its ``rsample_gaussian`` made ``mu + sd * e_t`` (e_t the traced step's noise; zeros in prior
    mode: the mean), the carry zeroed at every 4th step where the case resets, as ``CWVAE._run_level`` does."""
    runs = {}
    for case, (residual, precision, context, resets, inference) in RSSM_CASES.items():
        _, params = _cell(case)
        jcell = jax_rssm.RSSMCell(z_dim=Z, h_dim=H, c_dim=CTX if context else 0, e_dim=E,
                                  residual_posterior=residual, precision_posterior=precision)
        tree = {"params": weights.unflatten(params)}
        enc, ctx, z0, h0, eps = _rssm_inputs(case)
        holder = {}

        def body(carry, xs, jcell=jcell, tree=tree, resets=resets, inference=inference, holder=holder):
            enc_t, ctx_t, e_t, t = xs
            z, h = carry
            if resets:
                keep = (t % RESET_EVERY != 0).astype(z.dtype)
                z, h = z * keep, h * keep
            holder["eps"] = e_t if inference else jnp.zeros_like(e_t)
            key = jax.random.PRNGKey(0)
            if inference:
                state, dists = jcell.apply(tree, enc_t, (z, h), ctx_t, key)
            else:
                state, dists = jcell.apply(tree, (z, h), ctx_t, key, method=jax_rssm.RSSMCell.generate)
            return state, dict(h=state[1], **dists)

        xs = tuple(jnp.swapaxes(v, 0, 1) for v in (enc, ctx, eps)) + (jnp.arange(T),)
        with mock.patch.object(jax_rssm, "rsample_gaussian", lambda key, mu, sd: mu + sd * holder["eps"]):
            _, outs = jax.jit(lambda: jax.lax.scan(body, (z0, h0), xs))()
        runs[case] = {k: np.asarray(jnp.swapaxes(v, 0, 1)) for k, v in outs.items()}
    return runs


@pytest.mark.parametrize("case", list(RSSM_CASES))
def test_rssm_chain_twin_matches_jax_cell(jax_rssm_runs, case):
    """K10's twin over T' = 12 steps against the JAX cell fed the same noise: z, h and both heads' mu and sd (the
    posterior's after its combination with the prior); the CPU entry point is the twin, and ``RSSMCell.run``
    hoists the context and enc columns itself."""
    residual, precision, context, resets, inference = RSSM_CASES[case]
    cell, _ = _cell(case)
    enc, ctx, z0, h0, eps = (torch.from_numpy(v) for v in _rssm_inputs(case))
    reset_mask = torch.arange(T) % RESET_EVERY == 0 if resets else None
    noise = eps if inference else torch.zeros_like(eps)
    head = cell.prior_head
    kw = dict(inference=inference, residual_posterior=residual, precision_posterior=precision, sd_beta=head.beta,
              sd_epsilon=head.epsilon)
    with torch.no_grad():
        xg, xq, kernel_weights = rssm_ops.hoist(cell.chain_weights(), enc, ctx, inference)
        got = rssm_ops.rssm_chain_plain(kernel_weights, xg, xq, z0, h0, noise, reset_mask, **kw)
        again = rssm_ops.rssm_chain(kernel_weights, xg, xq, z0, h0, noise, reset_mask, **kw)
        via_cell = cell.run(enc if inference else None, ctx, z0, h0, noise, reset_mask, inference=inference)
        at_mode = cell.run(None, ctx, z0, h0, None, inference=False, use_mode=True) if not inference else None
    ref = jax_rssm_runs[case]
    for name, value in got._asdict().items():
        assert (torch.equal(getattr(again, name), value) and torch.equal(getattr(via_cell, name), value)
                if value is not None else getattr(again, name) is None)
        if value is None:
            assert not inference and name.startswith("enc_")
            continue
        np.testing.assert_allclose(value.numpy(), ref[name], err_msg=name, **TOL)
    if at_mode is not None:  # the prior's mean: use_mode and zero noise are one rollout
        assert torch.equal(at_mode.z, got.z)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrappers' refusals before any launch."""

    @property
    def is_cuda(self):
        return True


def test_card_paths_refuse_gradients_and_unported_shapes():
    """On the card K10's prior mode (a generation) has no backward: under a gradient it raises
    ``NotImplementedError`` before a launch, never running a twin (the inference mode's gradient is K10-bwd's); K11
    refuses a dtype other than f32 and a width that is not a multiple of 4, with or without a gradient, before a
    launch."""
    cell, _ = _cell("prior_at_the_mean_with_context")
    enc, ctx, z0, h0, eps = (torch.from_numpy(v).as_subclass(_OnTheCard)
                             for v in _rssm_inputs("prior_at_the_mean_with_context"))
    xg, _, kernel_weights = rssm_ops.hoist(cell.chain_weights(), None, ctx, False)
    assert xg.requires_grad and xg.is_cuda
    with pytest.raises(NotImplementedError, match="inference mode only"):
        rssm_ops.rssm_chain(kernel_weights, xg, None, z0, h0, eps, inference=False, residual_posterior=False,
                            precision_posterior=True, sd_beta=1.0, sd_epsilon=1e-6)
    p = {k: torch.from_numpy(v).float() for k, v in _chain_params().items()}
    u = torch.ones(1, 40, C).as_subclass(_OnTheCard)
    chain = [p["scale1"], p["bias1"], p["kernel"], p["depthwise_bias"], p["scale2"], p["bias2"]]
    with pytest.raises(NotImplementedError, match="float32"):
        depthwise_ops.depthwise_norm(u.double(), *(t.clone().requires_grad_(True) for t in chain), stride=4,
                                     dilation=1, transposed=False)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="float32"):
        depthwise_ops.depthwise_norm(u.double(), *chain, stride=4, dilation=1, transposed=False)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="multiple of 4"):
        depthwise_ops.depthwise_norm(u[..., :6], *(t[..., :6] for t in chain), stride=4, dilation=1,
                                     transposed=False)
