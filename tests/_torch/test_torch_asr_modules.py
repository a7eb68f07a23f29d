"""The CTC probe's modules in the port against the JAX package on the CPU: ``LSTMBlock`` (K6's twin
``bilstm_recurrence_plain`` for a bidirectional layer, K5's for a unidirectional one) against the JAX
``LSTMBlock`` bidirectional, summing its directions, unidirectional and returning every layer, in f32
(atol 1e-5) and f64 (1e-10); ``BiLSTMRecurrenceFunction`` (K6's save twin and
``bilstm_recurrence_backward_plain``) against autograd of the twin; the CTC loss (K13's twin)
against ``optax.ctc_loss`` on feasible, repeated-label, all-padding and infeasible rows (rtol 1e-6, and
its gradient against ``jax.grad`` in f64); ``SimpleLSTMASR``'s loss, ``build_metrics`` and whole gradient
(``jax.grad`` in f64, relative norm 1e-8). Small sizes: H = 16, 2 layers, D = 8, B = 4 with a row of
length 0, T = 24, the real 65-token phone map. Inputs and weights come from numpy seeds; each JAX
reference compiles once, at XLA's CPU optimization level 0."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from blvm_tpu.models.lstm_asr import SimpleLSTMASR as JaxSimpleLSTMASR
from blvm_tpu.modules.lstm_block import LSTMBlock as JaxLSTMBlock
from blvm_tpu_torch import weights
from blvm_tpu_torch.data.tokens import TIMIT_PHONESET
from blvm_tpu_torch.data.token_map import TokenMap
from blvm_tpu_torch.models import SimpleLSTMASR
from blvm_tpu_torch.modules.lstm_block import LSTMBlock
from blvm_tpu_torch.ops import ctc
from blvm_tpu_torch.ops import recurrent as recurrent_ops

H, LAYERS, D, T = 16, 2, 8, 24
X_SL = np.asarray([24, 17, 0, 9])
Y_SL = np.asarray([6, 4, 0, 3])
N_LABELS = 16
# name: LSTMBlock keyword arguments
BLOCK_CASES = {
    "bidirectional_return_all": dict(bidirectional=True, return_all=True),
    "sum_directions": dict(bidirectional=True, sum_directions=True),
    "unidirectional": dict(bidirectional=False),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the twins' per-step products are tiny, and torch's thread pool costs
    more than they do (several times the run on a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's CPU backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(X_SL), T, D)).astype(np.float32)
    y = np.zeros((len(X_SL), N_LABELS), np.int64)
    for b, n in enumerate(Y_SL):
        y[b, :n] = rng.integers(1, 65, n)
    y[0, 2] = y[0, 1]  # a repeated label: a blank must lie between
    return x, y


def _block(kwargs, dtype=torch.float32):
    block = LSTMBlock(D, H, num_layers=LAYERS, dropout_prob=0.0, device="cpu", **kwargs)
    params = weights.random_jax_params(block, seed=3)
    weights.load_jax_params(block, params)
    return block.to(dtype), params


@pytest.fixture(scope="module")
def jax_blocks():
    """Each case's JAX outputs in f32 and f64 (every layer's under ``return_all``)."""
    x, _ = _inputs()
    out = {}
    for name, kwargs in BLOCK_CASES.items():
        _, params = _block(kwargs)
        model = JaxLSTMBlock(hidden_size=H, num_layers=LAYERS, dropout_prob=0.0, **kwargs)
        fn = lambda p, x_, s_: model.apply({"params": p}, x_, s_)[0]  # noqa: E731
        tree = weights.unflatten(params)
        out[name] = {"f32": _compiled(fn, tree, jnp.asarray(x), jnp.asarray(X_SL))(tree, jnp.asarray(x),
                                                                                     jnp.asarray(X_SL))}
        with jax.enable_x64(True):
            tree64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
            x64 = jnp.asarray(x, jnp.float64)
            out[name]["f64"] = _compiled(fn, tree64, x64, jnp.asarray(X_SL))(tree64, x64, jnp.asarray(X_SL))
        out[name] = jax.tree_util.tree_map(np.asarray, out[name])
    return out


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_lstm_block_matches_jax(jax_blocks, case, dtype):
    torch_dtype, atol = (torch.float32, 1e-5) if dtype == "f32" else (torch.float64, 1e-10)
    block, _ = _block(BLOCK_CASES[case], torch_dtype)
    x, _ = _inputs()
    with torch.no_grad():
        got, sl = block(torch.from_numpy(x).to(torch_dtype), torch.from_numpy(X_SL))
    ref = jax_blocks[case][dtype]
    got = got if isinstance(got, list) else [got]
    ref = ref if isinstance(ref, list) else [ref]
    assert len(got) == len(ref) and torch.equal(sl, torch.from_numpy(X_SL))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch_dtype
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol)
    assert not got[-1][2].any() and not got[-1][3, X_SL[3]:].any()  # zeros past each length


def test_lstm_block_temporal_dropout_keeps_one_mask_over_time():
    block = LSTMBlock(D, H, num_layers=LAYERS, dropout_prob=0.5, return_all=True, device="cpu")
    x, _ = _inputs()
    outs, _ = block(torch.from_numpy(x), torch.from_numpy(X_SL), deterministic=False,
                    generator=torch.Generator().manual_seed(0))
    for layer in outs:  # a dropped feature of a row is zero at every step of the row
        dropped = (layer[0] == 0).all(dim=0)
        assert 0 < int(dropped.sum()) < 2 * H and not (layer[0][:, ~dropped] == 0).all(dim=0).any()
    with pytest.raises(ValueError, match="bidirectional to sum"):
        LSTMBlock(D, H, bidirectional=False, sum_directions=True)


def test_bilstm_function_gradients_equal_autograd_of_the_twin():
    """K6's Function on the CPU (the save twin, then ``bilstm_recurrence_backward_plain`` and the weight
    products) against autograd of the forward twin, f64, ragged rows with one of length 0."""
    rng = np.random.default_rng(5)
    B, Hs = 4, 8
    leaves = [torch.from_numpy(rng.standard_normal(s) * 0.5).requires_grad_(True)
              for s in ((B, 11, 8 * Hs), (2, Hs, 4 * Hs), (2, 4 * Hs))]
    mask = (torch.arange(11)[None] < torch.tensor([11, 6, 0, 1])[:, None]).double()
    d_out = torch.from_numpy(rng.standard_normal((B, 11, 2 * Hs)))
    ref = torch.autograd.grad((recurrent_ops.bilstm_recurrence_plain(*leaves, mask) * d_out).sum(), leaves)
    out = recurrent_ops.bilstm_recurrence(*leaves, mask)
    assert out.grad_fn.name().startswith("BiLSTMRecurrenceFunction")
    got = torch.autograd.grad((out * d_out).sum(), leaves)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12, atol=1e-13)
    assert not got[0][2].any()  # the all-padding row


def _ctc_case(seed=6):
    """Rows: feasible, a run of repeats, all padding, infeasible (more labels than frames), labels
    with a repeat that just fit."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((5, 12, 7)) * 2
    z_sl, y_sl = np.asarray([12, 9, 0, 3, 5]), np.asarray([4, 4, 0, 5, 4])
    y = np.zeros((5, 6), np.int64)
    for b, n in enumerate(y_sl):
        y[b, :n] = rng.integers(1, 7, n)
    y[1, :4] = 3
    y[4, :4] = [2, 2, 4, 5]
    return logits, z_sl, y, y_sl


CTC_ROWS = ("feasible", "repeats", "all_padding", "infeasible", "repeat_that_fits")  # _ctc_case's rows


@pytest.fixture(scope="module")
def optax_ctc():
    """``optax.ctc_loss`` on :func:`_ctc_case`: the per-example losses in f64 and f32 and, in f64, the gradient
    of their sum with respect to the logits; each compiled once."""
    logits, z_sl, y, y_sl = _ctc_case()

    def optax_loss(lg):
        paddings = (jnp.arange(12)[None] >= jnp.asarray(z_sl)[:, None]).astype(lg.dtype)
        label_paddings = (jnp.arange(6)[None] >= jnp.asarray(y_sl)[:, None]).astype(lg.dtype)
        return optax.ctc_loss(lg, paddings, jnp.asarray(y), label_paddings, blank_id=0)

    def value_and_grad(lg):
        per_example, vjp = jax.vjp(optax_loss, lg)
        return per_example, vjp(jnp.ones_like(per_example))[0]

    with jax.enable_x64(True):
        lg64 = jnp.asarray(logits)
        ref64, ref_grad = (np.asarray(a) for a in _compiled(value_and_grad, lg64)(lg64))
    lg32 = jnp.asarray(logits, jnp.float32)
    return dict(ref64=ref64, ref_grad=ref_grad, ref32=np.asarray(_compiled(optax_loss, lg32)(lg32)))


def test_ctc_loss_equals_optax_on_every_kind_of_row(optax_ctc):
    """K13's twin (the CPU path of ``ctc_loss``) against ``optax.ctc_loss``: the same values on every row,
    the infeasible row's finite log-epsilon score included (PyTorch's ``F.ctc_loss`` gives ``inf`` there),
    and in f64 the same gradient."""
    logits, z_sl, y, y_sl = _ctc_case()
    for dtype, ref in ((torch.float64, optax_ctc["ref64"]), (torch.float32, optax_ctc["ref32"])):
        lg = torch.from_numpy(logits).to(dtype).requires_grad_(True)
        args = (torch.from_numpy(z_sl), torch.from_numpy(y), torch.from_numpy(y_sl))
        got = ctc.ctc_loss(lg, *args)
        assert torch.isfinite(got).all() and got.dtype == dtype
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6)
        assert ref[3] > 9e4 and np.signbit(got[2].item())  # optax's finite log-epsilon score; -0.0
        library = F.ctc_loss(torch.log_softmax(lg.detach(), -1).transpose(0, 1), args[1], args[0], args[2],
                             reduction="none")
        assert torch.isinf(library[3]) and torch.allclose(library[[0, 1, 4]], got.detach()[[0, 1, 4]], rtol=1e-5)
        if dtype == torch.float64:
            (grad,) = torch.autograd.grad(got.sum(), lg)
            np.testing.assert_allclose(grad.numpy(), optax_ctc["ref_grad"], rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def ctc_alpha_beta():
    """K13-bwd's twin on :func:`_ctc_case` in f64: the states, the losses of ``ctc_loss_plain``, and the
    gradient of the logits through ``ctc_loss_grad_plain`` with row weights 1 and 0.5-1.5, the latter beside
    autograd of ``ctc_loss_plain``."""
    logits, z_sl, y, y_sl = (torch.from_numpy(a) for a in _ctc_case())
    lg = logits.requires_grad_(True)
    lp = torch.log_softmax(lg, -1)
    alpha, beta = ctc.ctc_alpha_beta_plain(lp.detach(), z_sl, y, y_sl)
    loss = ctc.ctc_loss_plain(lg, z_sl, y, y_sl)
    w = torch.linspace(0.5, 1.5, len(CTC_ROWS), dtype=torch.float64)
    out = dict(alpha=alpha, beta=beta, loss=loss.detach(), autograd=torch.autograd.grad((loss * w).sum(), lg)[0])
    for key, g in (("ones", torch.ones_like(w)), ("weighted", w)):
        d_lp = ctc.ctc_loss_grad_plain(alpha, beta, y, z_sl, g, logits.shape[2])
        out[key] = torch.autograd.grad(lp, lg, d_lp, retain_graph=True)[0]
    return out


@pytest.mark.parametrize("row", range(len(CTC_ROWS)), ids=CTC_ROWS)
def test_ctc_alpha_beta_gradient_equals_optax_on_every_kind_of_row(optax_ctc, ctc_alpha_beta, row):
    """The alpha-beta form that K13-bwd computes, in plain PyTorch: a frame's gradient is the posterior of the
    states after it. On each kind of row it equals ``jax.grad`` of ``optax.ctc_loss`` in f64 (rtol 1e-6, atol
    1e-9, as the twin's own gradient) and autograd of ``ctc_loss_plain``; the log-likelihood it normalizes by,
    logsumexp(alpha + beta) at any frame, is the loss's."""
    ab = ctc_alpha_beta
    np.testing.assert_allclose(ab["ones"][row].numpy(), optax_ctc["ref_grad"][row], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ab["weighted"][row].numpy(), ab["autograd"][row].numpy(), rtol=1e-9, atol=1e-11)
    frames = int(_ctc_case()[1][row])
    log_likelihood = torch.logsumexp(ab["alpha"][row, :frames + 1] + ab["beta"][row, :frames + 1], -1)
    np.testing.assert_allclose(log_likelihood.numpy(), -ab["loss"][row].item(), rtol=1e-12, atol=1e-9)
    assert not ab["ones"][row, frames:].any()


@pytest.mark.parametrize("row", range(len(CTC_ROWS)), ids=CTC_ROWS)
def test_ctc_states_past_the_labels_have_no_path_to_the_loss(ctc_alpha_beta, row):
    """Of a row's 2N + 1 states only the 2 y_sl + 1 live ones (phi up to y_sl, emit below it) reach the loss:
    beta is ``-inf`` on the rest at every frame the row covers, so they carry no posterior. K13's save mode
    writes the live states alone and K13-bwd reads them alone."""
    _, z_sl, y, y_sl = _ctc_case()
    N, ls, frames = y.shape[1], int(y_sl[row]), int(z_sl[row])
    beta = ctc_alpha_beta["beta"][row, :frames + 1]
    dead = torch.ones(2 * N + 1, dtype=torch.bool)
    dead[:ls + 1] = False
    dead[N + 1:N + 1 + ls] = False
    assert torch.isneginf(beta[:, dead]).all()
    assert (beta[-1, ~dead] == 0).sum() == min(ls, 1) + 1  # the states the loss reads


def _asr_model(dtype=torch.float32):
    token_map = TokenMap(list(TIMIT_PHONESET), add_blank=True)
    model = SimpleLSTMASR.from_token_map(token_map, input_size=D, hidden_size=H, num_layers=LAYERS, bidirectional=True,
                                         device="cpu")
    params = weights.random_jax_params(model, seed=7)
    weights.load_jax_params(model, params)
    return model.to(dtype), params


@pytest.fixture(scope="module")
def jax_asr():
    """The JAX model's loss, per-example losses and logits in f32, and its loss and gradient in f64."""
    model, params = _asr_model()
    jmodel = JaxSimpleLSTMASR(vocab=tuple(model.vocab), input_size=D, hidden_size=H, num_layers=LAYERS,
                              bidirectional=True, dropout_prob=0.0)
    x, y = _inputs()
    data = [jnp.asarray(a) for a in (x, X_SL, y, Y_SL)]

    def fwd(p, *a):
        loss, mets, _ = jmodel.apply({"params": p}, *a)
        return loss, mets

    tree = weights.unflatten(params)
    loss, mets = _compiled(fwd, tree, *data)(tree, *data)
    out = dict(loss=float(loss), mets=jax.tree_util.tree_map(np.asarray, mets), model=jmodel)
    with jax.enable_x64(True):
        tree64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        data64 = [jnp.asarray(x, jnp.float64), *data[1:]]  # JAX's LSTM carries the features' type
        grad_fn = jax.value_and_grad(lambda p, *a: fwd(p, *a)[0])
        loss64, grads = _compiled(grad_fn, tree64, *data64)(tree64, *data64)
        out.update(loss64=float(loss64), grads=weights.flatten(jax.tree_util.tree_map(np.asarray, grads)))
    return out


def test_simple_lstm_asr_loss_and_metrics_match_jax(jax_asr):
    model, _ = _asr_model()
    x, y = _inputs()
    model.eval()
    with torch.no_grad():
        loss, mets, outputs = model(torch.from_numpy(x), torch.from_numpy(X_SL), torch.from_numpy(y),
                                    torch.from_numpy(Y_SL))
    ref = jax_asr["mets"]
    assert set(mets) == set(ref) == {"loss", "per_example", "logits", "z_sl", "y", "y_sl"}
    np.testing.assert_allclose(loss.item(), jax_asr["loss"], rtol=1e-6)
    np.testing.assert_allclose(mets["per_example"].numpy(), ref["per_example"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mets["logits"].numpy(), ref["logits"], rtol=0, atol=1e-5)
    assert outputs.logits.shape == (4, T, 65) and torch.equal(outputs.sl, torch.from_numpy(X_SL))
    host = {k: v.numpy() for k, v in mets.items()}
    metrics, hyps, refs = model.build_metrics(host)
    jmetrics, jhyps, jrefs = jax_asr["model"].build_metrics(ref)
    assert (hyps, refs) == (jhyps, jrefs) and len(refs) == 3  # the row without labels dropped
    for m, jm in zip(metrics, jmetrics):
        assert m.name == jm.name
        np.testing.assert_allclose(m.value, jm.value, rtol=1e-6)
    assert model.token_map().tokens == list(model.vocab) and model.vocab[0] == "%"
    (xe, sle, ye, ysle), _ = model.example_inputs()
    assert xe.shape == (1, 8, D) and ye.shape == (1, 4)


def test_simple_lstm_asr_gradient_matches_jax_grad(jax_asr):
    """The whole model's gradient in f64 (K6's Function on the CPU, the dense head, the CTC loss through
    ``log_softmax``) against ``jax.grad``: relative norm at most 1e-8 for every parameter."""
    model, _ = _asr_model(torch.float64)
    x, y = _inputs()
    model.train()  # dropout 0: the same forward
    loss, _, _ = model(torch.from_numpy(x), torch.from_numpy(X_SL), torch.from_numpy(y), torch.from_numpy(Y_SL))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_asr["loss64"], rtol=1e-12)
    grads = {name.replace(".", "/"): p.grad.numpy() for name, p in model.named_parameters()}
    assert set(grads) == set(jax_asr["grads"])
    for name, g in grads.items():
        r = jax_asr["grads"][name]
        assert np.linalg.norm(g - r) <= 1e-8 * np.linalg.norm(r), name
