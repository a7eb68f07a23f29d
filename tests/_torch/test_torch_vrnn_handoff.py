"""Host-side code of K8 and K8-bwd's tagged handoffs that runs without a card: the size of the
handoff scratch against what the twins hand from stage to stage, and the status word through which
the kernels report a timeout without a wait on the host."""

import pytest
import torch

from blvm_tpu_torch.experiments import common
from blvm_tpu_torch.ops import cuda
from blvm_tpu_torch.ops import vrnn as vrnn_ops


def _twin_chain(B, T, X, H, Z, R, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = [torch.randn(*shape, generator=g) * 0.1 for shape in (
        (R, H), (H,), (H, H), (H,), (H, H), (H,), (H, 2 * Z), (2 * Z,), (R + X, H), (H,), (H, H), (H,), (H, H), (H,),
        (H, 2 * Z), (2 * Z,), (Z, H), (H,), (H, H), (H,), (H, H), (H,), (H, H), (H,), (X + H, 3 * R), (3 * R,),
        (R, 3 * R), (3 * R,))]
    x, h0, eps = torch.randn(B, T, X, generator=g), torch.randn(B, R, generator=g), torch.randn(B, T, Z, generator=g)
    xpost, xg, kw = vrnn_ops.hoist(w, x, True, True)
    outs, saved = vrnn_ops.vrnn_chain_plain(kw, xpost, xg, h0, eps, inference=True, residual_posterior=True,
                                            sd_beta=0.6931478, sd_epsilon=1e-6, save=True)
    g_out = [torch.randn(o.shape, generator=g) for o in outs]
    dpre, _ = vrnn_ops.vrnn_cell_backward_plain(kw, h0, eps, outs.h, outs.phi_z, saved, g_out,
                                                residual_posterior=True, sd_beta=0.6931478)
    return outs, saved, dpre


@pytest.mark.parametrize("B,X,H,Z,R", [(2, 8, 12, 4, 16), (3, 6, 20, 8, 12)])
def test_handoff_scratch_holds_two_copies_of_every_value_a_stage_hands_on(B, X, H, Z, R):
    """K8 hands on, a row-step, the nine saved MLP and phi activations, phi, z and h; K8-bwd every
    pre-activation gradient of the twin's but d gh's first two thirds, which are d gi's."""
    T = 3
    outs, saved, dpre = _twin_chain(B, T, X, H, Z, R)
    sf, gf = vrnn_ops.save_fields(R, H, Z), vrnn_ops.grad_fields(R, H, Z)
    acts = sum(width for name, (_, width) in sf.items() if "act" in name)
    assert acts == 9 * H
    assert vrnn_ops.handoff_words(B, R, H, Z) == 2 * B * (acts + outs.phi_z.shape[-1] + outs.z.shape[-1]
                                                          + outs.h.shape[-1])
    d_gi, d_gh = (dpre[..., gf[n][0]:gf[n][0] + gf[n][1]] for n in ("gi", "gh"))
    assert torch.equal(d_gi[..., :2 * R], d_gh[..., :2 * R])  # the shared parts: d a_r, d a_u
    assert vrnn_ops.handoff_words(B, R, H, Z, backward=True) == 2 * B * (dpre.shape[-1] - 2 * R)


def _word(monkeypatch):
    word = cuda.StatusWord(torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    monkeypatch.setattr(cuda, "_status_words", {torch.device("cpu"): word})
    return word


def test_status_word_raises_once_and_clears_both_words(monkeypatch):
    word = _word(monkeypatch)
    cuda.raise_on_status()  # nothing set: no error
    word.device[0] = 1  # a kernel gave up ...
    cuda.raise_on_status()  # ... but its copy to the host has not run yet
    word.host[0] = 1
    with pytest.raises(RuntimeError, match="gave up"):
        cuda.raise_on_status()
    assert int(word.host[0]) == 0 and int(word.device[0]) == 0
    cuda.raise_on_status()


def test_deferred_metrics_raise_before_handing_over_a_step_after_a_timeout(monkeypatch):
    """The drivers read a step's metrics where they have waited for it: a timeout in that step or
    before it raises there instead of reaching the tracker as numbers."""
    word = _word(monkeypatch)
    seen = []
    deferred = common.DeferredMetrics(seen.append, lag=1)
    deferred.push(dict(loss=torch.tensor(1.0)))
    deferred.push(dict(loss=torch.tensor(2.0)))
    assert [float(m["loss"]) for m in seen] == [1.0]
    word.host[0] = 1
    with pytest.raises(RuntimeError, match="gave up"):
        deferred.flush()
    assert len(seen) == 1
