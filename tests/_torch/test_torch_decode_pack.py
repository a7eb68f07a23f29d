"""The weight layouts of the two persistent frame loops against the flax parameters they come from: K4's resident
route (``pack_wavenet_resident``: mma.sync A fragments, a tile's rows paired tanh/sigmoid and r/s) and K12's
per-CTA weight streams (``stcn_stages`` and ``pack_stcn_stream``: unit u with CTA u % NB, warp u // NB). Each
packed layout is read back the way its kernel reads it and held to the flax kernels of the same names, loaded
into the port's model through ``weights.load_jax_params``."""

import numpy as np
import pytest
import torch

from blvm_tpu_torch import weights
from blvm_tpu_torch.models import STCN, WaveNet
from blvm_tpu_torch.ops import generation


def fragment_product(frag: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A @ v for A held as m16n8k16 A fragments (Mt, Kt, 32, 8), read by the PTX register layout: lane l, g = l // 4,
    t = l % 4, holds rows g (values 0, 1, 4, 5) and g + 8 (2, 3, 6, 7), columns 2t + (i & 1), + 8 for values 4-7."""
    Mt, Kt = frag.shape[:2]
    lane, i = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
    row = lane // 4 + np.where(np.isin(i, (2, 3, 6, 7)), 8, 0)
    col = 2 * (lane % 4) + (i & 1) + np.where(i >= 4, 8, 0)
    a = np.zeros((Mt, 16, Kt, 16))
    for mt in range(Mt):
        for kt in range(Kt):
            a[mt, row, kt, col] = frag[mt, kt]
    return a.reshape(16 * Mt, 16 * Kt) @ v


def paired(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    """(2 n, in): tile mt's rows 0-7 units 8 mt .. 8 mt + 7 of ``first`` (in, n), rows 8-15 the same of ``second``."""
    n = first.shape[1]
    rows = [first[:, 8 * mt + r] if r < 8 else second[:, 8 * mt + r - 8] for mt in range(n // 8) for r in range(16)]
    return np.stack(rows)


def test_wavenet_resident_fragments_hold_the_flax_kernels():
    model = WaveNet(n_layers=2, n_stacks=1, res_channels=96, num_mix=10, num_bins=256, bf16=True)
    flat = weights.random_jax_params(model, 3)
    weights.load_jax_params(model, flat)
    packed = generation.pack_wavenet_resident(model)
    assert packed["w_blocks"].shape == (2, 3, 12, 6, 32, 8) and packed["w_blocks"].dtype == torch.bfloat16
    assert packed["w_in"].shape == (6, 6, 32, 8)
    v = np.random.default_rng(0).standard_normal((96, 3))

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).double().numpy()

    for l in range(2):
        p = {k.split("/")[-1]: flat[k] for k in flat if k.startswith(f"res_stack/Conv1dResidualGLU_{l}/")}
        rs = p["rs_kernel"][0]
        expected = [paired(p["gate_kernel_t"][k], p["gate_kernel_s"][k]) for k in (0, 1)] + [paired(rs[:, :96], rs[:, 96:])]
        for m, a in enumerate(expected):
            got = fragment_product(packed["w_blocks"][l, m].double().numpy(), v)
            np.testing.assert_allclose(got, bf(a) @ v, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(
            packed["b_blocks"][l].float().numpy(),
            bf(np.stack([p["gate_bias_t"], p["gate_bias_s"], p["rs_bias"][:96], p["rs_bias"][96:]])))
    got = fragment_product(packed["w_in"].double().numpy(), v)
    np.testing.assert_allclose(got, bf(flat["res_stack/Conv1d_0/kernel"][0].T) @ v, rtol=1e-12, atol=1e-12)
    head = flat["likelihood_head/Dense_0/kernel"]
    np.testing.assert_array_equal(packed["w_head"].numpy()[:, :30], head)
    assert not packed["w_head"][:, 30:].any()
    np.testing.assert_array_equal(packed["w_out"].numpy(), flat["out_transform/Dense_0/kernel"])


@pytest.mark.parametrize("NB", [16, 5])
def test_stcn_streams_hold_the_flax_kernels(NB):
    model = STCN(n_layers=2, latent_size=(8, 4), res_channels=16)
    flat = weights.random_jax_params(model, 5)
    weights.load_jax_params(model, flat)
    with torch.no_grad():
        stream, offsets = generation.pack_stcn_stream(generation.stcn_stages(model), NB)
    stream = stream.numpy()

    def glu(stack, i, keep_skip):
        p = {k.split("/")[-1]: flat[k] for k in flat if k.startswith(f"{stack}/Conv1dResidualGLU_{i}/")}
        gate = np.stack([np.concatenate([p[f"gate_kernel_{b}"][0], p[f"gate_kernel_{b}"][1]]).T for b in "ts"])
        rs = p["rs_kernel"][0].T
        return [gate, (rs if keep_skip else rs[:16])[None]]

    def mlps(l, i):
        return np.concatenate([flat[f"prior_{l}/MLP_{j}/Dense_{i}/kernel"].T for j in (0, 1)])

    expected = [flat["res_stack/Conv1d_0/kernel"][0].T[None]]
    for i in range(4):  # blocks 1 and 3 feed the two levels
        expected += glu("res_stack", i, i in (1, 3))
    for l in (1, 0):
        expected += [mlps(l, 0)[None], mlps(l, 1)[None],
                     np.stack([flat[f"prior_{l}/MLP_{j}/Dense_2/kernel"].T for j in (0, 1)])]
    expected.append(flat["out_transform/Conv1d_0/kernel"][0].T[None])
    for i in range(2):
        expected += glu("out_transform", i, True)
    assert len(offsets) == len(expected) + 1 and stream.shape == (NB, offsets[-1])
    for s, w in enumerate(expected):
        ndot, U, K = w.shape
        nmax = -(-U // NB)
        assert offsets[s + 1] - offsets[s] == nmax * ndot * K
        for c in range(NB):
            chunk = stream[c, offsets[s]:offsets[s + 1]].reshape(nmax, ndot, K)
            for warp in range(nmax):
                u = c + NB * warp
                np.testing.assert_array_equal(chunk[warp], w[:, u] if u < U else np.zeros((ndot, K), np.float32))


def test_stcn_layout_keeps_a_prefix_of_whole_chunks_within_shared_memory():
    offsets = np.cumsum([0] + [1024, 4096, 2048, 2048] * 20).tolist()  # 184320 floats a CTA, 4096 the widest chunk
    for B in (1, 2, 8):
        resident, slot = generation.stcn_layout(offsets, B, head_floats=8640)
        assert resident in offsets and slot == 4096
        fixed = 16 + 2 * B * 512 + B * 256 + 2 * B * 96 + 8640
        assert 4 * (fixed + 3 * slot + resident) <= generation.SMEM_OPTIN
        nxt = offsets[offsets.index(resident) + 1]
        assert 4 * (fixed + 3 * slot + nxt) > generation.SMEM_OPTIN
    assert generation.stcn_layout([0, 64, 128], 2, 8640) == (128, 0)  # every chunk fits: no ring
    with pytest.raises(ValueError):
        generation.stcn_layout([0, 20000, 40000], 8, 8640)  # three slots of the widest chunk do not fit
