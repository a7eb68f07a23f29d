"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip without a CUDA device (here, on CPU-only machines).
On the card, where JAX is not installed, leave out the root conftest (it imports
JAX): ``python -m pytest --confcutdir=tests/_torch tests/_torch/test_torch_kernels_cuda.py``.
``chip_smoke.py``
holds the kernels to their twins at the flagship shapes; these tests cover the
other widths, ragged tiles, strided inputs and the refusals.
"""

import pytest
import torch

from blvm_tpu_torch.models.wavenet.modules import residual_glu, residual_glu_plain
from blvm_tpu_torch.ops import cuda, likelihoods

# f32: the kernel's FMA order against cuBLAS's (a few ulps of O(1) values).
# bf16: the kernel rounds once at the store, the twin after every op as JAX does:
# up to two bf16 ulps (2^-6 relative) plus the one-ulp gate amplification the
# JAX suite allows (5e-2 absolute).
K1_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2.0**-6, atol=5e-2)}


def glu_inputs(B, T_in, C, half, S, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(*shape, generator=g) * 2 - 1) / fan_in**0.5).to(device, dtype)

    x = torch.randn(B, T_in, C, generator=g).to(device, dtype)
    return (x, u(2, C, half, fan_in=2 * C), u(2, C, half, fan_in=2 * C), u(half, fan_in=2 * C), u(half, fan_in=2 * C),
            u(1, half, C + S, fan_in=half), u(C + S, fan_in=half))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,T_in,C,half,S,dilation,skip",
    [
        (2, 100, 96, 96, 96, 1, 99),  # flagship widths, skip == T_out
        (3, 700, 96, 96, 96, 512, 150),  # the largest dilation, a short tail of skip rows
        (1, 77, 40, 24, 16, 3, 10),  # generic widths, a ragged last time tile
        (2, 40, 8, 128, 248, 5, 35),  # the limits: half = 128, R + S = 256
        (3, 301, 32, 32, 32, 7, 100),  # the second tensor-core width (bf16), a ragged tile
        (1, 130, 96, 96, 96, 2, 128),  # exactly one 128-row tile
    ],
)
def test_residual_glu_kernel_matches_twin(cuda_device, dtype, B, T_in, C, half, S, dilation, skip):
    args = glu_inputs(B, T_in, C, half, S, dtype, cuda_device)
    o, s = residual_glu(*args, dilation=dilation, skip_size=skip)
    torch.cuda.synchronize()
    o_ref, s_ref = residual_glu_plain(*args, dilation=dilation, skip_size=skip)
    assert o.shape == o_ref.shape and s.shape == s_ref.shape and o.dtype == dtype
    torch.testing.assert_close(o.float(), o_ref.float(), **K1_TOL[dtype])
    torch.testing.assert_close(s.float(), s_ref.float(), **K1_TOL[dtype])


@pytest.mark.cuda
def test_residual_glu_tensor_core_and_fma_paths_agree(cuda_device):
    """bf16 at C = 96 takes the tensor-core path when x's rows are 16-byte aligned and
    the FMA path when they are not (a view offset by one element); both hold to the twin."""
    args = glu_inputs(2, 400, 96, 96, 96, torch.bfloat16, cuda_device)
    shifted = torch.empty(2 * 400 * 96 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(2, 400, 96)
    shifted.copy_(args[0])
    outs = [residual_glu(x, *args[1:], dilation=16, skip_size=300) for x in (args[0], shifted)]
    ref = residual_glu_plain(*args, dilation=16, skip_size=300)
    for o, s in outs:
        torch.testing.assert_close(o.float(), ref[0].float(), **K1_TOL[torch.bfloat16])
        torch.testing.assert_close(s.float(), ref[1].float(), **K1_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_residual_glu_kernel_refuses_what_it_does_not_take(cuda_device):
    args = glu_inputs(1, 50, 8, 8, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        residual_glu(*args, dilation=2, skip_size=49)  # more skip rows than output rows
    big = glu_inputs(1, 50, 8, 136, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        residual_glu(*big, dilation=2, skip_size=10)  # half above the kernel's limit
    with pytest.raises(TypeError):
        residual_glu(args[0].half(), *args[1:], dilation=2, skip_size=10)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bins", [256, 65536])
def test_dmol_kernel_matches_twin_on_strided_head_output(cuda_device, num_bins):
    """The kernel reads the head's strided slices; the edges of the ladder are in
    the inputs (y = +-1, log_scale = -7 far from the target)."""
    g = torch.Generator().manual_seed(1)
    B, T, M = 3, 1000, 10
    params = torch.randn(B, T, 3 * M, generator=g).to(cuda_device)
    logits = params[..., :M]
    locs = params[..., M : 2 * M].reshape(B, T, 1, M)
    log_scales = torch.clamp_min(params[..., 2 * M :].reshape(B, T, 1, M) - 3, -7.0)
    y = (torch.rand(B, T, 1, generator=g) * 2 - 1).to(cuda_device)
    y[0, :100] = -1.0
    y[0, 100:200] = 1.0
    log_scales[1, :200] = -7.0
    cuda.reset_launch_counts()
    got = likelihoods.dmol_log_prob(y, logits, locs, log_scales, num_bins=num_bins)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["dmol_log_prob"] == 1
    ref = likelihoods.discretized_logistic_mixture_ll(y, logits, locs, log_scales, num_bins=num_bins)
    bound = likelihoods.dmol_f32_error_bound(y, logits, locs, log_scales, num_bins=num_bins)
    assert got.shape == (B, T) and torch.isfinite(got).all()
    err = (got - ref).abs().double()
    assert (err <= bound).all(), f"max err {err.max().item()}"
