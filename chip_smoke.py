"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path, the WaveNet test pass (bits/frame), at the
flagship width of ``experiments/benchmarks.txt`` (5 x 10 residual blocks,
C = 96, DMoL with 10 mixtures over 2^16 bins, bf16 residual stack) with random
weights made by numpy from a seed, and checks the two hand-written kernels it
runs against their plain PyTorch twins:

  1. device: the card's name and power limit (nvidia-smi)
  2. numerics: TF32 and reduced-precision bf16 GEMM reductions off
  3. build: nvcc compiles blvm_tpu_torch/csrc/*.cu (sm_90a) into one library
  4. K1 residual_glu vs its twin at B=8, C=96, dilations 1/64/512, f32 and bf16,
     skip rows = all output rows and = the last 16000
  5. K2 dmol_log_prob vs its twin over 8 x 16000 frames, M=10, 2^16 bins, with
     the ladder's edge rows
  6. the slice: CLI flags -> model -> weights bridge -> rf-chunked test pass over
     three mu-law utterances of 40k-64k samples; launch counts per chunk forward
     (50 K1, 1 K2); the chunked bits/frame against one unchunked forward
  7. one forward at B=8, T=16000, kernels against plain twins (bf16 and f32)
  8. timing of that forward and of each kernel against its twin (CUDA events,
     median of a different input per iteration, run in turns)

Every phase prints one line; any failure raises and exits non-zero before the
last line. The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

import json
import math
import subprocess
import sys
import time
from unittest import mock

import torch

FLAGSHIP_FLAGS = (
    "--likelihood DMoL --input_coding mu_law --n_stacks 5 --n_layers 10 --res_channels 96 --num_bits 16 "
    "--num_mix 10 --random_segment_size 16000 --split_eval True --bf16 true --seed 0"
)
B, T = 8, 16000
SEED = 0


def phase(tag, /, **values):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in values.items()), flush=True)


def require(cond, message):
    if not cond:
        raise AssertionError(message)


def cuda_time_ms(fn, inputs, warmup=3):
    """Median device time of ``fn(inp)`` over ``inputs`` (a different input each
    iteration), CUDA events around each call, after ``warmup`` calls."""
    for inp in inputs[:warmup]:
        fn(inp)
    torch.cuda.synchronize()
    times = []
    for inp in inputs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(inp)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def alternate(plain_fn, kernel_fn, inputs):
    """Median times of the plain and the kernel version, run in turns
    plain, kernel, kernel, plain on the same card."""
    samples = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        samples[name] += cuda_time_ms(plain_fn if name == "plain" else kernel_fn, inputs)
    return {k: sorted(v)[len(v) // 2] for k, v in samples.items()}


def synthetic_speech(n, rng):
    """A TIMIT-like waveform in [-1, 1]: a few drifting harmonics under an
    amplitude envelope plus noise, at 16 kHz."""
    import numpy as np

    t = np.arange(n) / 16000.0
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase_ = 2 * np.pi * np.cumsum(f0) / 16000.0
    voiced = sum(np.sin(k * phase_) / k for k in range(1, 6))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6))) ** 2
    x = 0.08 * envelope * voiced + 0.01 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import wavenet_audio
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.ops import cuda, likelihoods

    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # 2. numerics of the plain twins: full f32 GEMMs and convs, f32 accumulation in bf16 GEMMs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase("numerics", tf32=False, bf16_reduced_precision_reduction=False)

    # 3. build
    t0 = time.time()
    lib_path = cuda.build()
    cuda.library()
    ptxas = [line.strip() for line in cuda.build_log.splitlines() if "Used" in line or "Compiling entry" in line]
    phase("build", seconds=f"{time.time() - t0:.1f}", library=lib_path.relative_to(cuda.BUILD_ROOT.parent.parent))
    for line in ptxas:
        print("  ptxas:", line, flush=True)

    record = {
        "residual_glu": dict(name="residual_glu", route="cuda", source="blvm_tpu_torch/csrc/residual_glu.cu",
                             replaces="blvm_tpu/models/wavenet/modules.py:110"),
        "dmol_log_prob": dict(name="dmol_log_prob", route="cuda", source="blvm_tpu_torch/csrc/dmol.cu",
                              replaces="blvm_tpu/ops/likelihoods.py:142"),
    }

    # 4. K1 against its twin at the flagship shapes
    args = wavenet_audio.build_args(FLAGSHIP_FLAGS.split())
    model = wavenet_audio.build_model(args, device=dev)
    rf = model.receptive_field
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    block_names = ("gate_kernel_t", "gate_kernel_s", "gate_bias_t", "gate_bias_s", "rs_kernel", "rs_bias")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # f32: FMA order against cuBLAS's (a few ulps of O(1) values). bf16: the kernel
    # rounds once at the store, the twin after every op as JAX does
    # (blvm_tpu/models/wavenet/modules.py:156-158): two bf16 ulps (2^-6 relative)
    # plus the one-ulp gate amplification the JAX suite allows (5e-2).
    k1_tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0**-6, 5e-2)}
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 64, 512):
            block = int(math.log2(d))  # dilations of a stack: 1, 2, 4, ..., 512 (block i has 2^i, i >= 1)
            w = [torch.from_numpy(params[f"res_stack/Conv1dResidualGLU_{block}/{n}"]).to(dev, dtype) for n in block_names]
            x = torch.randn(B, T + rf, 96, generator=gen, device=dev).to(dtype)
            for skip in (T + rf - d, T):
                o, s = modules.residual_glu(x, *w, dilation=d, skip_size=skip)
                torch.cuda.synchronize()
                o_ref, s_ref = modules.residual_glu_plain(x, *w, dilation=d, skip_size=skip)
                rtol, atol = k1_tol[dtype]
                for got, ref in ((o, o_ref), (s, s_ref)):
                    err = (got.float() - ref.float()).abs()
                    require(got.shape == ref.shape and torch.isfinite(got).all(), f"K1 {dtype} d={d}: shape/finite")
                    excess = (err - (atol + rtol * ref.float().abs())).max().item()
                    require(excess <= 0, f"K1 {dtype} d={d} skip={skip}: max err {err.max().item()} over tolerance")
                    k1_err = max(k1_err, err.max().item())
                phase("K1", dtype=str(dtype).split(".")[1], dilation=d, skip_rows=skip,
                      max_abs_err=f"{max((o.float() - o_ref.float()).abs().max().item(), (s.float() - s_ref.float()).abs().max().item()):.3g}")
    record["residual_glu"]["max_abs_err"] = k1_err

    # 5. K2 against its twin: head-shaped strided inputs with the ladder's edge rows
    M, num_bins = 10, 2**16
    head_out = torch.randn(B, T, 3 * M, generator=gen, device=dev) * 0.5
    logits = head_out[..., :M]
    locs = head_out[..., M : 2 * M].reshape(B, T, 1, M)
    log_scales = torch.clamp_min(head_out[..., 2 * M :].reshape(B, T, 1, M) * 4 - 3, -7.0)
    y = torch.rand(B, T, 1, generator=gen, device=dev) * 2 - 1
    y[0, :2000], y[0, 2000:4000] = -1.0, 1.0  # lowest and highest bins
    log_scales[1, :4000] = -7.0  # tiny scales: cdf_delta <= 1e-5 away from the target
    lp = likelihoods.dmol_log_prob(y, logits, locs, log_scales, num_bins=num_bins)
    torch.cuda.synchronize()
    lp_ref = likelihoods.discretized_logistic_mixture_ll(y, logits, locs, log_scales, num_bins=num_bins)
    # two f32 implementations of an ill-conditioned function: atol 1e-5 where the
    # mass is well conditioned, more where cdf_delta cancels (dmol_f32_error_bound)
    bound = likelihoods.dmol_f32_error_bound(y, logits, locs, log_scales, num_bins=num_bins)
    err = (lp - lp_ref).abs().double()
    require(lp.shape == (B, T) and torch.isfinite(lp).all(), "K2: shape/finite")
    require((err <= bound).all().item(), f"K2: max err {err.max().item()} over its bound")
    inv = torch.exp(-log_scales)
    delta = torch.sigmoid(inv * (y[..., None] - locs + 1 / (num_bins - 1))) - torch.sigmoid(
        inv * (y[..., None] - locs - 1 / (num_bins - 1)))
    record["dmol_log_prob"]["max_abs_err"] = err.max().item()
    phase("K2", frames=B * T, mixtures=M, bins=num_bins, max_abs_err=f"{err.max().item():.3g}",
          share_within_1e5_nats=f"{(err <= 1e-5).double().mean().item():.4f}",
          midpoint_components=int((delta <= 1e-5).sum().item()), edge_frames=int(((y == 1) | (y == -1)).sum().item()))

    # 6. the slice: the rf-chunked test pass over three utterances
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(40000, 64001, 3)
    x_np, x_sl_np = wavenet_audio.make_batch([synthetic_speech(int(n), rng) for n in lengths], args)
    n_chunks = len(model.split_sequence(x_np, x_sl_np, length=args.random_segment_size)[0])
    cuda.reset_launch_counts()
    tracker = Tracker()
    t0 = time.time()
    values = wavenet_audio.evaluate(model, args, [(x_np, x_sl_np)], tracker, source="test",
                                    generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = cuda.launch_counts()
    require(all(math.isfinite(values[k]) for k in ("loss", "ll", "bpd")), f"test pass not finite: {values}")
    require(counts["residual_glu"] == 50 * n_chunks, f"K1 launches {counts['residual_glu']} != 50 x {n_chunks} chunks")
    require(counts["dmol_log_prob"] == n_chunks, f"K2 launches {counts['dmol_log_prob']} != {n_chunks} chunks")
    for name in record:
        record[name]["launches"] = counts[name]
    phase("slice", utterances=list(map(int, lengths)), chunks=n_chunks, loss=f"{values['loss']:.6f}",
          ll=f"{values['ll']:.3f}", bpd=f"{values['bpd']:.6f}", launches=counts, seconds=f"{seconds:.2f}")
    # the same utterances in one rf-padded forward score the same frames: the chunked
    # pass must give the same bits/frame (per-frame math is the same; only the head's
    # f32 GEMM shapes differ, so rtol 1e-5)
    whole = wavenet_audio.evaluate(model, argparse_copy(args, split_eval=False), [(x_np, x_sl_np)], Tracker(),
                                   generator=torch.Generator(device=dev).manual_seed(SEED))
    require(abs(whole["bpd"] - values["bpd"]) <= 1e-5 * abs(values["bpd"]), f"chunked {values} vs whole {whole}")
    phase("slice-vs-unchunked", bpd_chunked=f"{values['bpd']:.6f}", bpd_whole=f"{whole['bpd']:.6f}")

    # 7. one forward at B=8, T=16000: kernels against the plain twins
    def batch(i):
        r = np.random.default_rng(1000 + i)
        return wavenet_audio.make_batch([synthetic_speech(T, r) for _ in range(B)], args)

    def forward(m, xb):
        with torch.inference_mode():
            return m(xb[0], xb[1], generator=torch.Generator(device=dev).manual_seed(SEED))

    plain = mock.patch.multiple  # swaps the wrappers for their twins inside a with-block
    twins = dict(residual_glu=modules.residual_glu_plain)
    x_np, x_sl_np = batch(0)
    xb = (torch.from_numpy(x_np).to(dev), torch.from_numpy(x_sl_np).to(dev))
    # bf16: one-ulp differences (2^-8) after every block move the head's parameters by
    # ~1e-3 relative after 50 blocks; per frame that is ~1e-2 nats, the row sums and
    # the loss average it out. f32: summation order only (~1e-5 relative on the head).
    fwd_tol = {True: dict(rel=1e-3, frame_mean=2e-2, frame_max=1.0), False: dict(rel=1e-5, frame_mean=1e-4, frame_max=2e-2)}
    models = {True: model}
    f32_args = argparse_copy(args, bf16=False)
    models[False] = wavenet_audio.build_model(f32_args, device=dev)
    weights.load_jax_params(models[False], params)
    for bf16, m in models.items():
        loss, mets, out = forward(m, xb)
        with plain(modules, **twins), plain(likelihoods, dmol_log_prob=plain_dmol(likelihoods)):
            loss_p, mets_p, out_p = forward(m, xb)
        tol = fwd_tol[bf16]
        frame_err = (out.log_prob_twise - out_p.log_prob_twise).abs()
        row_rel = ((mets["log_prob"] - mets_p["log_prob"]).abs() / mets_p["log_prob"].abs()).max().item()
        loss_rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
        require(torch.isfinite(out.log_prob_twise).all() and out.log_prob_twise.shape == (B, T), "forward shape")
        require(loss_rel <= tol["rel"] and row_rel <= tol["rel"], f"forward bf16={bf16}: loss {loss_rel}, rows {row_rel}")
        require(frame_err.mean().item() <= tol["frame_mean"] and frame_err.max().item() <= tol["frame_max"],
                f"forward bf16={bf16}: frame err mean {frame_err.mean().item()} max {frame_err.max().item()}")
        phase("forward-vs-twins", bf16=bf16, loss=f"{loss.item():.6f}", loss_plain=f"{loss_p.item():.6f}",
              loss_rel=f"{loss_rel:.3g}", row_rel=f"{row_rel:.3g}", frame_mean=f"{frame_err.mean().item():.3g}",
              frame_max=f"{frame_err.max().item():.3g}")

    # 8. timing: each a different batch per timed iteration
    batches = []
    for i in range(12):
        xn, sn = batch(i + 1)
        batches.append((torch.from_numpy(xn).to(dev), torch.from_numpy(sn).to(dev)))

    def run_plain(xb_):
        with plain(modules, **twins), plain(likelihoods, dmol_log_prob=plain_dmol(likelihoods)):
            forward(model, xb_)

    fwd = alternate(run_plain, lambda xb_: forward(model, xb_), batches)
    phase("time-forward", card=smi.replace(" ", "_"), B=B, T=T, bf16=True, kernel_ms=f"{fwd['kernel']:.3f}",
          plain_ms=f"{fwd['plain']:.3f}", iterations=len(batches) * 2)

    # K1 alone: one block at d=64, the flagship input length, bf16
    w = [torch.from_numpy(params[f"res_stack/Conv1dResidualGLU_6/{n}"]).to(dev, torch.bfloat16) for n in block_names]
    xs = [torch.randn(B, T + rf, 96, generator=gen, device=dev).to(torch.bfloat16) for _ in range(12)]
    k1 = alternate(lambda x_: modules.residual_glu_plain(x_, *w, dilation=64, skip_size=T),
                   lambda x_: modules.residual_glu(x_, *w, dilation=64, skip_size=T), xs)
    record["residual_glu"].update(ms=k1["kernel"], plain_ms=k1["plain"])
    phase("time-K1", card=smi.replace(" ", "_"), shape=f"({B},{T + rf},96)", dilation=64, dtype="bf16",
          kernel_ms=f"{k1['kernel']:.4f}", plain_ms=f"{k1['plain']:.4f}")

    heads = []
    for _ in range(12):
        h = torch.randn(B, T, 3 * M, generator=gen, device=dev) * 0.5
        heads.append((y, h[..., :M], h[..., M : 2 * M].reshape(B, T, 1, M),
                      torch.clamp_min(h[..., 2 * M :].reshape(B, T, 1, M) * 4 - 3, -7.0)))
    k2 = alternate(lambda a: likelihoods.discretized_logistic_mixture_ll(*a, num_bins=num_bins),
                   lambda a: likelihoods.dmol_log_prob(*a, num_bins=num_bins), heads)
    record["dmol_log_prob"].update(ms=k2["kernel"], plain_ms=k2["plain"])
    phase("time-K2", card=smi.replace(" ", "_"), frames=B * T, mixtures=M, kernel_ms=f"{k2['kernel']:.4f}",
          plain_ms=f"{k2['plain']:.4f}")

    print(json.dumps({"kernels": list(record.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}), flush=True)
    return 0


def argparse_copy(args, **changes):
    import argparse

    return argparse.Namespace(**{**vars(args), **changes})


def plain_dmol(likelihoods):
    return lambda y, logit_probs, locs, log_scales, num_bins: likelihoods.discretized_logistic_mixture_ll(
        y, logit_probs, locs, log_scales, num_bins=num_bins)


if __name__ == "__main__":
    sys.exit(main())
