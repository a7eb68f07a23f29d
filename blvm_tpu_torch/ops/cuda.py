"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source ``blvm_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc``
process, all started together, and the objects link into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds instead of minutes). The build runs at first use into
``blvm_tpu_torch/_build/<hash of the sources and flags>/``, a directory the
repository's ``.gitignore`` lists; a changed source gets a new directory.

Every wrapper calls :func:`count_launch` right where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernels:
``reset_launch_counts()`` before the run, ``launch_counts()`` after it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libblvm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_launches: Dict[str, int] = {
    "residual_glu": 0, "residual_glu_bwd": 0, "dmol_log_prob": 0, "dmol_log_prob_bwd": 0, "dmol_sample": 0,
    "wavenet_decode": 0, "wavenet_decode_resident": 0, "lstm_recurrence": 0, "lstm_recurrence_bwd": 0, "vrnn_cell": 0,
    "vrnn_cell_bwd": 0, "gru_recurrence": 0, "gru_recurrence_bwd": 0, "srnn_chain": 0, "srnn_chain_bwd": 0,
    "stcn_decode": 0, "depthwise_norm": 0, "depthwise_norm_bwd": 0, "rssm_chain": 0, "rssm_chain_bwd": 0,
    "bilstm_recurrence": 0, "bilstm_recurrence_bwd": 0, "ctc_loss": 0, "ctc_loss_bwd": 0, "wavenet_stack": 0,
    "wgmma_tile": 0, "glu_bwd_pass_a": 0, "glu_bwd_wgrad": 0, "glu_bwd_reduce": 0, "glu_bwd_pass_b": 0,
}
build_log = ""  # nvcc's output of the build this process ran (register / shared-memory report)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, C, half, R, S, rs_ld, dilation, skip_size, dtype, stream
    "blvm_residual_glu": [_P] * 9 + [_I] * 10 + [_P],
    # x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act, dx, B, T_in, C, half, R, S, rs_ld, dilation, skip_size, dtype,
    # stream
    "blvm_residual_glu_bwd": [_P] * 11 + [_I] * 10 + [_P],
    # the warpgroup route of K1-bwd (bf16, C = 96), one entry a kernel:
    # x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act; B, T_in, dilation, skip_size; stream
    "blvm_glu_bwd_pass_a": [_P] * 10 + [_I] * 4 + [_P],
    # x, d_o, d_s, d_pre, act, part; B, T_in, dilation, skip_size, n_split; stream
    "blvm_glu_bwd_wgrad": [_P] * 6 + [_I] * 5 + [_P],
    # part, d_w_t, d_w_s, d_b_t, d_b_s, d_w_rs, d_b_rs; n_split; stream
    "blvm_glu_bwd_reduce": [_P] * 7 + [_I] + [_P],
    # w_t, w_s, d_pre, d_o, dx; B, T_in, dilation; stream
    "blvm_glu_bwd_pass_b": [_P] * 5 + [_I] * 3 + [_P],
    # io (host array of L + 1), taps (host array of L), w_t, w_s, b_t, b_s, w_rs, b_rs, skip_sum, barrier, dilations
    # (host array of L); B, T_in, C, half, S, L, skip_size, accumulate, dtype; stream
    "blvm_wavenet_stack": [_P] * 11 + [_I] * 9 + [_P],
    # a, b, d; n, k, trans_a, a_regs; stream
    "blvm_wgmma_tile": [_P] * 3 + [_I] * 4 + [_P],
    # y, logits, locs, log_scales, out, N, M, y/logit/loc/scale row strides, num_bins, stream
    "blvm_dmol_log_prob": [_P] * 5 + [_L, _I, _L, _L, _L, _L, _I, _P],
    # y, logits, locs, log_scales, g, d_logits, d_locs, d_log_scales, N, M, 4 row strides, num_bins, stream
    "blvm_dmol_log_prob_bwd": [_P] * 8 + [_L, _I, _L, _L, _L, _L, _I, _P],
    # logits, locs, log_scales, u_cat, u_log, seed, step, sample, mode, N, M, 3 row strides, 4 uniform maps, stream
    "blvm_dmol_sample": [_P] * 6 + [_L] + [_P] * 2 + [_L, _I, _L, _L, _L] + [_F] * 4 + [_P],
    # 12 weights, dilations, offsets, buffers, x, seed, u_cat, u_log; B, L, C, half, S, M, D, x_cols, frame;
    # variance_scale, log_eps, 4 uniform maps; dtype, stream
    "blvm_wavenet_decode": [_P] * 19 + [_I] * 9 + [_F] * 6 + [_I, _P],
    # w_blocks, b_blocks, w_in, b_in, w_causal, b_causal, w_out, b_out, w_head, b_head, dilations, offsets, buffers,
    # boxes, x, seed, u_cat, u_log, status, trace; B, L, M, D, n_frames; variance_scale, log_eps, 4 uniform maps;
    # wait limit (ns); stream
    "blvm_wavenet_decode_resident": [_P] * 20 + [_I] * 5 + [_F] * 6 + [_L, _P],
    # xw, w_hh, b_hh, mask, h0, c0, out, h_n, c_n, gates, h_prev, c_prev; B, T, H, dtype, stream
    "blvm_lstm_recurrence": [_P] * 12 + [_I] * 4 + [_P],
    # w_hh, mask, gates, c_prev, d_out, d_h_n, d_c_n, d_gates, d_h0, d_c0; B, T, H, dtype, stream
    "blvm_lstm_recurrence_bwd": [_P] * 10 + [_I] * 4 + [_P],
    # xw, w_hh, b_hh, mask, out, gates, h_prev, c_prev; B, T, H; stream
    "blvm_bilstm_recurrence": [_P] * 8 + [_I] * 3 + [_P],
    # w_hh, mask, gates, c_prev, d_out, d_gates; B, T, H; stream
    "blvm_bilstm_recurrence_bwd": [_P] * 6 + [_I] * 3 + [_P],
    # lp, y, z_sl, y_sl, nll, alpha, beta, trace; B, T, N, K, blank; log_eps; stream
    "blvm_ctc_loss": [_P] * 8 + [_I] * 5 + [_F, _P],
    # y, z_sl, y_sl, alpha, beta, g, d_lp; B, T, N, K, blank; stream
    "blvm_ctc_loss_bwd": [_P] * 7 + [_I] * 5 + [_P],
    # weights[28], h0, xpost, xg, eps, outputs[7], act, barrier, trace; B, T, R, H, Z, inference, residual,
    # use_mode, save; sd_beta, sd_eps; stream
    "blvm_vrnn_cell": [_P] * 9 + [_I] * 9 + [_F] * 2 + [_P],
    # weights[28], h0, eps, h, phi, save, grads[7], dpre, dh0, barrier, trace; B, T, R, H, Z, residual; sd_beta;
    # stream
    "blvm_vrnn_cell_bwd": [_P] * 11 + [_I] * 6 + [_F] + [_P],
    # xw, w_hh, b_hh, mask, h0, out, h_n, save, state, barrier; B, T, H; stream
    "blvm_gru_recurrence": [_P] * 10 + [_I] * 3 + [_P],
    # w_hh, mask, save, d_out, d_hn, d_gi, d_gh, d_h0, barrier, trace; B, T, H; stream
    "blvm_gru_recurrence_bwd": [_P] * 10 + [_I] * 3 + [_P],
    # weights[14], xp, xq, z0, eps, outputs[5], act, save, barrier, trace; B, T, H, Z, inference, residual,
    # use_mode; sd_beta, sd_eps; stream
    "blvm_srnn_chain": [_P] * 10 + [_I] * 7 + [_F] * 2 + [_P],
    # weights[14], eps, save, grads[5], dpre, dz0, barrier, trace; B, T, H, Z, residual; sd_beta; stream
    "blvm_srnn_chain_bwd": [_P] * 8 + [_I] * 5 + [_F] + [_P],
    # biases[8 + 3 L] (host array), geometry (host ints), layout (host ints), state[13] (host array), stream, head,
    # eps, seed, u_cat, u_log, z_out, params_out, trace, status; B, C, half, S, Le, Ld, L, M, NB, n_frames, use_mode;
    # inv_std_n, sd_beta, sd_eps, log_eps, 4 uniform maps; wait limit (ns); stream
    "blvm_stcn_decode": [_P] * 14 + [_I] * 11 + [_F] * 8 + [_L, _P],
    # u, scale1, bias1, w, db, scale2, bias2, out, part, stats; part doubles; B, N_in, N_out, C, k, stride, dilation,
    # transposed, stats_rows, conv_rows, save; stream
    "blvm_depthwise_norm": [_P] * 10 + [_L] + [_I] * 11 + [_P],
    # dz, u, scale1, bias1, w, db, scale2, stats, du, dv, dparams, coef, part, part_w; part and part_w doubles; B,
    # N_in, N_out, C, k, stride, dilation, transposed, in_rows, out_rows; stream
    "blvm_depthwise_norm_bwd": [_P] * 14 + [_L] * 2 + [_I] * 10 + [_P],
    # weights[20], xg, xq, z0, h0, eps, resets, outputs[6], act, save, barrier; B, T, H, Z, inference, residual,
    # precision, use_mode; sd_beta, sd_eps; stream
    "blvm_rssm_chain": [_P] * 11 + [_I] * 8 + [_F] * 2 + [_P],
    # weights[20], eps, save, h, h0, resets, grads[6], dpre, dz0, dh0, barrier; B, T, H, Z, residual, precision;
    # sd_beta, sd_eps; stream
    "blvm_rssm_chain_bwd": [_P] * 11 + [_I] * 6 + [_F] * 2 + [_P],
}


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def count_launch(name: str) -> None:
    _launches[name] += 1


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _build_dir() -> Path:
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is already built:
    one ``nvcc -c`` per source, run in parallel, then one link."""
    global build_log
    out_dir = _build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in cu]
        compiles = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(cu, objects))
        ]
        logs, failed = [], []
        for cmd, proc in compiles:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        build_log = "".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / LIB_NAME
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(lib_tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib_tmp, lib_path)  # atomic: a concurrent builder never loads a half-written file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
