"""Bounds on paper of P2 and P3 (the fused WaveNet stack) at the shapes chip_smoke.py's phases 71-74 run, of
K1-bwd with its weight gradients (the warpgroup route's four kernels) over the WaveNet train step's 50 blocks,
of K6 and K6-bwd (the CTC probe's bi-LSTM layer) and K13 and K13-bwd (its CTC loss) at the probe's
train batch, of K7, K9, K7-bwd and K9-bwd (each kernel apart from the cuBLAS weight-gradient GEMMs around it)
at the SRNN's test pass and train step shapes, of a K4 frame at the flagship width (bf16 and f32), of K12, K1 and
K1-bwd at STCN's width, of K10
and K11 (apart from their GEMMs) at the CW-VAE's test pass, and of K10 in save mode, K10-bwd and
K11-bwd at the CW-VAE's train step, which ``chip_smoke.py`` also computes from its run.

    python scripts/torch_kernel_bounds.py

For each kernel, the least time one H100 could take for one launch at the shape its run spec
gives it, by ``chip_smoke.roofline``'s arithmetic: the larger of the compulsory bytes (inputs
read once, outputs written once) over the HBM rate and the operations over the peak rate of
their type. The operations are the products' multiply-adds (x 2); elementwise work is left
out. Batch shapes follow each driver's batch budget; each assumption is stated beside its
kernel. Runs on the CPU: nothing is measured.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (  # noqa: E402
    BF16_PEAK,
    F32_PEAK,
    F64_PEAK,
    HBM_BYTES_PER_S,
    bilstm_work,
    ctc_work,
    depthwise_bwd_work,
    depthwise_work,
    residual_glu_bwd_work,
    residual_glu_work,
    roofline,
    wavenet_step_bwd_work,
    wg_bwd_kernel_work,
    rssm_bwd_work,
    rssm_work,
    stcn_frame_work,
    wavenet_frame_work,
    wavenet_stack_work,
)

F32 = 4


def lstm_or_gru(rows, H, gates, directions=1):
    """A masked recurrence over precomputed x W_ih (K5's shape): h W_hh a row-step."""
    return dict(bytes_=F32 * (directions * (rows * (gates * H + H) + H * gates * H)),
                flops=2 * directions * rows * H * gates * H, peak=F32_PEAK)


def main():
    bounds = {}
    # P2: the fused 10-block stack (dilations 1 ... 512) at the flagship shape of chip_smoke.py phase 74 (B = 8,
    # T = 16000 plus the receptive field, C = 96, benchmarks.txt:6, bf16), the last 16000 rows' skips summed and
    # blocks 0 and 5's kept as z; one launch a stack, five a forward. P3: the windowed generation's first stack,
    # one window of the receptive field (5116 frames) for each of 2 sequences, one skip row.
    # chip_smoke.wavenet_stack_work counts each block's output rows and the f32 skip sum's traffic
    dilations = [1] + [2**i for i in range(1, 10)]
    bounds["P2"] = dict(**wavenet_stack_work(8, 21117, 96, dilations, 16000, taps=2), peak=BF16_PEAK)
    bounds["P2 f32"] = dict(**wavenet_stack_work(8, 21117, 96, dilations, 16000, taps=2, elem=F32), peak=F32_PEAK)
    bounds["P3"] = dict(**wavenet_stack_work(2, 5116, 96, dilations, 1, taps=2), peak=BF16_PEAK)
    # P2 in save mode, as the train step's forward runs it: every later block's input written too
    bounds["P2 save mode"] = dict(**wavenet_stack_work(8, 21117, 96, dilations, 16000, taps=2, save=True),
                                  peak=BF16_PEAK)
    # K1-bwd with its weight gradients over the WaveNet train step's 50 blocks (5 stacks of dilations 1 ... 512, the
    # first block's input 21117 rows, each later one d fewer; the last 16000 rows' skips), bf16:
    # chip_smoke.wavenet_step_bwd_work sums residual_glu_bwd_work over the blocks. And the warpgroup route's four
    # kernels apart at one block of phase 13's shape (d = 64; 132 SMs: 88 weight-kernel splits)
    bounds["K1-bwd with its weight gradients, a step's 50 blocks"] = dict(
        **wavenet_step_bwd_work(8, 21117, 96, dilations * 5, 16000), peak=BF16_PEAK)
    for kernel in ("pass_a", "wgrad", "reduce", "pass_b"):
        bounds[f"K1-bwd {kernel}, a block"] = dict(**wg_bwd_kernel_work(kernel, 8, 21117, 64, 16000, n_split=88),
                                                   peak=BF16_PEAK)
    # K6: one layer of the ASR probe's bi-LSTM at its run spec (experiments/phoneme.txt:8: --hidden_size 256,
    # 3 bidirectional layers, --batch_len 120 s at hop 64: 30000 frames a batch), both directions in one launch;
    # bilstm_work counts each direction's h W_hh product over the 30000 row-steps (31.46 GFLOP) and xw, the mask
    # and out moved once. K6-bwd with its dW_hh and db_hh products: twice the operations, the saved gates and
    # state read and d gates written
    frames = 120 * 16000 // 64
    bounds["K6 a layer"] = dict(**bilstm_work(1, frames, 256, frames), peak=F32_PEAK)
    bounds["K6-bwd a layer"] = dict(**bilstm_work(1, frames, 256, frames, backward=True), peak=F32_PEAK)
    # K13 and K13-bwd: the probe's CTC loss over the same batch as chip_smoke.py fills it (38 utterances of ~3.15 s
    # sharing the 30000 frames, 832 padded frames, 65 classes, 48 padded label columns; ~12 phones a second, 38 a
    # row); K13 as the test pass runs it (no saved states) and in save mode, as the train step runs it (alpha and
    # beta written); K13-bwd reads them and redoes no recursion. chip_smoke.ctc_work counts each row's live states,
    # 2 x 38 + 1 of the 97 columns
    ctc_rows = dict(frames=[frames // 38 + (i < frames % 38) for i in range(38)], labels=[round(12 * 3.15)] * 38)
    bounds["K13"] = dict(**ctc_work(832, 65, 48, **ctc_rows), peak=F64_PEAK)
    bounds["K13 in save mode"] = dict(**ctc_work(832, 65, 48, **ctc_rows, save=True), peak=F64_PEAK)
    bounds["K13-bwd"] = dict(**ctc_work(832, 65, 48, **ctc_rows, backward=True), peak=F64_PEAK)
    # The SRNN train step (benchmarks.txt:22, s=64, hidden 256 -> r_dim 512, H = Z = 256): the --batch_len
    # 64 budget as chip_smoke.py packs it, 19 utterances of up to 1000 stacks, 19000 row-steps.
    rows, R, H, Z = 19 * 1000, 512, 256, 256
    G = 3 * R
    # K7 a GRU (one direction a launch; the input projection is one GEMM outside)
    bounds["K7 train step"] = lstm_or_gru(rows=rows, H=R, gates=3)
    # K7-bwd: d gh W_hh^T a row-step, the only product inside the kernel; W_hh read, the saved forward (5R:
    # h_{t-1}, r, z, n, hn), the mask and d out read, d gi and d gh written
    bounds["K7-bwd train step"] = dict(bytes_=F32 * (R * G + rows * (5 * R + 1 + R + 2 * G) + 19 * 2 * R),
                                       flops=2 * rows * G * R, peak=F32_PEAK)
    # its weight gradients, outside the kernel (cuBLAS): dW_hh = h_{t-1}^T d gh and db_hh, a product with a
    # row of ones
    bounds["K7-bwd GEMMs train step"] = dict(bytes_=F32 * (rows * (R + G) + R * G + G),
                                             flops=2 * rows * (R + 1) * G, peak=F32_PEAK)
    # K9 and K9-bwd on the hoisted d and a products: the chain's products only, the z rows of both first
    # layers (Z x H), two H x H layers and the heads (H x 2Z) of both nets; the d and a rows (R x H) are
    # GEMMs before the chain (ops/srnn.py:hoist) and their gradients autograd's, outside K9-bwd
    chain_macs = 2 * (Z * H + 2 * H * H + H * 2 * Z)
    chain_kernels = 2 * (Z * H + 2 * H * H + H * 2 * Z)
    bounds["K9 train step"] = dict(bytes_=F32 * (rows * (2 * H + Z + 5 * Z + 6 * H + 2 * Z) + chain_kernels),
                                   flops=2 * rows * chain_macs, peak=F32_PEAK)
    # K9-bwd: the noise, the saved forward (6H + 2Z) and five output gradients read, the pre-activation
    # gradients (4Z + 6H) written; the same products as the forward, transposed
    bounds["K9-bwd train step"] = dict(bytes_=F32 * (chain_kernels + rows * (Z + 6 * H + 2 * Z + 5 * Z + 4 * Z + 6 * H)),
                                       flops=2 * rows * chain_macs, peak=F32_PEAK)
    # its 14 weight gradients, outside the kernel (cuBLAS): the 8 kernels (each its layer's input^T times its
    # pre-activation gradient) and 6 biases in one product with a row of ones
    bounds["K9-bwd GEMMs train step"] = dict(bytes_=F32 * (rows * (Z + 6 * H + 4 * Z + 6 * H) + chain_kernels),
                                             flops=2 * rows * (chain_macs + 4 * Z + 6 * H), peak=F32_PEAK)
    # K7 and K9 as the SRNN test pass runs them (chip_smoke.py phases 33-35: 6 utterances of up to 1125
    # stacks): K7 for the d GRU (input 256) and the a GRU (input 768), each input projection one GEMM
    # outside the kernel, so both launches bound alike; K9 on the hoisted d and a products, so only the
    # chain's z-row products count: the first layers' z rows (Z x H), two H x H layers, the heads (H x 2Z)
    rows = 6 * 1125
    bounds["K7 test pass"] = lstm_or_gru(rows=rows, H=R, gates=3)
    chain_weights = 2 * (Z * H + 2 * (H * H + H) + H * 2 * Z + 2 * Z)
    bounds["K9 test pass"] = dict(bytes_=F32 * (rows * (2 * H + Z) + 6 * Z + chain_weights + rows * 5 * Z),
                                  flops=2 * rows * chain_macs, peak=F32_PEAK)
    # K10: the CW-VAE's RSSM cell chain (benchmarks.txt:33, d=192 z=128 s=64, one level: no context) on the
    # hoisted products (ops/rssm.py:hoist): the chain's 12 H^2 + 5 H Z multiply-adds a row-step (gru_in's z rows,
    # the GRU's two products, both MLPs and heads; chip_smoke.rssm_work). At the test pass chip_smoke.py runs (5
    # utterances, the longest 72000 samples: 5 x 1125 row-steps) and at the driver's --batch_len 16 s as one
    # sequence of 4000 row-steps; the hoisted GEMM of the posterior's enc columns (H x E a row-step) apart
    Hd, Zd = 192, 128
    bounds["K10 test pass"] = dict(**rssm_work(5, 1125, Hd, Zd), peak=F32_PEAK)
    bounds["K10 4000 row-steps"] = dict(**rssm_work(1, 4000, Hd, Zd), peak=F32_PEAK)
    bounds["K10 hoisted enc GEMM test pass"] = dict(bytes_=F32 * (2 * 5 * 1125 * Hd + Hd * Hd + Hd),
                                                    flops=2 * 5 * 1125 * Hd * Hd, peak=F32_PEAK)
    # K11: the depthwise chain inside each coder block (ops/depthwise.py) at the same test pass: the encoder's
    # blocks from the same-padded 72021 samples (stride 4: 18005, 4501, 1125 rows) and the decoder's back (4501,
    # 18005, 72021), 4 x 192 = 768 channels, k = 5 (chip_smoke.depthwise_work: u read once, z written once); the
    # blocks' 1x1 GEMMs (192 -> 768 with bias over the input rows, 768 -> 192 over the output rows) apart
    enc = [(72021, 18005), (18005, 4501), (4501, 1125)]
    blocks = enc + [(n_out, n_in) for n_in, n_out in reversed(enc)]
    k11 = [depthwise_work(5, n_in, n_out, 768, 5) for n_in, n_out in blocks]
    bounds["K11 test pass (6 blocks)"] = dict(bytes_=sum(w["bytes_"] for w in k11), flops=sum(w["flops"] for w in k11),
                                              peak=F32_PEAK)
    gemm_rows = sum(n_in + n_out for n_in, n_out in blocks)
    bounds["K11 1x1 GEMMs test pass"] = dict(bytes_=F32 * 5 * gemm_rows * (Hd + 768), flops=2 * 5 * gemm_rows * Hd * 768,
                                             peak=F32_PEAK)
    # The CW-VAE train step (the same spec; chip_smoke.py's 5 utterances of 46k-51k samples a step within the 256000
    # samples of --batch_len, taken here at 50800 samples each: 794 top-level steps, the encoder's same padding to
    # 50837 samples): K10 in save mode (11 H + 4 Z floats a row-step written besides), K10-bwd over all 3970
    # row-steps (chip_smoke.py counts the steps the lengths cover), and K11-bwd over the step's six blocks (u and dz
    # read once, du written once)
    bounds["K10 save mode train step"] = dict(**rssm_work(5, 794, Hd, Zd, save=True), peak=F32_PEAK)
    bounds["K10-bwd train step"] = dict(**rssm_bwd_work(5, 794, Hd, Zd, 5 * 794), peak=F32_PEAK)
    enc_t = [(50837, 12709), (12709, 3177), (3177, 794)]
    k11b = [depthwise_bwd_work(5, n_in, n_out, 768, 5) for n_in, n_out in enc_t + [(o, i) for i, o in reversed(enc_t)]]
    bounds["K11-bwd train step (6 blocks)"] = dict(bytes_=sum(w["bytes_"] for w in k11b),
                                                   flops=sum(w["flops"] for w in k11b), peak=F32_PEAK)
    # K4: one generated frame of the flagship (benchmarks.txt:6, 5 x 10 blocks at C = 96, dilations 1 .. 512, 10
    # mixtures), 2 sequences (the generation hook's): bf16 on the resident route (one launch of 15999 frames), f32
    # on the per-frame route; "legacy": the per-frame yardstick (every weight every frame) for either route
    k4_dilations = [2**i for i in range(10)] * 5
    bounds["K4 frame bf16"] = dict(**wavenet_frame_work(2, 96, k4_dilations, 10, 2, 15999), peak=BF16_PEAK)
    bounds["K4 frame bf16 legacy"] = dict(**wavenet_frame_work(2, 96, k4_dilations, 10, 2), peak=BF16_PEAK)
    bounds["K4 frame f32"] = dict(**wavenet_frame_work(2, 96, k4_dilations, 10, 4), peak=F32_PEAK)
    # K12: one STCN decode frame at the only spec that takes the fast path (benchmarks.txt:26, s=1,
    # z=[256,128,64,32,16], hidden 256, 5 stacks of 5 blocks at dilations 1 .. 16 of which 5 feed a level, a
    # 5-block decode stack, the 30-wide DMoL head), 2 sequences (the generation hook's), f32, in one launch of
    # 16000 frames; "legacy": the per-frame yardstick
    for name, frames in (("K12", 16000), ("K12 legacy", 1)):
        bounds[name] = dict(**stcn_frame_work(B=2, C=256, half=256, S=256, enc_dilations=[1, 2, 4, 8, 16] * 5,
                                              n_used=5, n_dec=5, latent_size=(256, 128, 64, 32, 16), D=30,
                                              frames=frames), peak=F32_PEAK)
    # K1 at STCN's width (the same spec): the test pass's first block (dilation 1) over 6 utterances of up
    # to 72000 samples plus the receptive field less one (157 - 1), f32, with its skip (the used blocks',
    # skip_size T + 1) and skip-free (the other 20 blocks'; here at dilation 16)
    T = 72000
    bounds["K1 STCN skip"] = dict(**residual_glu_work(6, T + 156, 256, 256, 256, 1, T + 1), peak=F32_PEAK)
    bounds["K1 STCN skip-free"] = dict(**residual_glu_work(6, T + 156, 256, 256, 0, 16, 0), peak=F32_PEAK)
    # K1-bwd at STCN's width, the same spec's train step: a microbatch of 5 random segments of 1000 samples
    # (--batch_size 20, --accum_steps 4), rf-padded: the first block (skip-free, d = 1) takes 1000 + 157 - 1 rows,
    # the first used block (the skip at d = 16, its last 1001 rows) 15 fewer. The kernel alone (both passes:
    # 1.31 MFLOP a row with the skip, 1.18 M skip-free) and the whole backward with the weight-gradient GEMMs
    seg = 1000 + 157 - 1
    bounds["K1-bwd STCN skip"] = dict(**residual_glu_bwd_work(5, seg - 15, 256, 256, 256, 16, 1001, weight_grads=False),
                                      peak=F32_PEAK)
    bounds["K1-bwd STCN skip-free"] = dict(**residual_glu_bwd_work(5, seg, 256, 256, 0, 1, 0, weight_grads=False),
                                           peak=F32_PEAK)
    bounds["K1-bwd STCN skip with GEMMs"] = dict(**residual_glu_bwd_work(5, seg - 15, 256, 256, 256, 16, 1001),
                                                 peak=F32_PEAK)
    bounds["K1-bwd STCN skip-free with GEMMs"] = dict(**residual_glu_bwd_work(5, seg, 256, 256, 0, 1, 0), peak=F32_PEAK)
    # each bound beside its two terms: the bytes over the HBM rate and the operations over the peak of their type
    print(json.dumps({name: {**roofline(**b), "bytes_ms": b["bytes_"] / HBM_BYTES_PER_S * 1e3,
                             "operations_ms": b["flops"] / b["peak"] * 1e3} for name, b in bounds.items()}, indent=1))


if __name__ == "__main__":
    main()
