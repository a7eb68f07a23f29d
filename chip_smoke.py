"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths with random weights made by numpy from a seed: the
WaveNet test pass (bits/frame), the WaveNet train step and WaveNet generation
(2 x 16000 frames, Fast-WaveNet) at the flagship width of
``experiments/benchmarks.txt`` (5 x 10 residual blocks, C = 96, DMoL with 10
mixtures over 2^16 bins, bf16 residual stack), and LSTMAudio's test pass, train
step and generation at the width of its s=64 run spec (H = 256, one layer, 64
frames a stack, the same DMoL head, f32), and the VRNN's test pass, generation and
train step at the width of its s=64 z=256 run spec (H = Z = 256, r_dim 512, 64 frames a
stack, the same DMoL head, f32), and the SRNN's test pass, generation and train step at the
width of its s=64 z=256 run spec (the same widths, smoothing, f32), and STCN's test pass,
generation and train step at the width of its s=1 z=[256,128,64,32,16] run spec (256 channels,
5 x 5 encoder blocks, a 5-block decode stack, the same DMoL head, f32; the step in 4 microbatches
with the clips and annealers) and one train step at its s=64 z=[256] spec, and the CW-VAE's test pass,
generation and train step at the width of its d=192 z=[128] s=[64] run spec (3 blocks of stride 4 a coder
expanding 192 -> 768, the precision-weighted posterior, the same DMoL head, f32; the step with the beta and
free-nats annealers), and the drivers' loops with their metrics read late, and the CTC phoneme probe's train step
and test pass at the width of its phoneme.txt:8 run spec (3 bidirectional LSTM layers of H = 256 over 80 log-mel
bins, CTC over 65 classes, f32), and checks the twenty-nine hand-written kernels they run against their plain
PyTorch twins:

  1. device: the card's name and power limit (nvidia-smi)
  2. numerics: TF32 and reduced-precision bf16 GEMM reductions off
  3. build: nvcc compiles blvm_tpu_torch/csrc/*.cu (sm_90a) into one library
  4. K1 residual_glu vs its twin at B=8, C=96, dilations 1/64/512, f32 and bf16,
     skip rows = all output rows and = the last 16000
  5. K2 dmol_log_prob vs its twin over 8 x 16000 frames, M=10, 2^16 bins, with
     the ladder's edge rows
  6. the slice: CLI flags -> model -> weights bridge -> rf-chunked test pass over
     three mu-law utterances of 40k-64k samples; launch counts per chunk forward
     (5 P2, the fused stack, no K1; 1 K2); the chunked bits/frame against one unchunked forward
  7. one forward at B=8, T=16000, kernels against plain twins (bf16 and f32)
  8. timing of that forward and of each kernel against its twin (CUDA events,
     median of a different input per iteration, run in turns)
  9. K1-bwd residual_glu backward vs autograd of the twin, same cases as 4
 10. K2-bwd dmol_log_prob backward at the head shapes of 5: kernel and f32 twin
     both held to the float64 twin; frames near the ladder's threshold counted apart
 11. K3 dmol_sample: fed the twin's uniforms, equal to it; its own stream on 1M
     frames by distribution (chi-square, Kolmogorov-Smirnov)
 12. the train slice: flags -> driver ``train`` -> 3 steps at B=8, T=16000 on
     random crops, bf16, Adam; launch counts per step (5 P2, 50 K1-bwd, 1 K2,
     1 K2-bwd, 1 K3); per-step losses and step-0 gradients against the twins;
     one f32 step, kernels against twins
 13. timing of the train step and of K1-bwd, K2-bwd and K3 against their twins,
     and a torch.profiler breakdown of the train step
 14. K4 wavenet_decode vs the plain frame loop over 128 frames, f32 (the per-frame route, one
     launch a frame) and bf16 (the resident route, one launch a generation), from a zero
     history and a speech prefix, fed the same uniforms: the loop fed the kernel's frames
     (teacher forcing) and running free; two resident launches bitwise equal
 15. the fast path (K4) vs the windowed path (P3 x 5 + K3 a frame) over 16 frames
     from one generator state
 16. 2 x 16000 frames by K4 from supplied uniforms, held to the rf-padded forward of
     the generated waveform and K3 fed the same uniforms (every frame at once)
 17. timing of 2 x 2000 and 2 x 16000 frames by CUDA events, bf16 and f32, with the host's
     enqueue and launch counts per generation (bf16: K4's resident route x 1; f32: its per-frame
     route x 15999; K1 x 50 and K3 x 1 for the prime); the plain loop and the windowed path per
     frame (P3 x 5 and K3 x 1 a frame); a torch.profiler breakdown of a generation
 18. the driver's generation hook writes two 16000-sample wav files under
     blvm_tpu_torch/_build/generation_hook/ (gitignored)
 19. K5 lstm_recurrence vs its twin, f32 and bf16: H=256, B=10 utterances of
     300-1125 stacks; H=32; a given (h0, c0). f32 free-running, bf16 teacher-forced
 20. K5-bwd vs autograd of the twin at the same cases (dxw, dW_hh, db_hh, dh0, dc0)
 21. the LSTM test pass: flags of benchmarks.txt:12 -> driver -> model -> weights
     bridge, 6 mu-law utterances of 24k-72k samples, whole and --split_eval
     (chunks of 16 stacks, s_n carried); 1 K5, 1 K2, 1 K3 a forward; bits/frame
     against the twins
 22. the LSTM train slice: 3 Adam steps through the driver's train on 10
     utterances a step; 1 K5, 1 K5-bwd, 1 K2, 1 K2-bwd, 1 K3 a step, none on the
     plain path; losses and step-0 gradients against the twins
 23. generation through the LSTM driver's hook: 2 x 250 stacks (2 x 16000 frames),
     250 K5 and 250 K3 launches, two wav files under
     blvm_tpu_torch/_build/lstm_generation_hook/; the rollout at the mode against
     the forward's DMoL mode with the generated prefix fed back
 24. timing: K5 and K5-bwd against their twins and torch.nn.LSTM (cuDNN, the
     yardstick; the port never calls it), K5 at the s=1 shape (T' = 16000), the
     train step, the test pass and a generation, a torch.profiler breakdown
 25. K8 vrnn_cell vs its twin in inference mode: the spec width at B=6 utterances of
     24k-72k samples (up to 1125 stacks); H=32 with a given h0. Teacher-forced (a twin
     step from the kernel's state at every t) and free-running
 26. K8 in prior mode (generation) vs its twin: T'=1 sampled and at the mode, T'=64;
     a VRNN forward and backward on the card launch K8 (save mode) and K8-bwd once each
 27. the VRNN test pass: flags of benchmarks.txt:17 -> driver -> model -> weights
     bridge, the utterances of 25, whole and --split_eval (chunks of 16 stacks, h_n
     carried); 1 K8, 1 K2, 1 K3 a forward; bits/frame against the twins, same noise
 28. generation through the VRNN driver's hook: 2 x 2000 stacks (2 x 128000 frames),
     2000 K8 and 2000 K3 launches, two wav files under
     blvm_tpu_torch/_build/vrnn_generation_hook/; a rollout from given noise and
     uniforms against the twins fed the same noise and the kernel's frames
 29. timing: K8 and its twin a launch and a step at the test pass's shape and at T'=1,
     a T'=1 call split into the wrapper's host time and the device time of its
     kernels, K8's own trace of a step by stage and phase, the test pass whole
     and split, a generation, torch.profiler breakdowns of a test pass and of 200
     generated stacks
 30. K8-bwd vrnn_cell_bwd (through VRNNCellFunction) and autograd of the f32 twin, both
     held to autograd of the f64 twin over every gradient (xpost, xg, h0, 28 weights):
     the train shape (19 utterances, ~1000 stacks, ragged, orthogonal w_hh), H=32 with a
     given h0, h not conditioned on x; K8-bwd alone against its f64 twin
 31. the VRNN train slice: flags of benchmarks.txt:17 -> driver -> model -> weights
     bridge -> vrnn_audio.train with its annealers, 3 Adam steps on 19 utterances of
     40k-64k samples; 1 K8, 1 K8-bwd, 1 K2, 1 K2-bwd, 1 K3 a step, none on the plain
     path; losses against the twins fed the same noise, beta and free nats against the
     annealers; step-0 gradients, kernels and f32 twins held to the f64 twins
 32. timing: K8 in save mode against K8 without it at the train shape, K8-bwd alone and
     the cell's backward against autograd of the twin, K8-bwd's trace by stage and
     phase, the train step (the twins' step timed once) with its host enqueue time and a
     torch.profiler breakdown; the driver's loop under --skip_nonfinite_updates: no host wait
     inside its step spans, one step clean under torch's sync debug mode, a NaN step skipped
 33. K7 gru_recurrence vs its twin at the SRNN test pass's shapes: 6 utterances of 24k-72k
     samples (up to 1125 stacks), H=512, the d GRU's mask and the a GRU's flipped mask; H=32
     with a given h0 and a zero-length row; T'=1. Teacher-forced and free-running
 34. K9 srnn_chain vs its twin in inference mode on the test pass's hoisted d and a, residual
     posterior on and off, teacher-forced and free-running on given noise; prior mode at T'=1
     (sampled and at the mode) and over T'=64
 35. the SRNN test pass: flags of benchmarks.txt:22 -> driver -> model -> weights bridge, the
     utterances of 33, whole and --split_eval (chunks of 16 stacks, d_n and z_n carried); 2 K7,
     1 K9, 1 K2, 1 K3 a forward; bits/frame against the twins, same noise; the chain in prior
     mode with a gradient raises
 36. generation through the SRNN driver's hook: 2 x 2000 stacks (2 x 128000 frames), 2000 K7,
     2000 K9 and 2000 K3 launches, two wav files under
     blvm_tpu_torch/_build/srnn_generation_hook/; a rollout from given noise and uniforms
     against the twins fed the same noise and the kernel's frames
 37. timing: K7 at the d and a shapes against its twin and torch.nn.GRU (cuDNN, the yardstick)
     and at T'=1 (host and device time); K9 a launch and a step, a T'=1 call's host and device
     time, K9's trace by stage and phase; the test pass whole and split, a generation,
     torch.profiler breakdowns of a test pass and of 200 generated stacks
 38. K7-bwd gru_recurrence_bwd (through GRURecurrenceFunction) and autograd of the f32 twin, both
     held to autograd of the f64 twin over every gradient (xw, w_hh, b_hh, h0), a random d h_n in
     each case: the SRNN train step's d GRU (19 utterances, ~1000 stacks, its mask) and a GRU
     (its flipped mask), H=200 with a given h0 and a zero-length row, one row; K7-bwd alone
     against its f64 twin
 39. K9-bwd srnn_chain_bwd (through SRNNChainFunction) the same way over every gradient (xp, xq,
     z0, 14 weights): the train step's hoisted d and a with the residual posterior on and off,
     H=200 and Z=16, one row, some output gradients absent; K9-bwd alone against its f64 twin
 40. the SRNN train slice: flags of benchmarks.txt:22 -> driver -> model -> weights bridge ->
     srnn_audio.train with its annealers, 3 Adam steps on 19 utterances of 40k-64k samples; 2 K7,
     2 K7-bwd, 1 K9, 1 K9-bwd, 1 K2, 1 K2-bwd, 1 K3 a step, none on the plain path; losses
     against the twins fed the same noise, beta and free nats against the annealers; step-0
     gradients, kernels and f32 twins held to the f64 twins
 41. timing: K7 and K9 in save mode against the plain launches at the train shape (bitwise equal
     outputs), K7-bwd and K9-bwd alone against their twins, the GRU's and the chain's backward
     against autograd of the twins, torch.nn.GRU's backward (cuDNN, the yardstick), both
     kernels' traces by stage and phase, the train step (in turns with the twins) with its host
     enqueue time and a torch.profiler breakdown; the driver's loop under --skip_nonfinite_updates (its
     default) as in 32
 42. K1 at STCN's width (C = half = 256) vs its twin, f32 and bf16, B=6 at the test pass's
     first-block length: dilations 1 and 16, the skip at all rows and at the last 1000, skip-free
 43. the STCN test pass: flags of benchmarks.txt:26 -> driver -> model -> weights bridge, 6
     mu-law utterances of 24k-72k samples, whole and --split_eval (chunks of 1000 with the
     receptive field's overlap); 30 K1 (20 skip-free), 1 K2, 1 K3 a forward, none on the plain
     path; loss, ELBO, KL per level and bits/frame against the twins fed the same latent noise;
     the chunked bits/frame against the whole pass
 44. K12 stcn_decode (one launch a generation) vs the plain frame loop over 256 frames from a
     zero history and a speech prefix, fed the same prior noise and uniforms: teacher-forced (each
     frame's z and DMoL parameters) and free-running; two launches bitwise equal; the fast path
     (K12) vs the windowed path (K1 x 30 + K3 a frame) over 16 frames from one generator state
 45. generation through the STCN driver's hook: 2 x 16000 frames, 1 K12 and 30 K1 launches
     (the primes), two wav files under blvm_tpu_torch/_build/stcn_generation_hook/
 46. timing: K1 at STCN's width (with the skip and skip-free) against its twin, K12 a frame over
     2000 and 16000 frames by CUDA events with the host's enqueue, its own trace by phase, against
     the plain loop and the windowed path a frame, the test pass (samples/s) and a generation
     (frames/s), torch.profiler breakdowns of both
 47. K1-bwd at STCN's width (f32, the register-tiled path) at the train step's shapes, skip-free at
     d=1 (5, 1156, 256) and with the skip at d=16 (5, 1141, 256): the kernel and the f32 twin held
     to autograd of the f64 twin over every gradient
 48. the STCN train slice: flags of benchmarks.txt:26 -> driver -> model -> weights bridge ->
     stcn_audio.train with its annealers, 3 Adam steps (value and norm clips) on 20 utterances of
     24k-72k samples a step, cropped to 1000 samples, in 4 microbatches; 120 K1 (80 skip-free),
     120 K1-bwd, 4 K2, 4 K2-bwd, 4 K3 a step, none on the plain path; losses against the twins fed
     the same noise, beta and free nats against the annealers
 49. the step-0 gradients of every parameter on a microbatch: kernels and f32 twins held to the f64
     twins
 50. timing: K1-bwd at the shapes of 47, the whole backward (with the weight-gradient GEMMs) against
     autograd of the twin and the kernel alone, each beside its bound
 51. timing: the train step (accum 4, clips, Adam), kernels and twins in turns, samples/s, the
     host's enqueue time, peak memory
 52. a torch.profiler breakdown of the train step; no host wait on the card inside the microbatch
     loop's spans, and one step under torch's sync debug mode ("error")
 53. one train step at benchmarks.txt:27 (s=64, z=[256], 5 stacks, 20 whole utterances) through
     stcn_audio.train: 6 K1 and 6 K1-bwd (block 0 and the decode stack: the 24 blocks after the only
     used one reach no output and do not run), 1 K2, 1 K2-bwd, 1 K3; the loss and the step-0 gradients
     against the twins

 54. the drivers' loops: the flagship WaveNet train loop (wavenet_audio.train, 10 steps) and whole-batch
     test pass (evaluate, 10 batches) at --metric_fetch_lag 0 and 8: ms a step, the host's waits on the card
     inside the steps' profiler spans (none at lag 8) and in all, the tracker's values the same at both lags
 55. K11 depthwise_norm vs its twin at every block shape of the benchmarks.txt:33 test pass (encoder blocks
     0-2 from (5, 72021, 768), decoder blocks 0-2 back to (5, 72021, 768)), of its first and last --split_eval
     chunks (4 rows in the last encoder block) and of the driver's default two-level width (96, strides
     [64, 16]): the whole pass's and the two-level forward's blocks within 5e-5 of the f64 twin; the chunks'
     within 1e-5 + 1e-5 |twin|, or held to the f64 twin within twice the f32 twin's error
 56. K10 rssm_chain vs its twin: the test pass's inference launch (5, 1125), a chunk's, the two-level
     model's levels (the lower one with its context), and a generation's prior launch (2, 2000):
     teacher-forced 1e-5 + 1e-5 |twin|, free-running 1e-4 + 1e-5 |twin|
 57. the CW-VAE test pass: flags of benchmarks.txt:33 -> driver -> model -> weights bridge, 5 mu-law
     utterances of 24k-72k samples within --batch_len, whole and --split_eval (chunks of 277 samples
     overlapping by 21, each level's (z, h) carried); 1 K10, 6 K11, 1 K2, 1 K3 a forward, none on the plain
     path; bits/frame against the twins fed the same latent noise, rel 1e-5
 58. generation through the CW-VAE driver's hook: 2 x 128000 frames at the DMoL mode, 1 K10 (prior mode,
     2000 steps) and 3 K11 launches, two wav files under blvm_tpu_torch/_build/cwvae_generation_hook/; a
     generation from given latent noise against the twins, held to the f64 twins
 59. timing: K10 against its twin at the test pass's shape and in prior mode; K11 at the six block shapes
     against its twin and the composite of PyTorch calls for the same chain, beside the blocks' 1x1 GEMMs
 60. timing of the test pass (whole and split) and of a generation, torch.profiler breakdowns of both
 61. K11-bwd depthwise_norm_backward at the six block shapes of the benchmarks.txt:33 train step's first batch
     (5 utterances of 46k-51k samples), a --split_eval chunk's top encoder block (a handful of rows) and the
     first block with one all-padding row: the kernel (through DepthwiseNormFunction) and autograd of the f32
     twin held to autograd of the f64 twin over du and the six parameter gradients (twice the f32 twin's error
     plus 1e-6); the padding row's du exactly 0; K11-bwd alone against its f64 twin
 62. K10-bwd rssm_chain_backward: the train step's shape (5, ~800), H = 32 and Z = 16 with a given (z0, h0) and
     two output gradients absent, and a reset every 4 steps: kernel and f32 twin held to the f64 twin over xg, xq,
     z0, h0 and the 20 kernel weights; K10's save mode bitwise equal to K10; K10-bwd alone against its f64 twin
 63. the CW-VAE train slice: flags of benchmarks.txt:33 -> driver -> model -> weights bridge ->
     clockwork_audio.train with its annealers, 3 Adam steps on 5 utterances of 46k-51k samples a step; 1 K10,
     1 K10-bwd, 6 K11, 6 K11-bwd, 1 K2, 1 K2-bwd, 1 K3 a step, none on the plain path; losses against the twins
     fed the same noise; beta and free nats against the annealers
 64. the step-0 gradients of every parameter at the driver's scalars (beta 0, free nats 2) and at beta 1, free
     nats 0: kernels and f32 twins held to the f64 twins
 65. timing: K10 in save mode against K10, K10-bwd and K11-bwd alone against their twins (K11-bwd also against
     autograd of the composite of PyTorch calls), each beside its bound; the train step, kernels and twins in
     turns: samples/s, the host's enqueue, peak memory; a torch.profiler breakdown, no host wait on the card
     inside the driver's step spans, and one step under torch's sync debug mode ("error")
 66. K6 bilstm_recurrence vs its twin, free-running, at layer 0 (D = 80) and layer 1 (D = 512) of a phoneme.txt:8
     train batch (~38 synthetic utterances of 3.0-3.3 s within --batch_len 120 s, ~830 frames), a long one (~16 of
     7.0-7.3 s, ~1850 frames) and an eval batch (~110 of 1.5-5 s within 3 x 120 s: more clusters than are resident):
     within 1e-5, or within twice the f32 twin's error of the f64 twin
 67. K6-bwd (through BiLSTMRecurrenceFunction) and autograd of the f32 twin held to autograd of the f64 twin: the
     train batch's layer 0, its layer 1 with an all-padding row (its gradient exactly 0), the long batch's layer 1;
     K6-bwd alone against its f64 twin; K13 ctc_loss and K13-bwd against their twin (optax's recursion) on the train
     batch's logits, with an infeasible row (optax's finite score) and an empty one (-0.0), and at N = 300 label
     columns (several warps a row) with both
 68. the probe's train slice: flags of phoneme.txt:8 -> driver -> model -> weights bridge -> asr_ctc.train, 3 Adam
     steps with dropout from the train state's generator; 3 K6, 3 K6-bwd, 1 K13, 1 K13-bwd a step, none on the plain
     path; losses against the twins within 1e-5; no host wait inside the driver's step spans, one step under torch's
     sync debug mode; one step at phoneme.txt:7 (stacked waveform frames, D = 64)
 69. the test pass over the eval batch through asr_ctc.evaluate: 3 K6 and 1 K13 a forward; loss, WER and CER against
     the twins', each utterance decoded otherwise traced to a near-tie of the twin's top two logits
 70. timing: K6 and K6-bwd against their twins and torch.nn.LSTM(bidirectional) on packed sequences (cuDNN, the
     yardstick) at the train and the eval batch; K13 (plain and in save mode), K13-bwd and save mode + K13-bwd
     against F.ctc_loss's forward, backward and both, each in turns, and each kernel alone (20 launches of its C
     entry point); [K13-trace], SM cycles a frame of K13 by stage, plain and in save mode; the train
     step (ms, seconds of audio a second, the host's enqueue and build_metrics, a torch.profiler split) and the test
     pass

 P2 and P3, the fused 10-block stack (csrc/wavenet_stack.cu), run after phase 13:
 71. the kernel against the chain of 10 K1 launches (within K1's limits) and its twin (no further than twice the
     chain), f32 and bf16: a stack at (8, 21117, 96) with the last 16000 skip rows, the generation window's first
     stack (2, 5116, 96) and last (2, 1024, 96), one skip row, adding into a sum; the whole forward at B=8, T=16000
     against the K1 chain (rel 1e-5 f32, 1e-3 bf16), 5 P2 and no K1 a forward
 72. the save mode bitwise equal to a plain launch, f32 and bf16
 73. the step-0 gradients through WaveNetStackFunction (5 P2 in save mode, 50 K1-bwd) against autograd of the K1
     chain, f32 and bf16
 74. timing: P2 and P3 in bf16 (P2 also in f32) against the twin and the K1 chain, each beside its bound

Every phase prints one line (the profiles a few); any failure raises and exits
non-zero before the last line (phases 14-70 print all their numbers first). A
``[total]`` line gives the run's seconds; the second-to-last line is the
kernels' JSON record, the last line ``{"ok": true, "device": {...}}``. Exits
non-zero without CUDA.
"""

import contextlib
import json
import math
import subprocess
import sys
import time
import wave
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

FLAGSHIP_FLAGS = (
    "--likelihood DMoL --input_coding mu_law --n_stacks 5 --n_layers 10 --res_channels 96 --num_bits 16 "
    "--num_mix 10 --random_segment_size 16000 --split_eval True --bf16 true --seed 0"
)
B, T = 8, 16000
SEED = 0
# generation: the JAX driver's 2 x 16000 frames (experiments/experiment_wavenet_audio.py:80); K4 against its
# twin over 128 frames (the plain loop takes ~14 ms a frame); the windowed oracle over 16 frames (8 timed)
GEN_B, N_GEN, N_K4, N_NAIVE, N_NAIVE_TIME = 2, 16000, 128, 16, 8
# the card's published peaks (H100 SXM data sheet, dense, at 700 W): the bound of a kernel is the
# larger of its compulsory bytes over HBM bandwidth and its operations over the peak of their type
HBM_BYTES_PER_S, BF16_PEAK, F32_PEAK = 3.35e12, 989e12, 67e12
F64_PEAK = 67e12  # the data sheet's FP64 tensor-core rate: a lower bound on time for K13's double arithmetic
DMOL_OPS_PER_COMPONENT = 40  # f32 ops of one component of the ladder (a transcendental counted as one)
# LSTMAudio: the s=64 run spec of experiments/benchmarks.txt:12 (the driver's defaults fill in --num_bits 16,
# --num_mix 10, f32); K5 at 10 utterances of up to 1125 stacks (72k samples)
LSTM_FLAGS = (
    "--likelihood DMoL --input_coding mu_law --batch_len 32 --hidden_size 256 --num_layers 1 --stack_size 64 --seed 0"
)
LSTM_B, LSTM_T = 10, 1125
# VRNN: the s=64 z=256 run spec of experiments/benchmarks.txt:17 (the driver's defaults fill in the residual
# posterior, h conditioned on x and x on h, r_dim = 512; f32); K8 at 6 utterances of up to 1125 stacks
VRNN_FLAGS = (
    "--likelihood DMoL --input_coding mu_law --batch_len 64 --free_nats_start_value 2 --free_nats_steps 100000 "
    "--hidden_size 256 --latent_size 256 --stack_frames 64 --num_bits 16 --num_mix 10 --seed 0"
)
VRNN_B, VRNN_T = 6, 1125
# the VRNN train step: the --batch_len 64 budget (1,024,000 samples, packed as a sum of lengths) in 19
# utterances of 40k-64k samples a step, up to 1000 stacks
VRNN_TRAIN_B, VRNN_BUDGET, VRNN_TRAIN_LENGTHS = 19, 64 * 16000, (40000, 64000)
# SRNN: the s=64 z=256 run spec of experiments/benchmarks.txt:22 (the driver's defaults fill in the residual
# posterior and smoothing, r_dim = 512; f32); K7 and K9 at 6 utterances of up to 1125 stacks
SRNN_FLAGS = VRNN_FLAGS
SRNN_B, SRNN_T = 6, 1125
# STCN: the s=1 z=[256,128,64,32,16] run spec of experiments/benchmarks.txt:26 (the driver's defaults fill in
# 256 channels, 5 x 5 blocks, the precision-weighted posterior, dense top-down, f32); the test pass at 6
# utterances of 24k-72k samples, chunks of --random_segment_size 1000; K12 against its twin over 256 frames
STCN_FLAGS = (
    "--likelihood DMoL --input_coding mu_law --batch_size 20 --beta_anneal_steps 0 --free_nats_steps 25000 "
    "--dense True --num_stack_frames 1 --latent_size 256 128 64 32 16 --random_segment_size 1000 "
    "--max_grad_norm 1.0 --max_grad_value 0.1 --accum_steps 4 --seed 0"
)
STCN_B, STCN_T, N_K12 = 6, 72000, 256
# the s=64 z=[256] run spec of experiments/benchmarks.txt:27 (5 stacks of 5 blocks, one latent level, whole
# utterances, no accumulation): one train step on 20 utterances of 24k-72k samples
STCN27_FLAGS = (
    "--likelihood DMoL --input_coding mu_law --batch_size 20 --beta_anneal_steps 25000 --free_nats_steps 50000 "
    "--dense True --num_stack_frames 64 --latent_size 256 --num_stacks 5 --seed 0"
)
# the CW-VAE: the d=192 z=[128] s=[64] run spec of experiments/benchmarks.txt:33 (one level, the precision-weighted
# posterior, 3 blocks of stride 4 a coder, DMoL 10 x 2^16, f32); the test pass at 5 utterances of 24k-72k samples within
# the driver's --batch_len budget (16000 x 16 samples); generation 2 x 128000 frames
CWVAE_FLAGS = (
    "--likelihood DMoL --input_coding mu_law --beta_anneal_steps 150000 --free_nats_steps 300000 "
    "--precision_posterior True --num_bits 16 --num_mix 10 --length_sampler True --hidden_size 192 --latent_size 128 "
    "--strides 64 --seed 0"
)
CWVAE_B, CWVAE_T, CWVAE_BUDGET = 5, 72000, 16000 * 16
# the CW-VAE train step: the same --batch_len budget (256000 samples) in 5 utterances of 46k-51k samples a step, the
# length sampler's pool of lengths within 0.3 s of each other
CWVAE_TRAIN_B, CWVAE_TRAIN_LENGTHS = 5, (46000, 50800)
# the CTC phoneme probe: the run spec of experiments/phoneme.txt:8 (3 bidirectional layers of H = 256 over 80 log-mel
# bins at hop 64, temporal dropout 0.3, the driver's --batch_len 120 s, clips and Adam); a train batch of ~38
# utterances of 3.0-3.3 s (the train sampler's 0.3 s pool), a long one of ~16 of 7.0-7.3 s, an eval batch of ~110 of
# 1.5-5 s within the eval sampler's 3 x 120 s; and :7 (stacked waveform frames, D = 64, no dropout)
ASR_FLAGS = "--hidden_size 256 --num_layers 3 --bidirectional True --dropout_prob 0.30 --epochs 30 --data_type spectrogram --seed 0"
ASR_WAVEFORM_FLAGS = "--hidden_size 256 --num_layers 3 --bidirectional True --dropout_prob 0.00 --epochs 30 --data_type waveform --seed 0"
ASR_TRAIN_SECONDS, ASR_LONG_SECONDS, ASR_EVAL_SECONDS = (3.0, 3.3), (7.0, 7.3), (1.5, 5.0)
# host calls that wait on the card, and ops that read a device value to the host
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "aten::item",
               "aten::_local_scalar_dense")


_PHASE_CLOCK = [time.time()]
PHASE_SECONDS = {}  # wall seconds by phase tag, summed over its lines


def phase(tag, /, **values):
    """Print a phase's line; ``phase_s`` is the wall time since the previous line, the work that led to this one."""
    now = time.time()
    seconds, _PHASE_CLOCK[0] = now - _PHASE_CLOCK[0], now
    PHASE_SECONDS[tag] = PHASE_SECONDS.get(tag, 0.0) + seconds
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in values.items()) + f" phase_s={seconds:.1f}", flush=True)


def require(cond, message):
    if not cond:
        raise AssertionError(message)


def roofline(bytes_, flops, peak):
    """``bound_ms`` and ``bound_by`` of work that must move ``bytes_`` and do ``flops``."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def residual_glu_work(B, T_in, C, half, S, dilation, skip_size, elem=4):
    """``roofline`` keywords of one K1 launch: x read once, o and the skip rows written once, the weights
    read once; the gate's and the [r | s] product's multiply-adds (S = 0: the skip-free mode)."""
    T_out = T_in - dilation
    weights = 4 * C * half + 2 * half + half * (C + S) + C + S
    return dict(bytes_=elem * (B * T_in * C + B * T_out * C + B * skip_size * S + weights),
                flops=2 * B * T_out * (4 * C * half + half * (C + S)))


def residual_glu_bwd_work(B, T_in, C, half, S, dilation, skip_size, weight_grads=True, elem=4):
    """``roofline`` keywords of one K1-bwd call (S = 0: the skip-free mode): x, dO, dS and the weights read
    once, dx written once; the multiply-adds this call's rows need: the gate recomputed over the L output rows,
    d_act (dO's share over every row, dS's over the skip rows), dx (each d_pre row times both taps). With
    ``weight_grads`` (the whole backward) also the weight-gradient products and the weight gradients written;
    without (the kernel alone) d_pre and act written instead."""
    L = T_in - dilation
    weights = 4 * C * half + 2 * half + half * (C + S) + C + S
    macs = B * L * 4 * C * half + B * L * half * C + B * skip_size * half * S + B * L * 2 * half * 2 * C
    if weight_grads:
        macs += B * L * (4 * C * half + half * C) + B * skip_size * half * S
        written = weights
    else:
        written = B * L * 3 * half
    return dict(bytes_=elem * (2 * B * T_in * C + B * L * C + B * skip_size * S + weights + written), flops=2 * macs)


def wg_bwd_kernel_work(kernel, B, T_in, dilation, skip_size, n_split=0, C=96):
    """``roofline`` keywords of one launch of a kernel of K1-bwd's warpgroup route (bf16, C = half = R = S): each
    input read once, each output written once, the multiply-adds its rows need. pass_a: x, dO, dS and the weights
    in, d_pre and act out; wgrad: x, d_pre, act, dO and dS in, the weight and bias gradients out (the function's
    outputs: the ``n_split`` f32 partials it writes for reduce are the split's own overhead, which reduce's bound
    shows); reduce: the partials in, the weight gradients out; pass_b: d_pre, dO and the gate weights in, dx out."""
    L = T_in - dilation
    weights = 6 * C * C + 2 * C + 2 * C * C + 2 * C
    part = 4 * n_split * 3 * ((96 + 48) * 128 + 128)
    if kernel == "pass_a":
        return dict(bytes_=2 * (B * T_in * C + B * L * C + B * skip_size * C + weights + B * L * 3 * C),
                    flops=2 * (B * L * 4 * C * C + B * L * C * C + B * skip_size * C * C))
    if kernel == "wgrad":
        return dict(bytes_=2 * (B * T_in * C + B * L * 4 * C + B * skip_size * C + weights),
                    flops=2 * (B * L * 4 * C * C + B * L * C * C + B * skip_size * C * C))
    if kernel == "reduce":
        return dict(bytes_=part + 2 * weights, flops=part // 4)
    return dict(bytes_=2 * (B * L * 2 * C + B * L * C + 4 * C * C + B * T_in * C), flops=2 * B * L * 4 * C * C)


def wavenet_step_bwd_work(B, T_in, C, dilations, skip_size, elem=2):
    """``roofline`` keywords of the residual stacks' backward in one WaveNet train step: K1-bwd with its weight
    gradients (:func:`residual_glu_bwd_work`) summed over every block of every stack, ``dilations`` all of them in
    order, ``T_in`` the first block's input rows."""
    total = dict(bytes_=0, flops=0)
    for d in dilations:
        work = residual_glu_bwd_work(B, T_in, C, C, C, d, skip_size, elem=elem)
        total = {k: total[k] + work[k] for k in total}
        T_in -= d
    return total


def wavenet_stack_work(B, T_in, C, dilations, skip_size, taps=0, accumulate=False, save=False, elem=2):
    """``roofline`` keywords of one P2/P3 launch (C = half = R = S): x read once, the stack's output written once,
    the f32 skip sum written once (and read once where it is added into), the taps written, every block's weights
    read once, in save mode every later block's input written too; each block's gate and [r | s] multiply-adds over
    the output rows it has."""
    rows, T_out, inner = 0, T_in, 0
    for l, d in enumerate(dilations):
        if l > 0:
            inner += T_out
        T_out -= d
        rows += T_out
    weights = len(dilations) * (4 * C * C + 2 * C + 2 * C * C + 2 * C)
    return dict(bytes_=elem * (B * T_in * C + B * T_out * C + taps * B * skip_size * C + weights
                               + (B * inner * C if save else 0)) + 4 * B * skip_size * C * (2 if accumulate else 1),
                flops=2 * B * rows * (4 * C * C + 2 * C * C))


def wavenet_frame_work(B, C, dilations, M, elem, frames=1):
    """``roofline`` keywords of a K4 frame (B sequences, blocks of the given dilations at C = half = R = S, a DMoL
    head of M mixtures) in a launch of ``frames`` frames, a launch's bytes shared over its frames: every weight read
    once a launch (the stack's in ``elem`` bytes, the causal tap, out_transform and head in f32), each buffer slot
    the launch touches (min(d, frames) of a block) read once and written once, each frame's sample written; one
    multiply-add a weight a sequence a frame. ``frames`` = 1 is the per-frame route's launch, and the yardstick
    PR 3 set for either route: every weight read every frame."""
    L = len(dilations)
    stack = C * C + C + L * (4 * C * C + 2 * C + 2 * C * C + 2 * C)
    f32 = 3 * C + C * C + C + C * 3 * M + 3 * M
    slots = sum(min(d, frames) for d in dilations)
    return dict(bytes_=(elem * stack + 4 * f32 + 2 * B * slots * C * elem) / frames + 4 * B,
                flops=2 * B * (stack + f32))


def stcn_frame_work(B, C, half, S, enc_dilations, n_used, n_dec, latent_size, D, frames=1):
    """``roofline`` keywords of a K12 frame (B sequences, f32) in a launch of ``frames`` frames, a launch's bytes
    shared over its frames: every weight the frame touches read once a launch (the causal tap, the encoder's
    in_transform and blocks, the used blocks' skip columns only, the prior heads at their input widths, the
    decode in_transform and blocks, the upsample and likelihood Dense), each buffer slot the launch touches
    (min(d, frames) of an encoder block, one of a decode block) read once and written once, each frame's noise
    read and sample written; two operations a multiply-add a row. ``frames`` = 1 is the yardstick of the
    per-frame design: every weight read every frame."""
    n_enc, Z, H, L = len(enc_dilations), sum(latent_size), C, len(latent_size)
    prior = sum(2 * ((S + (latent_size[l + 1] if l + 1 < L else 0)) * H + H * H + H * z)
                for l, z in enumerate(latent_size))
    macs = (C * C + n_enc * 2 * C * 2 * half + (n_enc * C + n_used * S) * half + prior + Z * C
            + n_dec * (2 * C * 2 * half + half * (C + S)) + S * D + D * D)
    biases = (3 * C + n_enc * (2 * half + C) + n_used * S + 2 * (2 * H * L + Z) + C + n_dec * (2 * half + C + S)
              + 2 * D)
    slots = sum(min(d, frames) for d in enc_dilations) + n_dec
    return dict(bytes_=4 * ((2 * C + macs + biases + 2 * B * C * slots) / frames + B * (Z + 1)), flops=2 * B * macs)


WG_BWD_KERNELS = ("glu_bwd_pass_a", "glu_bwd_wgrad", "glu_bwd_reduce", "glu_bwd_pass_b")


class WgRoute:
    """K1-bwd's warpgroup route kernel by kernel through its C entry points (no launch counted), on buffers made
    once, for holding each kernel to its plain part on the same inputs and for timing each alone. ``w``: the five
    weights the backward reads (bf16, C = 96)."""

    def __init__(self, cuda, x, w, d_o, d_s, dilation, skip_size):
        from blvm_tpu_torch.ops import residual_glu as rg

        self.cuda, self.lib, self.rg = cuda, cuda.library(), rg
        self.x, self.w, self.d_o, self.d_s, self.d, self.skip = x, w, d_o, d_s, dilation, skip_size
        B, T_in, C = x.shape
        L = T_in - dilation
        self.B, self.T_in, self.L = B, T_in, L
        self.n_split = rg.wg_splits(x.device, B, L)
        self.d_pre = torch.empty(B, L, 2 * C, dtype=x.dtype, device=x.device)
        self.act = torch.empty(B, L, C, dtype=x.dtype, device=x.device)
        self.dx = torch.empty_like(x)
        self.part = torch.empty(self.n_split * rg.WG_PART_FLOATS, device=x.device)
        self.out = [torch.empty_like(t) for t in w] + [torch.empty(2 * C, dtype=x.dtype, device=x.device)]
        self.stream = cuda.stream_handle(x)

    def pass_a(self, _=None):
        self.cuda.check(self.lib.blvm_glu_bwd_pass_a(
            *(t.data_ptr() for t in (self.x, *self.w, self.d_o, self.d_s, self.d_pre, self.act)), self.B, self.T_in,
            self.d, self.skip, self.stream), "glu_bwd_pass_a")

    def wgrad(self, _=None):
        self.cuda.check(self.lib.blvm_glu_bwd_wgrad(
            *(t.data_ptr() for t in (self.x, self.d_o, self.d_s, self.d_pre, self.act, self.part)), self.B,
            self.T_in, self.d, self.skip, self.n_split, self.stream), "glu_bwd_wgrad")

    def reduce(self, _=None):
        self.cuda.check(self.lib.blvm_glu_bwd_reduce(self.part.data_ptr(), *(t.data_ptr() for t in self.out),
                                                     self.n_split, self.stream), "glu_bwd_reduce")

    def pass_b(self, _=None):
        self.cuda.check(self.lib.blvm_glu_bwd_pass_b(
            *(t.data_ptr() for t in (self.w[0], self.w[1], self.d_pre, self.d_o, self.dx)), self.B, self.T_in,
            self.d, self.stream), "glu_bwd_pass_b")

    # the plain parts (ops/residual_glu.py), on the same inputs
    def pass_a_plain(self, _=None):
        return self.rg.glu_bwd_pass_a_plain(self.x, *self.w, self.d_o, self.d_s, self.d, self.skip)

    def weight_grads_plain(self, _=None):
        return self.rg.glu_bwd_weight_grads_plain(self.x, self.d_pre, self.act, self.d_o, self.d_s, self.d, self.skip,
                                                  2 * self.x.shape[-1])

    def reduce_plain(self, _=None):
        return self.part.view(self.n_split, -1).sum(0)

    def pass_b_plain(self, _=None):
        return self.rg.glu_bwd_pass_b_plain(self.w[0], self.w[1], self.d_pre, self.d_o, self.d, self.T_in)


def wg_route_checks(cuda, x, w, d_o, d_s, dilation, skip, got, worst):
    """Phase 9's holds on the warpgroup route at one shape (bf16): each kernel against its plain part on the same
    inputs (pass A's d_pre and act, and pass B's dx, within K1's bf16 limits; the weight gradients from the twin's
    d_pre and act by the partials and their sum, each within 4e-3 of its norm, one bf16 rounding of f32 sums taken
    in another order), the whole route (``got``, through autograd) against its twin and the twin in f64 (each
    gradient's relative-norm error at most twice the bf16 twin's plus 1e-3), and two runs bitwise equal. Updates
    ``worst`` (each kernel's largest absolute error); returns the phase's fields."""
    from blvm_tpu_torch.ops import residual_glu as rg

    rtol, atol = 2.0**-6, 5e-2  # phase 4's bf16 limits, K1's own
    route = WgRoute(cuda, x, w, d_o, d_s, dilation, skip)

    def held(a, ref, what):
        err = (a.float() - ref.float()).abs()
        require((err - (atol + rtol * ref.float().abs())).max().item() <= 0, f"{what} d={dilation}: over K1's limits")
        return err.max().item()

    route.pass_a()
    d_pre_t, act_t = route.pass_a_plain()
    e_a = max(held(route.d_pre, d_pre_t, "glu_bwd_pass_a d_pre"), held(route.act, act_t, "glu_bwd_pass_a act"))
    route.d_pre.copy_(d_pre_t)
    route.act.copy_(act_t)
    route.wgrad()
    route.reduce()
    ref_w = route.weight_grads_plain()
    rels_w = [rel_norm(a, b) for a, b in zip(route.out, ref_w)]
    require(max(rels_w) <= 4e-3, f"glu_bwd_wgrad + reduce d={dilation}: relative errors {rels_w}")
    e_w = max((a.float() - b.float()).abs().max().item() for a, b in zip(route.out, ref_w))
    route.pass_b()
    e_b = held(route.dx, route.pass_b_plain(), "glu_bwd_pass_b dx")
    for name, e in zip(WG_BWD_KERNELS, (e_a, e_w, e_w, e_b)):
        worst[name] = max(worst[name], e)

    again = rg.residual_glu_backward(x, *w, d_o=d_o, d_s=d_s, dilation=dilation, skip_size=skip)
    twice = rg.residual_glu_backward(x, *w, d_o=d_o, d_s=d_s, dilation=dilation, skip_size=skip)
    require(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(again, twice, got)),
            f"the warpgroup route d={dilation}: two runs (and the autograd run) not bitwise equal")
    twin = rg.residual_glu_backward_plain(x, *w, d_o=d_o, d_s=d_s, dilation=dilation, skip_size=skip)
    ref = rg.residual_glu_backward_plain(x.double(), *(t.double() for t in w), d_o=d_o.double(), d_s=d_s.double(),
                                         dilation=dilation, skip_size=skip)
    errs = [(rel_norm(k, r), rel_norm(t, r)) for k, t, r in zip(again, twin, ref)]
    require(all(e_k <= 2 * e_t + 1e-3 for e_k, e_t in errs), f"the warpgroup route d={dilation} against the f64 "
            f"twin: (kernel, bf16 twin) relative errors {errs}")
    return dict(kernels_max_abs_err=[f"{e:.3g}" for e in (e_a, e_w, e_b)], weight_grads_rel=f"{max(rels_w):.3g}",
                route_vs_f64=f"{max(e for e, _ in errs):.3g}", twin_vs_f64=f"{max(e for _, e in errs):.3g}",
                bitwise_repeat=True)


def rel_norm(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def held_to_f64(got, twin, ref, names):
    """Each gradient's largest error relative to its largest value, the kernel's and the f32 twin's, against the f64
    twin: ``(errors, all finite, the gradients where the kernel's is above twice the twin's plus 1e-6)``."""
    errs = {}
    for n_, a_, b_, r_ in zip(names, got, twin, ref):
        scale = r_.abs().max().clamp_min(1e-30)
        errs[n_] = (((a_.double() - r_).abs().max() / scale).item(), ((b_.double() - r_).abs().max() / scale).item())
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    return errs, finite, {k: v for k, v in errs.items() if v[0] > 2 * v[1] + 1e-6}


def recorded(module, name):
    """A patch that keeps every call of ``module.name``: its arguments, for the kernels' checks."""
    calls, fn = [], getattr(module, name)

    def keep(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)

    return calls, mock.patch.object(module, name, keep)


def depthwise_composite(a, k):
    """K11's chain from PyTorch's own calls, channels first: the yardstick beside K11 and K11-bwd, not a path of the
    port."""
    u, s1, b1, w, db, s2, b2 = a
    C = u.shape[-1]
    g = F.group_norm(torch.relu(u).transpose(1, 2), C, s1, b1, eps=1e-5)
    conv = F.conv_transpose1d if k["transposed"] else F.conv1d
    v = conv(g, w.permute(2, 1, 0), db, stride=k["stride"], dilation=k["dilation"], groups=C)
    return F.group_norm(torch.relu(v), C, s2, b2, eps=1e-5).transpose(1, 2)


def device_us(event):
    """An event's own device time in microseconds, under either name torch.profiler gives it."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def profiled(fn, label, per, unit, card):
    """Print ``fn()``'s wall time, device time, idle share and launches under torch.profiler, each per
    ``unit`` (``per`` units in the run), and its eight largest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ = device_kernels(prof)
    busy_ms = sum(device_us(e) for e in kernels_) / 1e3
    phase(label, card=card, wall_ms=f"{wall_ms:.3f}", device_ms=f"{busy_ms:.3f}",
          idle_share=f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured",
          kernel_launches=sum(e.count for e in kernels_), **{f"wall_ms_per_{unit}": f"{wall_ms / per:.4f}"})
    for e in sorted(kernels_, key=device_us, reverse=True)[:8]:
        print(f"  {device_us(e) / 1e3 / per:9.4f} ms/{unit} {e.count // per:5d} calls/{unit}  {e.key[:90]}", flush=True)


def device_kernels(prof):
    """The device kernels of a ``torch.profiler`` run: CUDA events with device time, not named like a
    host op or annotation."""
    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
            and e.key not in host_names]


class StepLog:
    """A tracker that also keeps each step's metric values, in order."""

    def __init__(self, tracker):
        self.tracker, self.steps = tracker, []

    def update(self, metrics, source):
        self.tracker.update(metrics, source)
        self.steps.append({m.name: m.value for m in metrics})


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


def alternate(plain_fn, kernel_fn, inputs, warmup=3):
    """Median times of the plain and the kernel version, run in turns
    plain, kernel, kernel, plain on the same card, ``warmup`` calls before each turn."""
    samples = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        samples[name] += cuda_time_ms(plain_fn if name == "plain" else kernel_fn, inputs, warmup)
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
    from blvm_tpu_torch.data.transforms import RandomSegment
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.training.train_state import TrainState
    from blvm_tpu_torch.training.train_step import make_train_step

    dev = torch.device("cuda", 0)
    t_start = time.time()

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
        "residual_glu_bwd": dict(name="residual_glu_bwd", route="cuda", source="blvm_tpu_torch/csrc/residual_glu_bwd.cu",
                                 replaces="1788a18^:blvm_tpu/ops/pallas/wavenet_block.py:144"),
        "dmol_log_prob": dict(name="dmol_log_prob", route="cuda", source="blvm_tpu_torch/csrc/dmol.cu",
                              replaces="blvm_tpu/ops/likelihoods.py:142"),
        "dmol_log_prob_bwd": dict(name="dmol_log_prob_bwd", route="cuda", source="blvm_tpu_torch/csrc/dmol.cu",
                                  replaces="blvm_tpu/ops/likelihoods.py:142"),
        "dmol_sample": dict(name="dmol_sample", route="cuda", source="blvm_tpu_torch/csrc/dmol_sample.cu",
                            replaces="blvm_tpu/ops/variational.py:149"),
        # K4's two routes: the resident one (bf16 at C = 96, the flagship's) and the per-frame one (f32, other widths)
        "wavenet_decode_resident": dict(name="wavenet_decode_resident", route="cuda",
                                        source="blvm_tpu_torch/csrc/wavenet_decode.cu",
                                        replaces="blvm_tpu/models/wavenet/wavenet.py:279"),
        "wavenet_decode": dict(name="wavenet_decode", route="cuda", source="blvm_tpu_torch/csrc/wavenet_decode.cu",
                               replaces="blvm_tpu/models/wavenet/wavenet.py:279"),
        # P2 and P3, one kernel: the whole-batch launch and the generation window's
        "wavenet_stack": dict(name="wavenet_stack", route="cuda", source="blvm_tpu_torch/csrc/wavenet_stack.cu",
                              replaces="1788a18^:blvm_tpu/ops/pallas/wavenet_stack.py:128, "
                                       "1788a18^:blvm_tpu/ops/pallas/wavenet_stack.py:219"),
        # K1-bwd's warpgroup route (bf16, C = 96): the same VJP, with the weight gradients XLA took beside it
        **{name: dict(name=name, route="cuda", source="blvm_tpu_torch/csrc/residual_glu_bwd.cu",
                      replaces="1788a18^:blvm_tpu/ops/pallas/wavenet_block.py:144") for name in WG_BWD_KERNELS},
    }
    for entry in record.values():
        # no single PyTorch call computes a residual-GLU block or a stack of them, the DMoL ladder, its sampler or a
        # decode step
        entry["library_ms"] = None
    # K5's yardstick, torch.nn.LSTM (cuDNN), is timed in phase 24
    record["lstm_recurrence"] = dict(name="lstm_recurrence", route="cuda", source="blvm_tpu_torch/csrc/lstm.cu",
                                     replaces="blvm_tpu/modules/recurrent.py:92")
    record["lstm_recurrence_bwd"] = dict(name="lstm_recurrence_bwd", route="cuda", source="blvm_tpu_torch/csrc/lstm.cu",
                                         replaces="blvm_tpu/modules/recurrent.py:92")
    # no single PyTorch call computes the VRNN cell
    record["vrnn_cell"] = dict(name="vrnn_cell", route="cuda", source="blvm_tpu_torch/csrc/vrnn_cell.cu",
                               replaces="blvm_tpu/models/vrnn.py:77", library_ms=None)
    record["vrnn_cell_bwd"] = dict(name="vrnn_cell_bwd", route="cuda", source="blvm_tpu_torch/csrc/vrnn_cell_bwd.cu",
                                   replaces="blvm_tpu/models/vrnn.py:77", library_ms=None)
    # K7's yardstick, torch.nn.GRU (cuDNN), is timed in phase 37; no single PyTorch call computes the SRNN chain
    record["gru_recurrence"] = dict(name="gru_recurrence", route="cuda", source="blvm_tpu_torch/csrc/gru.cu",
                                    replaces="blvm_tpu/modules/recurrent.py:177")
    record["srnn_chain"] = dict(name="srnn_chain", route="cuda", source="blvm_tpu_torch/csrc/srnn_chain.cu",
                                replaces="blvm_tpu/models/srnn.py:68", library_ms=None)
    # K7-bwd's yardstick, torch.nn.GRU's backward (cuDNN), is timed in phase 41
    record["gru_recurrence_bwd"] = dict(name="gru_recurrence_bwd", route="cuda", source="blvm_tpu_torch/csrc/gru_bwd.cu",
                                        replaces="blvm_tpu/modules/recurrent.py:177")
    record["srnn_chain_bwd"] = dict(name="srnn_chain_bwd", route="cuda", source="blvm_tpu_torch/csrc/srnn_chain_bwd.cu",
                                    replaces="blvm_tpu/models/srnn.py:68", library_ms=None)
    # no single PyTorch call computes an STCN decode frame
    record["stcn_decode"] = dict(name="stcn_decode", route="cuda", source="blvm_tpu_torch/csrc/stcn_decode.cu",
                                 replaces="blvm_tpu/models/stcn/stcn.py:486", library_ms=None)
    # no single PyTorch call computes the RSSM cell chain or the depthwise chain (phase 59 times the composite of
    # PyTorch calls for the latter beside it)
    record["rssm_chain"] = dict(name="rssm_chain", route="cuda", source="blvm_tpu_torch/csrc/rssm_cell.cu",
                                replaces="blvm_tpu/modules/rssm.py:46", library_ms=None)
    record["depthwise_norm"] = dict(name="depthwise_norm", route="cuda", source="blvm_tpu_torch/csrc/depthwise_norm.cu",
                                    replaces="blvm_tpu/modules/convolutions.py:88", library_ms=None)
    # the backwards of both: no PyTorch call computes the RSSM chain's; phase 65 times autograd of the composite of
    # PyTorch calls beside K11-bwd
    record["rssm_chain_bwd"] = dict(name="rssm_chain_bwd", route="cuda", source="blvm_tpu_torch/csrc/rssm_cell_bwd.cu",
                                    replaces="blvm_tpu/modules/rssm.py:46", library_ms=None)
    record["depthwise_norm_bwd"] = dict(name="depthwise_norm_bwd", route="cuda",
                                        source="blvm_tpu_torch/csrc/depthwise_norm_bwd.cu",
                                        replaces="blvm_tpu/modules/convolutions.py:88")

    # K6's and K6-bwd's yardstick, torch.nn.LSTM(bidirectional=True) (cuDNN) and its backward, is timed in phase 70
    record["bilstm_recurrence"] = dict(name="bilstm_recurrence", route="cuda", source="blvm_tpu_torch/csrc/bilstm.cu",
                                       replaces="blvm_tpu/modules/lstm_block.py:82")
    record["bilstm_recurrence_bwd"] = dict(name="bilstm_recurrence_bwd", route="cuda",
                                           source="blvm_tpu_torch/csrc/bilstm.cu",
                                           replaces="blvm_tpu/modules/lstm_block.py:82")
    # K13 replaces no TPU kernel (the JAX package's optax.ctc_loss call); its yardstick, F.ctc_loss, in phase 70
    record["ctc_loss"] = dict(name="ctc_loss", route="cuda", source="blvm_tpu_torch/csrc/ctc.cu",
                              replaces="blvm_tpu/models/lstm_asr.py:80")
    record["ctc_loss_bwd"] = dict(name="ctc_loss_bwd", route="cuda", source="blvm_tpu_torch/csrc/ctc.cu",
                                  replaces="blvm_tpu/models/lstm_asr.py:80")

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
    require(counts["wavenet_stack"] == 5 * n_chunks and counts["residual_glu"] == 0,
            f"P2 launches {counts['wavenet_stack']} != 5 x {n_chunks} chunks, or K1 launched {counts['residual_glu']}")
    require(counts["dmol_log_prob"] == n_chunks, f"K2 launches {counts['dmol_log_prob']} != {n_chunks} chunks")
    require(counts["dmol_sample"] == n_chunks, f"K3 launches {counts['dmol_sample']} != {n_chunks} chunks")
    require(counts["residual_glu_bwd"] == counts["dmol_log_prob_bwd"] == counts["wavenet_decode"] == 0,
            f"backward or decode launches in a test pass: {counts}")
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

    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
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
        with plain():
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
        with plain():
            forward(model, xb_)

    fwd = alternate(run_plain, lambda xb_: forward(model, xb_), batches)
    phase("time-forward", card=smi.replace(" ", "_"), B=B, T=T, bf16=True, kernel_ms=f"{fwd['kernel']:.3f}",
          plain_ms=f"{fwd['plain']:.3f}", iterations=len(batches) * 2)

    # K1 alone: one block at d=64, the flagship input length, bf16
    w = [torch.from_numpy(params[f"res_stack/Conv1dResidualGLU_6/{n}"]).to(dev, torch.bfloat16) for n in block_names]
    xs = [torch.randn(B, T + rf, 96, generator=gen, device=dev).to(torch.bfloat16) for _ in range(12)]
    k1 = alternate(lambda x_: modules.residual_glu_plain(x_, *w, dilation=64, skip_size=T),
                   lambda x_: modules.residual_glu(x_, *w, dilation=64, skip_size=T), xs)
    L = T + rf - 64
    record["residual_glu"].update(ms=k1["kernel"], plain_ms=k1["plain"], **roofline(
        bytes_=2 * (B * (T + rf) * 96 + B * L * 96 + B * T * 96 + sum(t.numel() for t in w)),
        flops=2 * B * L * (4 * 96 * 96 + 96 * 192), peak=BF16_PEAK))
    phase("time-K1", card=smi.replace(" ", "_"), shape=f"({B},{T + rf},96)", dilation=64, dtype="bf16",
          kernel_ms=f"{k1['kernel']:.4f}", plain_ms=f"{k1['plain']:.4f}")

    heads = []
    for _ in range(12):
        h = torch.randn(B, T, 3 * M, generator=gen, device=dev) * 0.5
        heads.append((y, h[..., :M], h[..., M : 2 * M].reshape(B, T, 1, M),
                      torch.clamp_min(h[..., 2 * M :].reshape(B, T, 1, M) * 4 - 3, -7.0)))
    k2 = alternate(lambda a: likelihoods.discretized_logistic_mixture_ll(*a, num_bins=num_bins),
                   lambda a: likelihoods.dmol_log_prob(*a, num_bins=num_bins), heads)
    record["dmol_log_prob"].update(ms=k2["kernel"], plain_ms=k2["plain"], **roofline(
        bytes_=4 * B * T * (1 + 3 * M + 1), flops=DMOL_OPS_PER_COMPONENT * B * T * M, peak=F32_PEAK))
    phase("time-K2", card=smi.replace(" ", "_"), frames=B * T, mixtures=M, kernel_ms=f"{k2['kernel']:.4f}",
          plain_ms=f"{k2['plain']:.4f}")

    # 9. K1-bwd against autograd of its twin at the flagship shapes, the cases of phase 4: in f32 K1-bwd and its
    # GEMMs, in bf16 the warpgroup route (four kernels). The route is also held to its own twin (split as its
    # kernels split it) and to that twin in f64, and each of its kernels to its plain part on the same inputs.
    def glu_grads(fn, inputs, d, skip, d_o, d_s):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        o, s = fn(*leaves, dilation=d, skip_size=skip)
        torch.autograd.backward([o, s], [d_o, d_s])
        return [leaf.grad for leaf in leaves]

    # dx elementwise with phase 4's tolerances (f32: FMA order against cuBLAS's; bf16: the
    # twin rounds every op of the forward and the backward to bf16, the kernel once at each
    # store). The weight and bias gradients are sums over all B * L rows, held by their
    # relative norm: f32 1e-5 (the order of the sums), bf16 2e-2 (a handful of roundings of
    # 2^-8 on each term's path in the twin).
    k1b_rel = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    k1b_err = 0.0
    wg_err = dict.fromkeys(WG_BWD_KERNELS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 64, 512):
            block = int(math.log2(d))
            w = [torch.from_numpy(params[f"res_stack/Conv1dResidualGLU_{block}/{n}"]).to(dev, dtype) for n in block_names]
            x = torch.randn(B, T + rf, 96, generator=gen, device=dev).to(dtype)
            for skip in (T + rf - d, T):
                d_o = torch.randn(B, T + rf - d, 96, generator=gen, device=dev).to(dtype)
                d_s = torch.randn(B, skip, 96, generator=gen, device=dev).to(dtype)
                cuda.reset_launch_counts()
                got = glu_grads(modules.residual_glu, [x, *w], d, skip, d_o, d_s)
                torch.cuda.synchronize()
                counts = {k: v for k, v in cuda.launch_counts().items() if v}
                expected = dict(residual_glu=1, **({k: 1 for k in WG_BWD_KERNELS} if dtype == torch.bfloat16
                                                   else dict(residual_glu_bwd=1)))
                require(counts == expected, f"K1-bwd {dtype} d={d}: launches {counts}, expected {expected}")
                ref = glu_grads(modules.residual_glu_plain, [x, *w], d, skip, d_o, d_s)
                rtol, atol = k1_tol[dtype]
                err = (got[0].float() - ref[0].float()).abs()
                require(all(torch.isfinite(g).all() for g in got), f"K1-bwd {dtype} d={d}: not finite")
                require((err - (atol + rtol * ref[0].float().abs())).max().item() <= 0,
                        f"K1-bwd {dtype} d={d} skip={skip}: dx max err {err.max().item()} over tolerance")
                rels = {n: rel_norm(a, b) for n, a, b in zip(block_names, got[1:], ref[1:])}
                require(max(rels.values()) <= k1b_rel[dtype], f"K1-bwd {dtype} d={d} skip={skip}: {rels}")
                extra = {}
                if dtype == torch.bfloat16:
                    extra = wg_route_checks(cuda, x, w[:5], d_o, d_s, d, skip, got, wg_err)
                else:
                    k1b_err = max(k1b_err, err.max().item())
                phase("K1-bwd", dtype=str(dtype).split(".")[1], dilation=d, skip_rows=skip,
                      dx_max_abs_err=f"{err.max().item():.3g}", param_grad_max_rel=f"{max(rels.values()):.3g}", **extra)
    record["residual_glu_bwd"]["max_abs_err"] = k1b_err
    for name, e in wg_err.items():
        record[name]["max_abs_err"] = e

    # 10. K2-bwd at the flagship head shapes with phase 5's edge rows: the gradient by the
    # head's output (its strided logits, locs and log-scales) of a weighted sum of frames
    head = torch.randn(B, T, 3 * M, generator=gen, device=dev) * 0.5
    head[..., 2 * M :] = torch.clamp_min(head[..., 2 * M :] * 4 - 3, -7.0)
    head[1, :4000, 2 * M :] = -7.0  # tiny scales: the midpoint branch

    def split_head(h):
        return h[..., :M], h[..., M : 2 * M].reshape(*h.shape[:-1], 1, M), h[..., 2 * M :].reshape(*h.shape[:-1], 1, M)

    frame_weight = torch.rand(B, T, generator=gen, device=dev) + 0.5

    def dmol_grad(fn, h, y_):
        h = h.detach().requires_grad_(True)
        (fn(y_, *split_head(h), num_bins=num_bins) * frame_weight.to(h.dtype)).sum().backward()
        return h.grad.double()

    plain_dmol = likelihoods.discretized_logistic_mixture_ll
    got = dmol_grad(likelihoods.dmol_log_prob, head, y)
    torch.cuda.synchronize()
    twin = dmol_grad(plain_dmol, head, y)
    ref = dmol_grad(plain_dmol, head.double(), y.double())
    # frames whose cdf_delta lies within f32 rounding of the ladder's 1e-5 threshold may take
    # another branch in any f32 implementation: counted, and left out of the comparison
    flips = likelihoods.dmol_branch_flips(y, *split_head(head)[1:], num_bins)
    keep = (~flips)[..., None]
    err_k, err_t = ((got - ref).abs() * keep).amax().item(), ((twin - ref).abs() * keep).amax().item()
    # two f32 implementations of the same formulas, rounded in another order: the kernel's
    # error against float64 may be at most twice the f32 twin's, plus 1e-6 absolute
    require(torch.isfinite(got).all(), "K2-bwd: not finite")
    require(err_k <= 2 * err_t + 1e-6, f"K2-bwd: max err {err_k} vs the f32 twin's {err_t}")
    record["dmol_log_prob_bwd"]["max_abs_err"] = err_k
    phase("K2-bwd", frames=B * T, max_abs_err_vs_f64=f"{err_k:.3g}", twin_f32_max_abs_err=f"{err_t:.3g}",
          mean_err=f"{((got - ref).abs() * keep).mean().item():.3g}",
          twin_mean_err=f"{((twin - ref).abs() * keep).mean().item():.3g}",
          branch_flip_frames=int(flips.sum().item()), edge_frames=int(((y == 1) | (y == -1)).sum().item()))

    # 11. K3: fed the twin's uniforms it computes the twin's numbers; its own stream by distribution
    logits_, locs_, scales_ = split_head(head)
    uniforms = (torch.rand(B, T, M, generator=gen, device=dev), torch.rand(B, T, 1, generator=gen, device=dev))
    sample, mode = variational.dmol_sample_and_mode(None, logits_, locs_, scales_, uniforms=uniforms)
    torch.cuda.synchronize()
    ref_sample = variational.rsample_discretized_logistic_mixture(None, logits_, locs_, scales_, uniforms=uniforms)
    k3_err = (sample - ref_sample).abs().max().item()
    # the same f32 ops in the same order: equal up to FMA contraction inside PyTorch's
    # elementwise kernels (a few f32 ulps of |x| <= 1); the mode is a pick, equal exactly
    require(k3_err <= 2.0**-22 and torch.equal(mode, variational.dmol_mode(logits_, locs_)), f"K3: err {k3_err}")
    record["dmol_sample"]["max_abs_err"] = k3_err
    n_stat = 1 << 20
    stat_gen = torch.Generator(device=dev).manual_seed(SEED)
    probs_logits = torch.tensor([0.5, -1.0, 2.0, 0.0, 1.0, -0.3, 0.7, -2.0, 1.5, 0.2], device=dev)
    comp_locs = (torch.arange(M, dtype=torch.float32, device=dev) / 10).expand(n_stat, 1, M).contiguous()
    # components 0.1 apart with a spread of ~1e-4: each sample names its component
    s_, _ = variational.dmol_sample_and_mode(stat_gen, probs_logits.expand(n_stat, M).contiguous(), comp_locs,
                                             torch.full((n_stat, 1, M), -9.0, device=dev))
    counts_ = torch.bincount(torch.round(s_[:, 0] * 10).clamp(0, M - 1).long(), minlength=M).double()
    expected_ = n_stat * torch.softmax(probs_logits.double(), 0)
    chi2 = ((counts_ - expected_) ** 2 / expected_).sum().item()
    mu, scale = 0.1, 0.05
    s_, _ = variational.dmol_sample_and_mode(stat_gen, torch.zeros(n_stat, 1, device=dev),
                                             torch.full((n_stat, 1, 1), mu, device=dev),
                                             torch.full((n_stat, 1, 1), math.log(scale), device=dev))
    xs = torch.sort(s_[:, 0].double())[0]
    cdf = torch.sigmoid((xs - mu) / scale)
    i = torch.arange(1, n_stat + 1, device=dev, dtype=torch.float64)
    ks = torch.maximum(i / n_stat - cdf, cdf - (i - 1) / n_stat).max().item()
    # p = 1e-3 critical values: chi-square with 9 degrees of freedom, Kolmogorov-Smirnov 1.95 / sqrt(n)
    require(chi2 < 27.877 and ks < 1.95 / math.sqrt(n_stat), f"K3 by distribution: chi2 {chi2}, KS {ks}")
    phase("K3", frames=B * T, supplied_uniforms_max_abs_err=f"{k3_err:.3g}", mode_equal=True, stream_frames=n_stat,
          chi2_9dof=f"{chi2:.2f}", chi2_crit=27.877, ks=f"{ks:.5f}", ks_crit=f"{1.95 / math.sqrt(n_stat):.5f}")
    del head, got, twin, ref

    # 12. the train slice: flags -> driver -> model (on the card by default) -> weights bridge -> train
    targs = wavenet_audio.build_args((FLAGSHIP_FLAGS + " --epochs 1 --batch_size 8 --lr 3e-4 --optimizer Adam").split())
    tmodel = wavenet_audio.build_model(targs)
    require(next(tmodel.parameters()).device.type == "cuda", "build_model did not build on the card")
    rng = np.random.default_rng(targs.seed + 1)
    utterances = [(i, synthetic_speech(int(n), rng)) for i, n in enumerate(rng.integers(20000, 48001, 3 * B))]
    train_batches = [utterances[i * B : (i + 1) * B] for i in range(3)]

    def run_train(plain_path_=False):
        weights.load_jax_params(tmodel, params)
        log = StepLog(Tracker())
        with plain() if plain_path_ else contextlib.nullcontext():
            cuda.reset_launch_counts()
            t0 = time.time()
            wavenet_audio.train(tmodel, targs, train_batches, log)
            torch.cuda.synchronize()
            return log.steps, cuda.launch_counts(), time.time() - t0

    steps_k, counts, seconds = run_train()
    expected = dict(wavenet_stack=15, **dict.fromkeys(WG_BWD_KERNELS, 150), dmol_log_prob=3, dmol_log_prob_bwd=3,
                    dmol_sample=3)
    require(counts == {**dict.fromkeys(counts, 0), **expected},
            f"train-step launches {counts}, expected {expected} (5 P2, 50 of each of K1-bwd's four, 1/1/1 a step)")
    for name in expected:
        record[name]["launches"] = counts[name]
    steps_p, counts_p, _ = run_train(plain_path_=True)
    require(not any(counts_p.values()), f"the plain path launched kernels: {counts_p}")
    losses, losses_p = [st["loss"] for st in steps_k], [st["loss"] for st in steps_p]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_p))
    require(all(math.isfinite(v) for st in steps_k for v in st.values()), f"train metrics not finite: {steps_k}")
    # phase 7's bf16 tolerance: per step, the Adam updates from both gradients stay this close
    require(loss_rel <= 1e-3, f"train losses {losses} vs plain {losses_p}")
    phase("train-slice", steps=3, B=B, T=T, losses=[f"{v:.6f}" for v in losses],
          losses_plain=[f"{v:.6f}" for v in losses_p], loss_rel=f"{loss_rel:.3g}",
          launches_per_step={k: v // 3 for k, v in counts.items()}, seconds=f"{seconds:.2f}")

    # step-0 gradients of every parameter: bf16 kernels and bf16 twins both held to the f32
    # twins (TF32 off); then one f32 step, kernels against twins
    x0, sl0 = wavenet_audio.make_train_batch(train_batches[0], targs, 1, RandomSegment(T, seed=targs.seed))
    x0, sl0 = torch.from_numpy(x0).to(dev), torch.from_numpy(sl0).to(dev)

    def step0(m, plain_path_=False):
        weights.load_jax_params(m, params)
        m.zero_grad(set_to_none=True)
        with plain() if plain_path_ else contextlib.nullcontext():
            loss, _, _ = m(x0, sl0, generator=torch.Generator(device=dev).manual_seed(SEED))
            loss.backward()
        return {n: p.grad.detach().clone() for n, p in m.named_parameters()}, loss.item()

    g_k, loss_k = step0(tmodel)
    g_p, loss_p = step0(tmodel, plain_path_=True)
    fmodel = wavenet_audio.build_model(argparse_copy(targs, bf16=False))
    g_fk, loss_fk = step0(fmodel)
    g_f, loss_f = step0(fmodel, plain_path_=True)
    e_k = {n: rel_norm(g_k[n], g_f[n]) for n in g_f}
    e_p = {n: rel_norm(g_p[n], g_f[n]) for n in g_f}
    # bf16: the stack's roundings move every gradient away from the f32 one; the kernel path
    # (one rounding at each store) may be at most twice as far as the twins (a rounding after
    # every op), plus 5e-3 for the head's f32 parameters, which see the same bf16 skips
    worst = max(g_f, key=lambda n: e_k[n] - 2 * e_p[n])
    require(all(torch.isfinite(g).all() for g in g_k.values()), "step-0 gradients not finite")
    require(all(e_k[n] <= 2 * e_p[n] + 5e-3 for n in g_f), f"step-0 gradient {worst}: {e_k[worst]} vs twin {e_p[worst]}")
    e_f = {n: rel_norm(g_fk[n], g_f[n]) for n in g_f}
    f32_loss_rel = abs(loss_fk - loss_f) / abs(loss_f)
    # f32: the same math in another summation order through 50 blocks
    require(f32_loss_rel <= 1e-5 and max(e_f.values()) <= 1e-4, f"f32 step: loss rel {f32_loss_rel}, grads {e_f}")
    phase("train-grads", bf16_max_rel_vs_f32=f"{max(e_k.values()):.3g}", bf16_twin_max_rel_vs_f32=f"{max(e_p.values()):.3g}",
          bf16_kernel_vs_twin_max_rel=f"{max(rel_norm(g_k[n], g_p[n]) for n in g_f):.3g}",
          f32_loss_rel=f"{f32_loss_rel:.3g}", f32_grad_max_rel=f"{max(e_f.values()):.3g}", parameters=len(g_f))
    del g_k, g_p, g_fk, g_f, fmodel
    torch.cuda.empty_cache()

    # 13. timing: the train step, then each backward kernel and the sampler against its twin
    tx, _ = wavenet_audio.build_tx_and_lr(targs)
    weights.load_jax_params(tmodel, params)
    state = TrainState.create(model=tmodel, tx=tx, generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(wavenet_audio.loss_fn)
    crop = RandomSegment(T, seed=targs.seed)
    step_batches = []
    for i in range(8):
        xb_, slb_ = wavenet_audio.make_train_batch(utterances[(i % 3) * B : (i % 3 + 1) * B], targs, i + 2, crop)
        step_batches.append(dict(x=torch.from_numpy(xb_).to(dev), x_sl=torch.from_numpy(slb_).to(dev)))

    def run_step(b_):
        train_step(state, b_, {})

    def run_step_plain(b_):
        with plain():
            train_step(state, b_, {})

    ts = alternate(run_step_plain, run_step, step_batches)
    phase("time-train-step", card=smi.replace(" ", "_"), B=B, T=T, bf16=True, kernel_ms=f"{ts['kernel']:.3f}",
          plain_ms=f"{ts['plain']:.3f}", iterations=len(step_batches) * 2)

    def backward_only(graph):
        outputs, inputs, grad_outputs = graph
        return torch.autograd.grad(outputs, inputs, grad_outputs, retain_graph=True)

    def glu_graph(fn, x_):
        leaves = [x_.requires_grad_(True)] + [t.detach().requires_grad_(True) for t in w6]
        o, s = fn(*leaves, dilation=64, skip_size=T)
        return (o, s), leaves, (torch.randn_like(o), torch.randn_like(s))

    card = smi.replace(" ", "_")
    w6 = [torch.from_numpy(params[f"res_stack/Conv1dResidualGLU_6/{n}"]).to(dev, torch.bfloat16) for n in block_names]
    graphs = []
    for _ in range(8):
        x_ = torch.randn(B, T + rf, 96, generator=gen, device=dev).to(torch.bfloat16)
        graphs.append((glu_graph(modules.residual_glu_plain, x_.clone()), glu_graph(modules.residual_glu, x_.clone())))
    k1b = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), graphs)
    k1b_bound = roofline(**residual_glu_bwd_work(B, T + rf, 96, 96, 96, 64, T, elem=2), peak=BF16_PEAK)
    phase("time-K1-bwd", card=card, shape=f"({B},{T + rf},96)", dilation=64, dtype="bf16",
          kernel_ms=f"{k1b['kernel']:.4f}", plain_ms=f"{k1b['plain']:.4f}", bound_ms=f"{k1b_bound['bound_ms']:.4f}",
          bound_by=k1b_bound["bound_by"], includes="the warpgroup route: its four kernels through autograd")

    # each kernel of the route alone (its C entry point on buffers made beforehand) against its plain part on the same
    # inputs, in turns, beside its bound
    routes = []
    for g_ in graphs:
        (outs, leaves, cots) = g_[1]
        routes.append(WgRoute(cuda, leaves[0].detach(), [t.detach() for t in leaves[1:6]], cots[0], cots[1], 64, T))
    for r_ in routes:  # d_pre and act for the kernels after pass A
        r_.pass_a()
    plain_parts = dict(glu_bwd_pass_a="pass_a_plain", glu_bwd_wgrad="weight_grads_plain", glu_bwd_reduce="reduce_plain",
                       glu_bwd_pass_b="pass_b_plain")
    for name, kernel in zip(WG_BWD_KERNELS, ("pass_a", "wgrad", "reduce", "pass_b")):
        t_ = alternate(lambda r_: getattr(r_, plain_parts[name])(), lambda r_: getattr(r_, kernel)(), routes)
        bound = roofline(**wg_bwd_kernel_work(kernel, B, T + rf, 64, T, n_split=routes[0].n_split), peak=BF16_PEAK)
        record[name].update(ms=t_["kernel"], plain_ms=t_["plain"], **bound)
        phase(f"time-{name}", card=card, shape=f"({B},{T + rf},96)", dilation=64, dtype="bf16", alone_ms=f"{t_['kernel']:.4f}",
              plain_ms=f"{t_['plain']:.4f}", bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"],
              splits=routes[0].n_split if kernel in ("wgrad", "reduce") else None)
    del graphs, routes

    # a stack's backward (10 blocks, dilations 1 .. 512) at the step's shapes, from the first stack's saved inputs:
    # the route a block (stack_backward, the gradients written into the stacked slots) against its twin in turns, its
    # counted launches, the host's enqueue and the device time; five a step
    from blvm_tpu_torch.ops import wavenet_stack as stack_ops

    sdil = [b_.dilation for b_ in tmodel.res_stack.blocks[:10]]
    sparams = [p_.detach() for p_ in stack_ops.pack_blocks(tmodel.res_stack.blocks[:10], torch.bfloat16)]
    cases_ = []
    for _ in range(4):
        x_ = torch.randn(B, T + rf, 96, generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            out_, sum_, inputs_, taps_ = stack_ops._launch(x_, sparams, sdil, T, (0, 5), None, save=True)
        cases_.append((inputs_, torch.randn(out_.shape, generator=gen, device=dev).to(torch.bfloat16),
                       torch.randn(sum_.shape, generator=gen, device=dev),
                       [torch.randn(t_.shape, generator=gen, device=dev).to(torch.bfloat16) for t_ in taps_]))

    def stack_bwd(c_, backward=stack_ops.stack_backward):
        return backward(c_[0], sparams, sdil, T, (0, 5), c_[1], c_[2], c_[3])

    sb = alternate(lambda c_: stack_bwd(c_, stack_ops.stack_backward_plain), stack_bwd, cases_, warmup=1)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    stack_bwd(cases_[0])
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches_ = {k: v for k, v in cuda.launch_counts().items() if v}
    require(launches_ == dict.fromkeys(WG_BWD_KERNELS, 10), f"a stack's backward launched {launches_}")
    sb_bound = roofline(**wavenet_step_bwd_work(B, T + rf, 96, sdil, T), peak=BF16_PEAK)
    phase("time-K1-bwd-stack", card=card, shape=f"({B},{T + rf},96)", blocks=10, device_ms=f"{sb['kernel']:.4f}",
          plain_ms=f"{sb['plain']:.4f}", bound_ms=f"{sb_bound['bound_ms']:.4f}", bound_by=sb_bound["bound_by"],
          host_enqueue_ms=f"{enqueue_ms:.3f}", launches=sum(launches_.values()), per_step_ms=f"{5 * sb['kernel']:.3f}")
    del cases_

    def dmol_graph(fn, h):  # the backward of K2 alone: gradients by its three (strided) inputs
        inputs = list(split_head(h.requires_grad_(True)))
        return fn(y, *inputs, num_bins=num_bins), inputs, frame_weight

    dgraphs = []
    for _ in range(8):
        h = torch.randn(B, T, 3 * M, generator=gen, device=dev) * 0.5
        h[..., 2 * M :] = torch.clamp_min(h[..., 2 * M :] * 4 - 3, -7.0)
        dgraphs.append((dmol_graph(plain_dmol, h.clone()), dmol_graph(likelihoods.dmol_log_prob, h.clone())))
    k2b = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), dgraphs)
    record["dmol_log_prob_bwd"].update(ms=k2b["kernel"], plain_ms=k2b["plain"], **roofline(
        bytes_=4 * B * T * (1 + 3 * M + 1 + 3 * M), flops=2 * DMOL_OPS_PER_COMPONENT * B * T * M, peak=F32_PEAK))
    phase("time-K2-bwd", card=smi.replace(" ", "_"), frames=B * T, mixtures=M, kernel_ms=f"{k2b['kernel']:.4f}",
          plain_ms=f"{k2b['plain']:.4f}")
    heads = [[t.detach() for t in g_[1][1]] for g_ in dgraphs]
    del dgraphs

    def sample_plain(p_):
        with torch.no_grad():
            variational.rsample_discretized_logistic_mixture(None, *p_)
            variational.dmol_mode(p_[0], p_[1])

    k3 = alternate(sample_plain, lambda p_: variational.dmol_sample_and_mode(None, *p_), heads)
    record["dmol_sample"].update(ms=k3["kernel"], plain_ms=k3["plain"], **roofline(
        bytes_=4 * B * T * (3 * M + 2), flops=20 * B * T * M, peak=F32_PEAK))
    phase("time-K3", card=smi.replace(" ", "_"), frames=B * T, mixtures=M, kernel_ms=f"{k3['kernel']:.4f}",
          plain_ms=f"{k3['plain']:.4f}")

    # where the train step's device time goes: torch.profiler over 3 steps, kernels by name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b_ in step_batches[:3]:
            run_step(b_)
        torch.cuda.synchronize()

    events = prof.key_averages()
    kernels_ = device_kernels(prof)
    busy_ms = sum(device_us(e) for e in kernels_) / 1e3 / 3
    # the host's share: the step returns before the card finishes (no sync inside it), so
    # the host clock around the call alone is the time to enqueue one step's work
    torch.cuda.synchronize()
    enqueue = []
    for b_ in step_batches[3:8]:
        t0 = time.perf_counter()
        run_step(b_)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = sum(e.count for e in kernels_) // 3
    phase("profile-train-step", card=smi.replace(" ", "_"), device_ms_per_step=f"{busy_ms:.3f}",
          step_ms=f"{ts['kernel']:.3f}", idle_share=f"{1 - busy_ms / ts['kernel']:.3f}" if busy_ms else "not measured",
          host_enqueue_ms_per_step=f"{sorted(enqueue)[len(enqueue) // 2]:.3f}", kernel_launches_per_step=launches,
          kernel_names=len(kernels_))
    for e in sorted(kernels_, key=device_us, reverse=True)[:14]:
        print(f"  {device_us(e) / 1e3 / 3:9.3f} ms/step {e.count // 3:5d} calls/step  {e.key[:90]}", flush=True)
    host_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host_ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host {e.self_cpu_time_total / 1e3 / 3:9.3f} ms/step {e.count // 3:5d} calls/step  {e.key[:80]}", flush=True)

    stack_phases(record, smi, models, xb, dev)
    generation_phases(record, smi, args, models, dev)
    del models, model, tmodel, state
    torch.cuda.empty_cache()
    lstm_phases(record, smi, dev)
    torch.cuda.empty_cache()
    vrnn_phases(record, smi, dev)
    torch.cuda.empty_cache()
    vrnn_train_phases(record, smi, dev)
    torch.cuda.empty_cache()
    srnn_phases(record, smi, dev)
    torch.cuda.empty_cache()
    srnn_train_phases(record, smi, dev)
    torch.cuda.empty_cache()
    stcn_phases(record, smi, dev)
    torch.cuda.empty_cache()
    stcn_train_phases(record, smi, dev)
    torch.cuda.empty_cache()
    driver_loop_phases(smi, dev)
    cwvae_phases(record, smi, dev)
    cwvae_train_phases(record, smi, dev)
    torch.cuda.empty_cache()
    asr_phases(record, smi, dev)
    slowest = sorted(PHASE_SECONDS.items(), key=lambda kv: kv[1], reverse=True)[:16]
    phase("slowest-phases", **{tag: f"{seconds:.1f}" for tag, seconds in slowest})
    phase("total", seconds=f"{time.time() - t_start:.1f}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    lacking = {e["name"]: [k for k in keys if k not in e] for e in record.values() if any(k not in e for k in keys)}
    phase("record-keys", complete=not lacking, lacking=lacking)
    print(json.dumps({"kernels": list(record.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}), flush=True)
    return 0


def stack_phases(record, smi, models, xb, dev):
    """Phases 71-74, P2 and P3 (the fused residual stack, ``csrc/wavenet_stack.cu``) at the flagship width: the
    kernel against its twin and the chain of K1 launches (a stack at the forward's shape and P3's generation window,
    f32 and bf16; the whole forward at B = 8, T = 16000), its save mode against a plain launch, the step-0 gradients
    through WaveNetStackFunction against autograd of the K1 chain, and the times of P2 and P3 beside their bounds,
    the twin and the K1 chain. ``models`` the forward's bf16 and f32 models (weights from seed 0), ``xb`` phase 7's
    batch."""
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.ops import cuda
    from blvm_tpu_torch.ops import wavenet_stack as stack_ops

    card = smi.replace(" ", "_")
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    m = models[True]
    rf, C, n_layers = m.receptive_field, m.res_channels, m.res_stack.n_layers
    dilations = [b.dilation for b in m.res_stack.blocks[:n_layers]]
    k1_tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0**-6, 5e-2)}  # phase 4's, K1's own

    def weights_of(stack, dtype):
        return stack_ops.pack_blocks(models[dtype == torch.bfloat16].res_stack.blocks[stack * n_layers:
                                                                                    (stack + 1) * n_layers], dtype)

    def k1_chain(x, ps, skip, taps=(), acc=None):
        """The stack as 10 K1 launches, the skips summed in f32 in block order (the model's list path)."""
        o, summed, tapped = x, acc, []
        for l, d in enumerate(dilations):
            o, s_ = modules.residual_glu(o, *(p[l] for p in ps), dilation=d, skip_size=skip)
            summed = s_.to(torch.float32, copy=True) if summed is None else summed.add_(s_)
            tapped += [s_] if l in taps else []
        return o, summed, tapped

    def max_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    # 71. the kernel against the K1 chain within K1's limits (out, the f32 sum, the taps), and no further from the
    # twin (which rounds after every op) than twice the chain is, K1's atol the floor. P2: the first stack of the
    # forward's shape; P3: the generation window's first stack (one skip row) and its last, adding into a sum.
    cases = {"P2": (B, T + rf, T, 0, False), "P3": (GEN_B, rf - 1, 1, 0, False),
             "P3-last": (GEN_B, rf - 1 - 4 * sum(dilations), 1, 4, True)}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, (b_, t_in, skip, stack, accumulate) in cases.items():
            ps = weights_of(stack, dtype)
            x = torch.randn(b_, t_in, C, generator=gen, device=dev).to(dtype)
            acc = torch.randn(b_, skip, C, generator=gen, device=dev) if accumulate else None
            with torch.no_grad():
                cuda.reset_launch_counts()
                out, summed, taps = stack_ops.wavenet_stack(x, ps, dilations, skip, (0, 5),
                                                            acc.clone() if accumulate else None)
                torch.cuda.synchronize()
                launches = cuda.launch_counts()["wavenet_stack"]
                c_out, c_sum, c_taps = k1_chain(x, ps, skip, (0, 5), acc.clone() if accumulate else None)
                t_out, t_sum, _ = stack_ops.wavenet_stack_plain(x, ps, dilations, skip, (), acc)
            rtol, atol = k1_tol[dtype]
            pairs = [(out, c_out), (summed, c_sum), *zip(taps, c_taps)]
            excess = max(((a.float() - r.float()).abs() - (atol + rtol * r.float().abs())).max().item() for a, r in pairs)
            twin_err = max(max_err(out, t_out), max_err(summed, t_sum))
            chain_twin_err = max(max_err(c_out, t_out), max_err(c_sum, t_sum))
            bitwise = all(torch.equal(a, r) for a, r in pairs)
            require(launches == 1 and all(bool(torch.isfinite(a).all()) for a, _ in pairs), f"{label} {dtype}: launches "
                    f"{launches} or not finite")
            require(excess <= 0, f"{label} {dtype}: against the K1 chain over K1's tolerance by {excess}")
            require(twin_err <= max(2 * chain_twin_err, atol), f"{label} {dtype}: {twin_err} from the twin, the K1 "
                    f"chain {chain_twin_err}")
            worst = max(worst, twin_err)
            phase(label, dtype=str(dtype).split(".")[1], shape=f"({b_},{t_in},{C})", skip_rows=skip, stack=stack,
                  accumulate=accumulate, vs_k1_chain_max_abs_err=f"{max(max_err(a, r) for a, r in pairs):.3g}",
                  k1_chain_bitwise=bitwise, vs_twin_max_abs_err=f"{twin_err:.3g}",
                  k1_chain_vs_twin_max_abs_err=f"{chain_twin_err:.3g}")
    record["wavenet_stack"]["max_abs_err"] = worst

    # the whole forward at B = 8, T = 16000 on the fused path against the K1 chain (the list path, one K1 launch a
    # block and the skip-sum adds): phase 7's tolerances against the twins, rel 1e-5 in f32 and 1e-3 in bf16
    list_path = mock.patch.object(modules.ResidualStack, "fused", property(lambda self: False))
    fwd_rel = {True: 1e-3, False: 1e-5}
    for bf16, m_ in models.items():
        with torch.inference_mode():
            cuda.reset_launch_counts()
            loss, mets, _ = m_(xb[0], xb[1], generator=torch.Generator(device=dev).manual_seed(SEED))
            counts = cuda.launch_counts()
            with list_path:
                loss_c, mets_c, _ = m_(xb[0], xb[1], generator=torch.Generator(device=dev).manual_seed(SEED))
        loss_rel = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
        row_rel = ((mets["log_prob"] - mets_c["log_prob"]).abs() / mets_c["log_prob"].abs()).max().item()
        require(counts["wavenet_stack"] == 5 and counts["residual_glu"] == 0, f"forward launches {counts}")
        require(loss_rel <= fwd_rel[bf16] and row_rel <= fwd_rel[bf16],
                f"forward bf16={bf16} against the K1 chain: loss {loss_rel}, rows {row_rel}")
        phase("P2-forward-vs-k1-chain", bf16=bf16, B=B, T=T, loss=f"{loss.item():.6f}", loss_k1_chain=f"{loss_c.item():.6f}",
              loss_rel=f"{loss_rel:.3g}", row_rel=f"{row_rel:.3g}", tolerance=fwd_rel[bf16],
              launches=dict(wavenet_stack=counts["wavenet_stack"], residual_glu=counts["residual_glu"]))

    # 72. the save mode (every block's input kept for the backward) writes the same bits as a plain launch
    for dtype in (torch.float32, torch.bfloat16):
        ps = weights_of(0, dtype)
        x = torch.randn(B, T + rf, C, generator=gen, device=dev).to(dtype)
        with torch.no_grad():
            plain = stack_ops._launch(x, ps, dilations, T, (0, 5), None, save=False)
            saved = stack_ops._launch(x, ps, dilations, T, (0, 5), None, save=True)
            torch.cuda.synchronize()
        same = [torch.equal(a, b_) for a, b_ in ((plain[0], saved[0]), (plain[1], saved[1]), *zip(plain[3], saved[3]))]
        require(all(same) and len(saved[2]) == n_layers, f"P2 save mode {dtype}: outputs equal {same}")
        phase("P2-save", dtype=str(dtype).split(".")[1], shape=f"({B},{T + rf},{C})", bitwise_equal=all(same),
              saved_inputs=len(saved[2]), saved_mb=f"{sum(t.numel() for t in saved[2][1:]) * x.element_size() / 2**20:.1f}")
        del plain, saved

    # 73. step-0 gradients of every parameter through WaveNetStackFunction (P2 in save mode, 50 K1-bwd) against
    # autograd of the K1 chain on phase 7's batch: the same backward kernels on the same forward values. f32 rel
    # 1e-5 (the forward's FMA order through 50 blocks); bf16 rel 2e-2, phase 9's bound for K1-bwd's weight gradients
    grad_rel = {True: 2e-2, False: 1e-5}

    def step0_grads(m_, list_path_=False):
        m_.zero_grad(set_to_none=True)
        with list_path if list_path_ else contextlib.nullcontext():
            cuda.reset_launch_counts()
            loss_, _, _ = m_(xb[0], xb[1], generator=torch.Generator(device=dev).manual_seed(SEED))
            loss_.backward()
        grads = {n: p.grad.detach().clone() for n, p in m_.named_parameters()}
        m_.zero_grad(set_to_none=True)
        return grads, cuda.launch_counts()

    for bf16, m_ in models.items():
        g_f, counts = step0_grads(m_)
        g_c, counts_c = step0_grads(m_, list_path_=True)
        rels = {n: rel_norm(g_f[n], g_c[n]) for n in g_c}
        worst_name = max(rels, key=rels.get)
        bwd = dict.fromkeys(WG_BWD_KERNELS, 50) if bf16 else dict(residual_glu_bwd=50)  # the warpgroup route in bf16
        require(counts["wavenet_stack"] == 5 and counts["residual_glu"] == 0 and all(counts[k] == v for k, v in bwd.items()),
                f"step-0 launches {counts}")
        require(all(torch.isfinite(g).all() for g in g_f.values()) and rels[worst_name] <= grad_rel[bf16],
                f"step-0 gradients bf16={bf16}: {worst_name} {rels[worst_name]} from the K1 chain's")
        phase("P2-step0-grads", bf16=bf16, parameters=len(rels), max_rel_vs_k1_chain=f"{rels[worst_name]:.3g}",
              worst=worst_name, bitwise=all(torch.equal(g_f[n], g_c[n]) for n in g_c), tolerance=grad_rel[bf16],
              launches=dict(wavenet_stack=counts["wavenet_stack"], **{k: counts[k] for k in bwd}),
              k1_chain_launches=dict(residual_glu=counts_c["residual_glu"], **{k: counts_c[k] for k in bwd}))
        del g_f, g_c
    torch.cuda.empty_cache()

    # the stacked form on the card: a stack's backward (stack_backward, every block's gradients written into its slot
    # of the stacked tensors) at the forward's shape from P2's saved inputs, against its twin (the same blocks'
    # twin, in bf16) and the twin in f64 on the same inputs: each stacked gradient's relative-norm error at most twice
    # the bf16 twin's plus 1e-3, as phase 9 holds one block
    ps = weights_of(0, torch.bfloat16)
    x = torch.randn(B, T + rf, C, generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        out, summed, inputs, taps = stack_ops._launch(x, ps, dilations, T, (0, 5), None, save=True)
        cots = (torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16),
                torch.randn(summed.shape, generator=gen, device=dev),
                [torch.randn(t.shape, generator=gen, device=dev).to(torch.bfloat16) for t in taps])
        cuda.reset_launch_counts()
        got = stack_ops.stack_backward(inputs, ps, dilations, T, (0, 5), *cots)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.launch_counts().items() if v}
        twin = stack_ops.stack_backward_plain(inputs, ps, dilations, T, (0, 5), *cots)
        ref = stack_ops.stack_backward_plain([t.double() for t in inputs], [p.double() for p in ps], dilations, T,
                                             (0, 5), cots[0].double(), cots[1].double(), [t.double() for t in cots[2]])
    errs = [(rel_norm(k, r), rel_norm(t, r)) for k, t, r in zip([got[0], *got[1]], [twin[0], *twin[1]], [ref[0], *ref[1]])]
    require(launches == dict.fromkeys(WG_BWD_KERNELS, n_layers), f"a stack's backward launched {launches}")
    require(all(e_k <= 2 * e_t + 1e-3 for e_k, e_t in errs), f"the stack's backward against the f64 twin: {errs}")
    phase("P2-stack-backward-vs-f64", shape=f"({B},{T + rf},{C})", blocks=n_layers, launches=sum(launches.values()),
          max_rel_vs_f64=f"{max(e for e, _ in errs):.3g}", twin_max_rel_vs_f64=f"{max(e for _, e in errs):.3g}")
    del out, summed, inputs, taps, cots, got, twin, ref
    torch.cuda.empty_cache()

    # 74. times: P2 (a stack at the forward's shape) and P3 (the window's first stack), bf16, each against its twin
    # and the K1 chain in turns (CUDA events, a different input each call), beside its bound; f32 P2 reported
    times = {}
    for label, dtype, save in (("P2", torch.bfloat16, False), ("P2", torch.bfloat16, True), ("P3", torch.bfloat16, False),
                               ("P3-last", torch.bfloat16, False), ("P2", torch.float32, False)):
        b_, t_in, skip, _, _ = cases[label]
        ps = weights_of(0, dtype)
        xs = [torch.randn(b_, t_in, C, generator=gen, device=dev).to(dtype) for _ in range(12)]

        def kernel(x_):  # save mode: the train step's forward, every block's input kept for the backward
            return stack_ops._launch(x_, ps, dilations, skip, (0, 5), None, save=save)

        with torch.no_grad():
            t_twin = alternate(lambda x_: stack_ops.wavenet_stack_plain(x_, ps, dilations, skip, (0, 5)), kernel, xs)
            t_chain = alternate(lambda x_: k1_chain(x_, ps, skip, (0, 5)), kernel, xs)
        bound = roofline(**wavenet_stack_work(b_, t_in, C, dilations, skip, taps=2, save=save, elem=dtype.itemsize),
                         peak=BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK)
        label = label + ("-save" if save else "")
        times[label, dtype] = dict(kernel=min(t_twin["kernel"], t_chain["kernel"]), plain=t_twin["plain"],
                                   chain=t_chain["plain"], **bound)
        t_ = times[label, dtype]
        flops = wavenet_stack_work(b_, t_in, C, dilations, skip, taps=2)["flops"]
        phase(f"time-{label}", card=card, dtype=str(dtype).split(".")[1], shape=f"({b_},{t_in},{C})", skip_rows=skip,
              kernel_ms=f"{t_['kernel']:.4f}", kernel_ms_runs=[f"{t_twin['kernel']:.4f}", f"{t_chain['kernel']:.4f}"],
              plain_ms=f"{t_['plain']:.4f}", k1_chain_ms=f"{t_['chain']:.4f}", bound_ms=f"{t_['bound_ms']:.4f}",
              bound_by=t_["bound_by"], tflops=f"{flops / t_['kernel'] / 1e9:.1f}")
    p2, p3, p2f = times["P2", torch.bfloat16], times["P3", torch.bfloat16], times["P2", torch.float32]
    p2s, p3l = times["P2-save", torch.bfloat16], times["P3-last", torch.bfloat16]
    record["wavenet_stack"].update(
        ms=p2["kernel"], plain_ms=p2["plain"], bound_ms=p2["bound_ms"], bound_by=p2["bound_by"], k1_chain_ms=p2["chain"],
        save_ms=p2s["kernel"], save_bound_ms=p2s["bound_ms"],
        p3_ms=p3["kernel"], p3_plain_ms=p3["plain"], p3_bound_ms=p3["bound_ms"], p3_k1_chain_ms=p3["chain"],
        p3_last_ms=p3l["kernel"], p3_last_bound_ms=p3l["bound_ms"],
        f32_ms=p2f["kernel"], f32_plain_ms=p2f["plain"], f32_bound_ms=p2f["bound_ms"], f32_k1_chain_ms=p2f["chain"])


def generation_phases(record, smi, args, models, dev):
    """Phases 14-18, the generation path: K4 against its twin, the fast path against the
    windowed oracle and against the forward, timing, the driver's hook. Each check is
    printed before any raises, so one run shows every number."""
    import numpy as np

    from blvm_tpu_torch.experiments import wavenet_audio
    from blvm_tpu_torch.ops import cuda, variational
    from blvm_tpu_torch.ops.generation import WaveNetDecoder

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    rf, M = models[True].receptive_field, args.num_mix
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def uniforms(n):
        return torch.rand(n, GEN_B, M, generator=gen, device=dev), torch.rand(n, GEN_B, 1, generator=gen, device=dev)

    rng = np.random.default_rng(SEED + 3)
    speech, _ = wavenet_audio.make_batch([synthetic_speech(rf, rng) for _ in range(GEN_B)], args)  # mu-law coded
    histories = {"zero": torch.zeros(GEN_B, rf, 1, device=dev), "speech": torch.from_numpy(speech).to(dev)[..., None]}
    dtype_name = {True: "bf16", False: "f32"}

    # 14. K4 against the plain loop, fed the same uniforms. Teacher forcing (the loop fed the
    # kernel's frames) holds each frame from the same history: f32 the order of the sums (1e-5);
    # bf16 both round where JAX rounds, and a one-ulp difference after another summation order,
    # amplified by the gate, stays within the JAX suite's 5e-2 (tests/models/test_wavenet.py:276).
    # Free-running, f32 is held to the same 1e-5 over all N_K4 frames; bf16 is reported (an ulp
    # that flips a Gumbel pick sends the two trajectories apart for good). bf16 runs K4's resident
    # route (one launch), f32 its per-frame route (one launch a frame).
    k4_tol = {False: 1e-5, True: 5e-2}
    k4_err = {False: 0.0, True: 0.0}
    route = {True: "wavenet_decode_resident", False: "wavenet_decode"}
    for bf16, m in models.items():
        for name, hist in histories.items():
            keys = variational.FrameKeys(None, dev, uniforms(N_K4))
            with torch.no_grad():
                tails, pred0 = m._prime(hist, keys)
                cuda.reset_launch_counts()
                got = WaveNetDecoder(m, tails).run(hist[:, -1, 0], pred0.reshape(-1), N_K4, keys)
                torch.cuda.synchronize()
                counts = cuda.launch_counts()
                launches = counts[route[bf16]]
                again = WaveNetDecoder(m, tails).run(hist[:, -1, 0], pred0.reshape(-1), N_K4, keys)
                forced = m._generate_fast_plain(hist[:, -1:], pred0, tails, N_K4, keys, forced=got)
                free = m._generate_fast_plain(hist[:, -1:], pred0, tails, N_K4, keys)
            err = (got - forced).abs().max().item()
            free_err = (got - free).abs().amax(0)
            over = (free_err > k4_tol[bf16]).nonzero()
            agree = int(over[0]) if len(over) else N_K4
            expected = {route[bf16]: 1 if bf16 else N_K4 - 1, route[not bf16]: 0}
            expect(all(counts[k] == v for k, v in expected.items()), f"K4 {name} launches {counts}, expected {expected}")
            expect(torch.equal(got, again), f"K4 {dtype_name[bf16]} {name}: two runs differ")
            expect(bool(torch.isfinite(got).all()) and got.abs().max().item() <= 1, f"K4 {name}: not finite or outside [-1, 1]")
            expect(err <= k4_tol[bf16], f"K4 {dtype_name[bf16]} {name}: teacher-forced max err {err} over {k4_tol[bf16]}")
            if not bf16:
                expect(agree == N_K4, f"K4 f32 {name}: free-running err {free_err.max().item()} over 1e-5 from frame {agree}")
            k4_err[bf16] = max(k4_err[bf16], err)
            phase("K4", dtype=dtype_name[bf16], history=name, frames=N_K4, kernel=route[bf16], launches=launches,
                  forced_max_abs_err=f"{err:.3g}", tolerance=k4_tol[bf16], free_max_abs_err=f"{free_err.max().item():.3g}",
                  free_frames_before_divergence=agree)
    record["wavenet_decode_resident"]["max_abs_err"] = k4_err[True]
    record["wavenet_decode"]["max_abs_err"] = k4_err[False]

    # 15. the fast path against the windowed oracle from one generator state: one Philox key a
    # generation, stepped by the frame, so K4 and K3 draw the same numbers for the same frame.
    # Frame 0 comes from the same priming forward in both: equal. f32: the JAX suite's 1e-5.
    # bf16: the windowed path's stacks (P3) round as K1 does, once at each store, where K4 rounds
    # after every op as JAX does, so the two differ by bf16 ulps from frame 1 on: reported, held by
    # phase 16.
    for bf16, m in models.items():
        cuda.reset_launch_counts()
        fast = m.generate(GEN_B, N_NAIVE, generator=torch.Generator(device=dev).manual_seed(SEED))
        naive = m.generate(GEN_B, N_NAIVE, fast=False, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        err = (fast - naive).abs().amax(0)
        expect(counts["residual_glu"] == 50 and counts["wavenet_stack"] == 5 * N_NAIVE
               and counts["dmol_sample"] == N_NAIVE + 1 and counts[route[bf16]] == (1 if bf16 else N_NAIVE - 1)
               and counts[route[not bf16]] == 0, f"fast-vs-naive launches {counts}")
        expect(err[0].item() == 0, f"fast-vs-naive {dtype_name[bf16]}: frame 0 differs by {err[0].item()}")
        if not bf16:
            expect(err.max().item() <= 1e-5, f"fast-vs-naive f32: max err {err.max().item()} over 1e-5")
        phase("generate-fast-vs-naive", dtype=dtype_name[bf16], frames=N_NAIVE, max_abs_err=f"{err.max().item():.3g}",
              tolerance=1e-5 if not bf16 else "reported", frames_within_5e_2=int((err <= 5e-2).sum().item()),
              per_frame=[f"{v:.2g}" for v in err.tolist()])

    # 16. teacher forcing over the whole generation: the rf-padded forward of the generated
    # waveform (P2, zero history) and K3 fed the generation's uniforms must give back every
    # frame. f32: the forward's sums in another order than K4's (1e-5); a frame whose Gumbel pick
    # sits within f32 rounding of a tie may flip (at most 1e-4 of the frames). bf16: P2 rounds
    # once at each store, K4 after every op; frames within 5e-2 counted, at least 0.9 of them
    # (a misaligned buffer or a wrong tap leaves a few percent).
    tf_tol, tf_share = {False: 1e-5, True: 5e-2}, {False: 1 - 1e-4, True: 0.9}
    for bf16, m in models.items():
        u = uniforms(N_GEN)
        with torch.no_grad():
            x = m.generate(GEN_B, N_GEN, uniforms=u)
            _, _, out = m(x, torch.full((GEN_B,), N_GEN, dtype=torch.int32, device=dev))
            again, _ = variational.dmol_sample_and_mode(None, *out.parameters,
                                                        uniforms=(u[0].transpose(0, 1), u[1].transpose(0, 1)))
        err = (again[..., 0] - x).abs()
        share = (err <= tf_tol[bf16]).double().mean().item()
        expect(bool(torch.isfinite(x).all()) and x.shape == (GEN_B, N_GEN), "teacher-forced: generated shape/finite")
        expect(share >= tf_share[bf16], f"teacher-forced {dtype_name[bf16]}: share {share} below {tf_share[bf16]}")
        phase("generate-teacher-forced", dtype=dtype_name[bf16], frames=GEN_B * N_GEN, tolerance=tf_tol[bf16],
              share_within=f"{share:.6f}", required=tf_share[bf16], frames_outside=int((err > tf_tol[bf16]).sum().item()),
              max_abs_err=f"{err.max().item():.3g}", median_abs_err=f"{err.median().item():.3g}")

    # 17. timing: the frame loop alone by CUDA events over 2000 and 16000 frames (the host's time in the wrapper
    # beside it: on the resident route it includes the one wait for the status word), a whole generation of
    # 2 x 16000 frames with its launch counts (the generation path's main run), the plain loop and the windowed
    # path a frame
    def generate_timed(m, n, fast=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = m.generate(GEN_B, n, fast=fast, generator=torch.Generator(device=dev).manual_seed(SEED))
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        return x, time.perf_counter() - t0, enqueued

    def decoder_timed(m, n):
        keys = variational.FrameKeys(torch.Generator(device=dev).manual_seed(SEED), dev)
        hist = histories["zero"]
        with torch.no_grad():
            tails, pred0 = m._prime(hist, keys)
            decoder = WaveNetDecoder(m, tails)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            decoder.run(hist[:, -1, 0], pred0.reshape(-1), n, keys)
            end.record()
            host = time.perf_counter() - t0
            end.synchronize()
        return start.elapsed_time(end) / (n - 1), host * 1e3 / (n - 1)

    def plain_loop_ms(m, n):
        keys = variational.FrameKeys(torch.Generator(device=dev).manual_seed(SEED), dev)
        hist = histories["zero"]
        with torch.no_grad():
            tails, pred0 = m._prime(hist, keys)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m._generate_fast_plain(hist[:, -1:], pred0, tails, n, keys)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (n - 1)

    gen_ms = {}
    for bf16 in (True, False):
        m = models[bf16]
        generate_timed(m, 64)  # warm-up
        plain_a = plain_loop_ms(m, N_K4)
        loop = {n: [decoder_timed(m, n) for _ in range(2)] for n in (2000, N_GEN)}
        cuda.reset_launch_counts()
        x, seconds, enqueued = generate_timed(m, N_GEN)
        counts = cuda.launch_counts()
        _, seconds_b, _ = generate_timed(m, N_GEN)
        plain_b = plain_loop_ms(m, N_K4)
        expected = dict(residual_glu=50, residual_glu_bwd=0, dmol_log_prob=0, dmol_log_prob_bwd=0, dmol_sample=1,
                        **{route[bf16]: 1 if bf16 else N_GEN - 1})
        expect(counts == {**dict.fromkeys(counts, 0), **expected}, f"generation launches {counts}, expected {expected}")
        expect(bool(torch.isfinite(x).all()) and x.shape == (GEN_B, N_GEN) and x.abs().max().item() <= 1,
               "generation: shape, finite, [-1, 1]")
        cuda.reset_launch_counts()
        _, naive_s, _ = generate_timed(m, N_NAIVE_TIME, fast=False)
        naive_counts = {k: v for k, v in cuda.launch_counts().items() if v}
        naive_expected = dict(wavenet_stack=5 * N_NAIVE_TIME, dmol_sample=N_NAIVE_TIME)
        expect(naive_counts == naive_expected, f"windowed generation launches {naive_counts}, expected {naive_expected}")
        total = min(seconds, seconds_b)
        gen_ms[bf16] = dict(frame_ms=min(ms for ms, _ in loop[N_GEN]), plain_ms=min(plain_a, plain_b), counts=counts)
        phase("time-generate", card=card, dtype=dtype_name[bf16], kernel=route[bf16], sequences=GEN_B,
              loop_us_per_frame={n: [f"{ms * 1e3:.2f}" for ms, _ in v] for n, v in loop.items()},
              loop_host_us_per_frame={n: [f"{h * 1e3:.2f}" for _, h in v] for n, v in loop.items()},
              frames=N_GEN, total_ms=f"{total * 1e3:.1f}", runs_ms=[f"{seconds * 1e3:.1f}", f"{seconds_b * 1e3:.1f}"],
              frames_per_s=f"{N_GEN / total:.1f}", us_per_frame=f"{total * 1e6 / N_GEN:.2f}",
              host_enqueue_us_per_frame=f"{enqueued * 1e6 / N_GEN:.2f}",
              plain_loop_us_per_frame=[f"{plain_a * 1e3:.1f}", f"{plain_b * 1e3:.1f}"],
              naive_ms_per_frame=f"{naive_s * 1e3 / N_NAIVE_TIME:.3f}", launches=counts,
              naive_launches_per_frame={k: v // N_NAIVE_TIME for k, v in naive_counts.items()})

    # the bound of a frame of K4 from what one launch moves (the resident route: every weight once over the
    # generation's N_GEN - 1 frames, and the buffers' slots once; the per-frame route: every weight every frame), at
    # the card's HBM rate, against one multiply-add a weight a sequence at the peak of the stack's type; beside it
    # the yardstick PR 3 set for either route (every weight every frame), for before and after
    record["residual_glu"]["launches"] = gen_ms[True]["counts"]["residual_glu"]  # the prime; STCN's paths add theirs
    for bf16 in (True, False):
        m = models[bf16]
        dilations = [b.dilation for b in m.res_stack.blocks]
        elem, peak = (2, BF16_PEAK) if bf16 else (4, F32_PEAK)
        work = wavenet_frame_work(GEN_B, m.res_channels, dilations, args.num_mix, elem, N_GEN - 1 if bf16 else 1)
        legacy = wavenet_frame_work(GEN_B, m.res_channels, dilations, args.num_mix, elem)
        bound = roofline(**work, peak=peak)
        legacy_ms = legacy["bytes_"] / HBM_BYTES_PER_S * 1e3
        record[route[bf16]].update(ms=gen_ms[bf16]["frame_ms"], plain_ms=gen_ms[bf16]["plain_ms"],
                                   launches=gen_ms[bf16]["counts"][route[bf16]], **bound,
                                   **(dict(legacy_bytes_ms=legacy_ms) if bf16 else {}))
        phase("K4-bound", dtype=dtype_name[bf16], kernel=route[bf16],
              bytes_ms_per_frame=f"{work['bytes_'] / HBM_BYTES_PER_S * 1e3:.7f}",
              operations_ms_per_frame=f"{work['flops'] / peak * 1e3:.7f}",
              card_ms_per_frame=f"{gen_ms[bf16]['frame_ms']:.5f}",
              times_bound=f"{gen_ms[bf16]['frame_ms'] / bound['bound_ms']:.1f}",
              legacy_bytes_ms_per_frame=f"{legacy_ms:.5f}",
              times_legacy=f"{gen_ms[bf16]['frame_ms'] / legacy_ms:.1f}")

    # where a frame's time goes inside K4's resident route: its own trace (SM cycles by phase of each CTA's thread 0
    # over 2000 frames, converted at the rate the io CTA's cycles over the launch's CUDA-event time give): a block's
    # old tap, its wait for h, the h tap and gate, [r | s] and the send; the io CTA's causal tap and in_transform,
    # its wait for the skip sum, the head, the sampler
    m = models[True]
    n_trace, n_blocks = 2000, len(m.res_stack.blocks)
    trace = torch.zeros(8 * -(-(n_blocks + 1) // 8), 4, dtype=torch.int64, device=dev)
    keys = variational.FrameKeys(torch.Generator(device=dev).manual_seed(SEED), dev)
    with torch.no_grad():
        tails, pred0 = m._prime(histories["zero"], keys)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        WaveNetDecoder(m, tails).run(histories["zero"][:, -1, 0], pred0.reshape(-1), n_trace, keys, trace=trace)
        end.record()
        end.synchronize()
    cyc = trace.double()
    ghz = cyc[n_blocks].sum().item() / (start.elapsed_time(end) * 1e6)
    us = cyc / (ghz * 1e3) / (n_trace - 1)
    blocks = us[:n_blocks].mean(0).tolist()
    phase("K4-trace", card=card, frames=n_trace, clock_ghz=f"{ghz:.3f}",
          block_us_per_frame={k: f"{v:.3f}" for k, v in zip(("old_tap", "wait", "h_tap_and_gate", "rs_and_send"), blocks)},
          io_us_per_frame={k: f"{v:.3f}" for k, v in zip(("causal_and_in", "wait", "head", "sampler"),
                                                             us[n_blocks].tolist())},
          compute_on_chain_us_per_frame=f"{sum(blocks[2:]) * n_blocks + sum(us[n_blocks].tolist()) - us[n_blocks, 1].item():.2f}")

    # where a generated frame's time goes: torch.profiler over 600 frames, kernels by name
    from torch.profiler import ProfilerActivity, profile

    n_prof = 600
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s, prof_enqueued = generate_timed(m, n_prof)

    kernels_ = device_kernels(prof)
    busy_us = sum(device_us(e) for e in kernels_)
    decode = [e for e in kernels_ if "wavenet_decode" in e.key]
    phase("profile-generate", card=card, dtype="bf16", frames=n_prof, wall_us_per_frame=f"{prof_s * 1e6 / n_prof:.2f}",
          device_us_per_frame=f"{busy_us / n_prof:.2f}",
          k4_launches=decode[0].count if decode else 0,
          k4_device_us_per_frame=f"{device_us(decode[0]) / (n_prof - 1):.2f}" if decode else "not measured",
          idle_share=f"{1 - busy_us / (prof_s * 1e6):.3f}" if busy_us else "not measured",
          host_us_per_frame=f"{prof_enqueued * 1e6 / n_prof:.2f}")
    for e in sorted(kernels_, key=device_us, reverse=True)[:6]:
        print(f"  {device_us(e) / n_prof:9.3f} us/frame {e.count:6d} calls  {e.key[:90]}", flush=True)

    # 18. the driver's generation hook, on the card: two 16000-sample wav files in the build directory
    out_dir = Path(__file__).resolve().parent / "blvm_tpu_torch" / "_build" / "generation_hook"
    hook = wavenet_audio.make_generation_hook(models[True], argparse_copy(args, generate_every=5))
    skipped = hook(4, out_dir)
    paths = hook(5, out_dir)
    shapes = []
    for path in paths:
        with wave.open(str(path)) as f:
            shapes.append((f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()))
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        expect(shapes[-1] == (1, 2, 16000, 16000) and np.abs(pcm).max() > 0, f"hook wav {path}: {shapes[-1]}")
    expect(skipped == [] and len(paths) == 2, f"hook cadence: epoch 4 wrote {skipped}, epoch 5 {paths}")
    phase("generation-hook", files=[str(p.relative_to(out_dir.parents[2])) for p in paths], wav=shapes)

    require(not failures, f"generation phases failed: {failures}")


def lstm_phases(record, smi, dev):
    """Phases 19-24, the LSTMAudio paths at the width of ``experiments/benchmarks.txt:12``:
    K5 and K5-bwd against their twins, the test pass (whole and with carried state), the
    train step, generation through the driver's hook, and their times. Each check is printed
    before any raises, so one run shows every number."""
    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, lstm_audio
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.ops.sequence import split_sequence
    from blvm_tpu_torch.training.train_state import TrainState
    from blvm_tpu_torch.training.train_step import make_train_step

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    dtype_name = {torch.float32: "f32", torch.bfloat16: "bf16"}

    def k5_inputs(B_, T_, H, lengths=None, state=False):
        """xw at the scale of the benchmark's (a Dense of ReLU features plus a bias), W_hh and
        b_hh from the init's U(-1/sqrt(H), 1/sqrt(H)), the mask of ``lengths``, f32."""
        bound = 1 / math.sqrt(H)
        xw = torch.randn(B_, T_, 4 * H, generator=gen, device=dev) * 0.7
        w_hh = (torch.rand(H, 4 * H, generator=gen, device=dev) * 2 - 1) * bound
        b_hh = (torch.rand(4 * H, generator=gen, device=dev) * 2 - 1) * bound
        lengths = torch.full((B_,), T_, device=dev) if lengths is None else lengths
        mask = (torch.arange(T_, device=dev)[None] < lengths[:, None]).float()
        h0, c0 = ((torch.randn(B_, H, generator=gen, device=dev) * 0.5 if state else torch.zeros(B_, H, device=dev))
                  for _ in range(2))
        return [xw, w_hh, b_hh, mask, h0, c0]

    def cast(a, dtype):
        return [t if i == 3 else t.to(dtype) for i, t in enumerate(a)]

    # 19. K5 against its twin: the s=64 benchmark shape (B=10 utterances of 300-1125 stacks),
    # a small H, a given (h0, c0)
    k5_cases = {
        "H256_B10_ragged": k5_inputs(LSTM_B, LSTM_T, 256, torch.randint(LSTM_T * 4 // 15, LSTM_T + 1, (LSTM_B,), generator=gen,
                                                                        device=dev)),
        "H32_B3": k5_inputs(3, 64, 32),
        "H256_B4_given_state": k5_inputs(4, 200, 256, state=True),
    }

    def twin_step(a, saved, dtype):
        """One twin step in ``dtype`` from the kernel's carried state at every t: the activated
        gates, the output, the next carried (h, c)."""
        xw, w_hh, b_hh, mask, h0, c0 = (t.to(dtype) for t in a)
        h_prev, c_prev = (t.to(dtype) for t in saved[4:])
        i, f, g, o = (xw + h_prev @ w_hh + b_hh).chunk(4, dim=-1)
        act = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], dim=-1)
        c_new = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[..., None].to(dtype)
        return act, h_new * m, m * h_new + (1 - m) * h_prev, m * c_new + (1 - m) * c_prev

    def teacher_forced(a, saved, atol, rtol, dtype=None):
        """The kernel's activated gates, output and next carried state against one twin step
        (in the kernel's dtype) from the kernel's carried state at every t: ``(max abs err,
        worst excess over atol + rtol |twin|)``. With ``dtype=torch.float32`` the values in
        place of the kernel's are that step computed in f32 and rounded once, at the end, to
        the kernel's dtype: what a kernel that kept f32 inside a step would give."""
        out, h_n, c_n, gates, h_prev, c_prev = saved
        kdtype = a[0].dtype
        act, out_t, h_next, c_next = twin_step(a, saved, kdtype)
        if dtype is not None:
            gates, out, h_next_k, c_next_k = (t.to(kdtype) for t in twin_step(a, saved, dtype))
            h_n, c_n = h_next_k[:, -1], c_next_k[:, -1]
            h_prev, c_prev = torch.cat([h_prev[:, :1], h_next_k[:, :-1]], 1), torch.cat([c_prev[:, :1], c_next_k[:, :-1]], 1)
        pairs = [(gates, act), (out, out_t), (h_prev[:, 1:], h_next[:, :-1]), (c_prev[:, 1:], c_next[:, :-1]),
                 (h_n, h_next[:, -1]), (c_n, c_next[:, -1])]
        errs = [(k_.float() - t_.float()).abs() for k_, t_ in pairs]
        return (max(e_.max().item() for e_ in errs),
                max((e_ - atol - rtol * t_.float().abs()).max().item() for e_, (_, t_) in zip(errs, pairs)))

    # f32 (TF32 off): the kernel and the twin differ only in the products' summation order:
    # 1e-5 absolute on O(1) values, free-running over every step. bf16: both round where JAX
    # rounds, so one step from the same state differs only where the dots' order flips a
    # rounding: held teacher-forced (one twin step from the kernel's state) to about two bf16
    # ulps (2^-9 absolute plus 2^-7 relative), and reported free-running. The same step in f32,
    # rounded once at the end, is reported against that tolerance too: it shows whether the
    # check tells a kernel that rounds where XLA rounds from one that does not.
    k5_tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2.0**-9, 2.0**-7)}
    k5_err, k5_bf16 = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, a32 in k5_cases.items():
            a = cast(a32, dtype)
            with torch.no_grad():
                cuda.reset_launch_counts()
                got = recurrent.lstm_recurrence(*a)
                saved = recurrent._forward(*a, save=True)
                torch.cuda.synchronize()
                launches = cuda.launch_counts()["lstm_recurrence"]
                ref = recurrent.lstm_recurrence_plain(*a)
            free = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, ref))
            atol, rtol = k5_tol[dtype]
            with torch.no_grad():
                tf_err, tf_excess = teacher_forced(a, saved, atol, rtol)
            same = all(torch.equal(x, y) for x, y in zip(got, saved[:3]))
            expect(launches == 2 and all(bool(torch.isfinite(t).all()) for t in got), f"K5 {name}: launches/finite")
            expect(same, f"K5 {dtype_name[dtype]} {name}: the saving launch differs from the plain launch")
            expect(tf_excess <= 0, f"K5 {dtype_name[dtype]} {name}: teacher-forced err {tf_err} over tolerance")
            extra = {}
            if dtype == torch.float32:
                expect(free <= atol, f"K5 f32 {name}: free-running err {free} over {atol}")
                if name == "H256_B10_ragged":  # the main path's shape
                    k5_err = free
            else:
                with torch.no_grad():
                    once_err, once_excess = teacher_forced(a, saved, atol, rtol, dtype=torch.float32)
                k5_bf16[name] = tf_err
                extra = dict(f32_rounded_once_max_abs_err=f"{once_err:.3g}", f32_rounded_once_within=once_excess <= 0)
            phase("K5", dtype=dtype_name[dtype], case=name, shape=tuple(a[0].shape), free_max_abs_err=f"{free:.3g}",
                  teacher_forced_max_abs_err=f"{tf_err:.3g}", launches=launches, **extra)
    phase("K5-bf16", teacher_forced_max_abs_err={k: f"{v:.3g}" for k, v in k5_bf16.items()},
          tolerance="2^-9 + 2^-7 |twin|", note="the kernels line's max_abs_err is f32 free-running at the main path's shape")
    record["lstm_recurrence"]["max_abs_err"] = k5_err

    # 20. K5-bwd against autograd of the twin: the gradient of sum(out w) + 0.3 sum(h_n) - 0.7 sum(c_n)
    # by xw, W_hh, b_hh, h0, c0 as relative norms. f32: the sums' order over T steps (1e-5). bf16:
    # the kernel computes the backward in f32 from the bf16 forward, the twin rounds every op;
    # both held to autograd of the f32 twin: the kernel no further than twice the bf16 twin plus 1e-3.
    grad_names = ("dxw", "dW_hh", "db_hh", "dh0", "dc0")

    def k5_grads(fn, a, w_out):
        leaves = [t if i == 3 else t.detach().requires_grad_(True) for i, t in enumerate(a)]
        out, h_n, c_n = fn(*leaves)
        ((out.float() * w_out).sum() + 0.3 * h_n.float().sum() - 0.7 * c_n.float().sum()).backward()
        return [leaves[i].grad for i in (0, 1, 2, 4, 5)]

    k5b_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, a32 in k5_cases.items():
            a = cast(a32, dtype)
            w_out = torch.randn(a[0].shape[:2] + (a[1].shape[0],), generator=gen, device=dev)
            cuda.reset_launch_counts()
            got = k5_grads(recurrent.lstm_recurrence, a, w_out)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            ref = k5_grads(recurrent.lstm_recurrence_plain, a, w_out)
            rels = {n: rel_norm(x, y) for n, x, y in zip(grad_names, got, ref)}
            expect(counts["lstm_recurrence"] == 1 and counts["lstm_recurrence_bwd"] == 1, f"K5-bwd launches {counts}")
            expect(all(bool(torch.isfinite(g_).all()) for g_ in got), f"K5-bwd {name}: not finite")
            if dtype == torch.float32:
                expect(max(rels.values()) <= 1e-5, f"K5-bwd f32 {name}: {rels}")
                k5b_err = max(k5b_err, max((x - y).abs().max().item() for x, y in zip(got, ref)))
                phase("K5-bwd", dtype="f32", case=name, max_rel_vs_twin=f"{max(rels.values()):.3g}",
                      **{n: f"{v:.3g}" for n, v in rels.items()})
            else:
                f32 = k5_grads(recurrent.lstm_recurrence_plain, [t.float() for t in a], w_out)
                e_k = {n: rel_norm(x, y) for n, x, y in zip(grad_names, got, f32)}
                e_p = {n: rel_norm(x, y) for n, x, y in zip(grad_names, ref, f32)}
                expect(all(e_k[n] <= 2 * e_p[n] + 1e-3 for n in grad_names), f"K5-bwd bf16 {name}: {e_k} vs twin {e_p}")
                phase("K5-bwd", dtype="bf16", case=name, kernel_max_rel_vs_f32=f"{max(e_k.values()):.3g}",
                      twin_max_rel_vs_f32=f"{max(e_p.values()):.3g}", kernel_vs_twin=f"{max(rels.values()):.3g}")
    record["lstm_recurrence_bwd"]["max_abs_err"] = k5b_err

    # 21. the test pass: flags of benchmarks.txt:12 -> driver -> model on the card -> weights bridge,
    # over 6 synthetic mu-law utterances, whole and with --split_eval (chunks of 16 stacks, s_n carried)
    args = lstm_audio.build_args(LSTM_FLAGS.split())
    model = lstm_audio.build_model(args)
    require(next(model.parameters()).device.type == "cuda", "lstm_audio.build_model did not build on the card")
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    rng = np.random.default_rng(args.seed + 19)
    lengths = rng.integers(24000, 72001, 6)
    x_np, x_sl_np = common.make_batch([synthetic_speech(int(n), rng) for n in lengths], args)
    n_chunks = len(split_sequence(x_np, x_sl_np, length=16 * args.stack_size, overlap=0)[0])

    def test_pass(split, plain_path_=False):
        with plain() if plain_path_ else contextlib.nullcontext():
            cuda.reset_launch_counts()
            t0 = time.time()
            values = lstm_audio.evaluate(model, argparse_copy(args, split_eval=split), [(x_np, x_sl_np)], Tracker(),
                                         generator=torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            return values, cuda.launch_counts(), time.time() - t0

    for split in (False, True):
        values, counts, seconds = test_pass(split)
        values_p, counts_p, _ = test_pass(split, plain_path_=True)
        forwards = n_chunks if split else 1
        expected = dict(lstm_recurrence=forwards * args.num_layers, dmol_log_prob=forwards, dmol_sample=forwards)
        expect(counts == {**dict.fromkeys(counts, 0), **expected},
               f"test pass split={split}: launches {counts}, expected {expected}")
        expect(not any(counts_p.values()), f"the plain test pass launched kernels: {counts_p}")
        bpd_rel = abs(values["bpd"] - values_p["bpd"]) / abs(values_p["bpd"])
        finite = all(math.isfinite(values[k]) for k in ("loss", "ll", "bpd"))
        # f32 throughout: only the summation orders of K5, K2 and the products differ
        expect(finite and bpd_rel <= 1e-5, f"test pass split={split}: {values} vs twins {values_p}")
        phase("lstm-test-pass", split_eval=split, utterances=list(map(int, lengths)), forwards=forwards,
              loss=f"{values['loss']:.6f}", bpd=f"{values['bpd']:.6f}", bpd_plain=f"{values_p['bpd']:.6f}",
              bpd_rel=f"{bpd_rel:.3g}", launches_per_forward={k: v // forwards for k, v in counts.items() if v},
              seconds=f"{seconds:.2f}")

    # 22. the train slice: 3 Adam steps through the driver's train, each on ~10 utterances
    # (~512k samples, the --batch_len 32 budget), f32 as the benchmark runs it
    targs = argparse_copy(args, epochs=1, lr=3e-4)
    rng = np.random.default_rng(args.seed + 22)
    utterances = [(i, synthetic_speech(int(n), rng)) for i, n in enumerate(rng.integers(40000, 64001, 3 * LSTM_B))]
    train_batches = [utterances[i * LSTM_B : (i + 1) * LSTM_B] for i in range(3)]

    def run_train(plain_path_=False):
        weights.load_jax_params(model, params)
        log = StepLog(Tracker())
        with plain() if plain_path_ else contextlib.nullcontext():
            cuda.reset_launch_counts()
            t0 = time.time()
            common.train(model, targs, train_batches, log)
            torch.cuda.synchronize()
            return log.steps, cuda.launch_counts(), time.time() - t0

    steps_k, counts, seconds = run_train()
    steps_p, counts_p, seconds_p = run_train(plain_path_=True)
    expected = dict(lstm_recurrence=3, lstm_recurrence_bwd=3, dmol_log_prob=3, dmol_log_prob_bwd=3, dmol_sample=3)
    expect(counts == {**dict.fromkeys(counts, 0), **expected},
           f"LSTM train-step launches {counts}, expected {expected} (1/1/1/1/1 a step)")
    expect(not any(counts_p.values()), f"the plain train path launched kernels: {counts_p}")
    for name in ("lstm_recurrence", "lstm_recurrence_bwd"):
        record[name]["launches"] = counts[name]
    losses, losses_p = [st["loss"] for st in steps_k], [st["loss"] for st in steps_p]
    loss_rel = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(losses, losses_p))
    expect(all(math.isfinite(v) for st in steps_k for v in st.values()), f"LSTM train metrics not finite: {steps_k}")
    expect(loss_rel <= 1e-5, f"LSTM train losses {losses} vs plain {losses_p}")
    phase("lstm-train-slice", steps=3, utterances_per_step=LSTM_B,
          samples_per_step=[sum(len(w) for _, w in b_) for b_ in train_batches], losses=[f"{v:.6f}" for v in losses],
          losses_plain=[f"{v:.6f}" for v in losses_p], loss_rel=f"{loss_rel:.3g}",
          launches_per_step={k: v // 3 for k, v in counts.items() if v}, seconds=f"{seconds:.2f}",
          seconds_plain=f"{seconds_p:.2f}")

    x0, sl0 = common.make_batch([w for _, w in train_batches[0]], targs)
    x0, sl0 = torch.from_numpy(x0).to(dev), torch.from_numpy(sl0).to(dev)

    def step0(plain_path_=False):
        weights.load_jax_params(model, params)
        model.zero_grad(set_to_none=True)
        model.train()
        with plain() if plain_path_ else contextlib.nullcontext():
            loss, _, _ = model(x0, sl0, generator=torch.Generator(device=dev).manual_seed(SEED))
            loss.backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}, loss.item()

    g_k, loss_k = step0()
    g_p, loss_p = step0(plain_path_=True)
    e = {n: rel_norm(g_k[n], g_p[n]) for n in g_p}
    # f32: the same math with the sums in another order, through ~1000 steps of BPTT
    expect(all(torch.isfinite(g_).all() for g_ in g_k.values()) and max(e.values()) <= 1e-4,
           f"LSTM step-0 gradients vs twins: {e}")
    phase("lstm-train-grads", loss=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}", max_rel=f"{max(e.values()):.3g}",
          worst=max(e, key=e.get), parameters=len(e))
    del g_k, g_p

    # 23. generation through the driver's hook: 2 x 16000 frames = 2 x 250 stacks, one K5 (T=1)
    # and one K3 launch a stack; then the rollout at the mode against the forward's DMoL mode
    # with the generated prefix fed back (the oracle of tests/models/test_lstm_audio.py:179)
    model.eval()
    out_dir = Path(__file__).resolve().parent / "blvm_tpu_torch" / "_build" / "lstm_generation_hook"
    hook = lstm_audio.make_generation_hook(model, argparse_copy(args, generate_every=5))
    cuda.reset_launch_counts()
    t0 = time.time()
    paths = hook(5, out_dir)
    torch.cuda.synchronize()
    hook_s = time.time() - t0
    counts = cuda.launch_counts()
    n_stacks = args.generate_frames // args.stack_size
    expected = dict(lstm_recurrence=n_stacks * args.num_layers, dmol_sample=n_stacks)
    expect(counts == {**dict.fromkeys(counts, 0), **expected},
           f"generation launches {counts}, expected {expected}")
    shapes = []
    for path in paths:
        with wave.open(str(path)) as f:
            shapes.append((f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()))
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        expect(shapes[-1] == (1, 2, 16000, 16000) and np.abs(pcm).max() > 0, f"LSTM hook wav {path}: {shapes[-1]}")
    expect(len(paths) == 2, f"LSTM hook wrote {paths}")
    phase("lstm-generation-hook", stacks=n_stacks, launches=counts, seconds=f"{hook_s:.2f}",
          files=[str(p.relative_to(out_dir.parents[2])) for p in paths], wav=shapes)

    S = args.stack_size
    (mode_gen, _), _ = model.generate(n_samples=GEN_B, max_timesteps=n_stacks, use_mode=True)
    seq = torch.cat([torch.zeros(GEN_B, S, device=dev), mode_gen, torch.zeros(GEN_B, S, device=dev)], dim=1)
    with torch.no_grad():
        _, _, out = model(seq, torch.full((GEN_B,), seq.shape[1], dtype=torch.int32, device=dev))
    err = (out.reconstruction_mode[:, : n_stacks * S, 0] - mode_gen).abs()
    share = (err <= 1e-5).double().mean().item()
    # f32: K5 with T=1 a stack against K5 over the whole sequence (the same sums); a frame whose
    # argmax sits within f32 rounding of a tie may pick another component: at most 1e-3 of them
    expect(bool(torch.isfinite(mode_gen).all()) and share >= 1 - 1e-3, f"LSTM mode rollout: share {share}")
    phase("lstm-generate-mode-oracle", frames=GEN_B * n_stacks * S, share_within_1e5=f"{share:.6f}",
          max_abs_err=f"{err.max().item():.3g}", frames_outside=int((err > 1e-5).sum().item()))

    # 24. times: K5 and K5-bwd against their twins and the yardstick torch.nn.LSTM (cuDNN, on
    # pack_padded_sequence, the same weights in PyTorch's layout; the port never calls it)
    H = args.hidden_size
    lengths_k5 = torch.randint(LSTM_T * 4 // 15, LSTM_T + 1, (LSTM_B,), generator=gen, device=dev)
    layer_inputs = [torch.relu(torch.randn(LSTM_B, LSTM_T, H, generator=gen, device=dev)) for _ in range(3)]
    lstm_mod = model.lstm
    w_ih, b_ih, w_hh, b_hh = (getattr(lstm_mod, f"{n}_0").detach() for n in ("w_ih", "b_ih", "w_hh", "b_hh"))
    mask = (torch.arange(LSTM_T, device=dev)[None] < lengths_k5[:, None]).float()
    zeros = torch.zeros(LSTM_B, H, device=dev)
    xws = [e_ @ w_ih + b_ih for e_ in layer_inputs]
    cudnn = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_ih.T)
        cudnn.weight_hh_l0.copy_(w_hh.T)
        cudnn.bias_ih_l0.copy_(b_ih)
        cudnn.bias_hh_l0.copy_(b_hh)
    packed = [torch.nn.utils.rnn.pack_padded_sequence(e_, lengths_k5.cpu(), batch_first=True, enforce_sorted=False)
              for e_ in layer_inputs]
    with torch.no_grad():
        ref_out, _ = torch.nn.utils.rnn.pad_packed_sequence(cudnn(packed[0])[0], batch_first=True,
                                                            total_length=LSTM_T)
        ours = recurrent.lstm_recurrence(xws[0], w_hh, b_hh, mask, zeros, zeros)[0]
    cudnn_err = (ref_out - ours).abs().max().item()
    expect(cudnn_err <= 1e-4, f"the yardstick torch.nn.LSTM computes another function: max err {cudnn_err}")

    def k5_fwd(xw):
        with torch.no_grad():
            recurrent.lstm_recurrence(xw, w_hh, b_hh, mask, zeros, zeros)

    def k5_plain(xw):
        with torch.no_grad():
            recurrent.lstm_recurrence_plain(xw, w_hh, b_hh, mask, zeros, zeros)

    def library(pk):
        with torch.no_grad():
            cudnn(pk)

    k5 = alternate(k5_plain, k5_fwd, xws)
    k5_lib = alternate(lambda p_: library(p_[0]), lambda p_: k5_fwd(p_[1]), list(zip(packed, xws)))
    layer_ms = sorted(cuda_time_ms(lambda e_: k5_fwd(e_ @ w_ih + b_ih), layer_inputs))[1]
    steps = int(lengths_k5.sum().item())
    G = 4 * H
    record["lstm_recurrence"].update(ms=k5["kernel"], plain_ms=k5["plain"], library_ms=k5_lib["plain"], **roofline(
        bytes_=4 * (LSTM_B * LSTM_T * (G + 1 + H) + H * G + G + 4 * LSTM_B * H), flops=2 * steps * H * G,
        peak=F32_PEAK))
    phase("time-K5", card=card, shape=f"({LSTM_B},{LSTM_T},{G})", H=H, dtype="f32", stacks=steps,
          kernel_ms=f"{k5['kernel']:.4f}", kernel_ms_turn2=f"{k5_lib['kernel']:.4f}", plain_ms=f"{k5['plain']:.4f}",
          cudnn_lstm_ms=f"{k5_lib['plain']:.4f}", layer_ms=f"{layer_ms:.4f}",
          us_per_step=f"{k5['kernel'] * 1e3 / LSTM_T:.3f}", cudnn_max_abs_err=f"{cudnn_err:.3g}")

    # the s=1 shape (benchmarks.txt:11): T' = 16000 steps, the chain's latency per step
    xw_s1 = [torch.randn(LSTM_B, 16000, G, generator=gen, device=dev) * 0.7]
    mask_s1 = torch.ones(LSTM_B, 16000, device=dev)
    pk_s1 = [torch.nn.utils.rnn.pack_padded_sequence(torch.relu(torch.randn(LSTM_B, 16000, H, generator=gen,
                                                                            device=dev)),
                                                     torch.full((LSTM_B,), 16000), batch_first=True)]
    s1 = sorted(cuda_time_ms(lambda xw: recurrent.lstm_recurrence(xw, w_hh, b_hh, mask_s1, zeros, zeros), xw_s1 * 3))
    s1_lib = sorted(cuda_time_ms(library, pk_s1 * 3))
    phase("time-K5-s1", card=card, shape=f"({LSTM_B},16000,{G})", kernel_ms=f"{s1[1]:.3f}",
          us_per_step=f"{s1[1] * 1e3 / 16000:.3f}", cudnn_lstm_ms=f"{s1_lib[1]:.3f}",
          cudnn_us_per_step=f"{s1_lib[1] * 1e3 / 16000:.3f}")
    del xw_s1, pk_s1

    def bwd_graph(fn, xw, wh, bh):
        leaves = [xw.detach().requires_grad_(True), wh.detach().requires_grad_(True), bh.detach().requires_grad_(True)]
        out_, h_n, c_n = fn(leaves[0], leaves[1], leaves[2], mask, zeros, zeros)
        return (out_, h_n, c_n), leaves, (torch.randn_like(out_), torch.zeros_like(h_n), torch.zeros_like(c_n))

    def lib_graph(e_):
        leaves = [e_.detach().requires_grad_(True)] + list(cudnn.parameters())
        pk = torch.nn.utils.rnn.pack_padded_sequence(leaves[0], lengths_k5.cpu(), batch_first=True,
                                                     enforce_sorted=False)
        out_ = cudnn(pk)[0].data
        return (out_,), leaves, (torch.randn_like(out_),)

    def backward_only(graph):
        outputs, inputs, grad_outputs = graph
        return torch.autograd.grad(outputs, inputs, grad_outputs, retain_graph=True)

    graphs = [(bwd_graph(recurrent.lstm_recurrence_plain, xw, w_hh, b_hh), bwd_graph(recurrent.lstm_recurrence, xw,
                                                                                    w_hh, b_hh)) for xw in xws]
    k5b = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), graphs)
    lib_graphs = [(lib_graph(e_), g_[1]) for e_, g_ in zip(layer_inputs, graphs)]
    k5b_lib = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), lib_graphs)

    def layer_graph(e_):
        """Our layer as cuDNN's autograd sees it: the input projection and K5, differentiated by
        the input and all four parameters."""
        leaves = [t.detach().requires_grad_(True) for t in (e_, w_ih, b_ih, w_hh, b_hh)]
        out_ = recurrent.lstm_recurrence(leaves[0] @ leaves[1] + leaves[2], leaves[3], leaves[4], mask, zeros, zeros)[0]
        return (out_,), leaves, (torch.randn_like(out_),)

    layer_graphs = [layer_graph(e_) for e_ in layer_inputs]
    layer_bwd_ms = sorted(cuda_time_ms(backward_only, layer_graphs))[1]
    # operations at the data's steps: the chain (dgates @ W_hh^T) and dW_hh = h_prev^T dgates over
    # the rows the lengths cover (the padded rows' dgates are zero)
    record["lstm_recurrence_bwd"].update(ms=k5b["kernel"], plain_ms=k5b["plain"], library_ms=k5b_lib["plain"],
                                         **roofline(bytes_=4 * (LSTM_B * LSTM_T * (3 * H + G + 1 + G + H)
                                                                + 2 * H * G + G + 2 * LSTM_B * H),
                                                    flops=2 * steps * H * G + 2 * steps * H * G, peak=F32_PEAK))
    phase("time-K5-bwd", card=card, shape=f"({LSTM_B},{LSTM_T},{G})", dtype="f32", kernel_ms=f"{k5b['kernel']:.4f}",
          kernel_ms_turn2=f"{k5b_lib['kernel']:.4f}", plain_ms=f"{k5b['plain']:.4f}",
          cudnn_lstm_bwd_ms=f"{k5b_lib['plain']:.4f}", layer_bwd_ms=f"{layer_bwd_ms:.4f}",
          includes="kernel: K5-bwd + the dW_hh and db_hh GEMMs; cuDNN and layer: also dx, dW_ih, db_ih")
    del graphs, lib_graphs, layer_graphs

    # the train step, kernels against twins in turns, on the batches of phase 22
    tx, _ = common.build_tx_and_lr(targs)
    weights.load_jax_params(model, params)
    model.train()
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(common.loss_fn)
    step_batches = []
    for b_ in train_batches:
        xb_, slb_ = common.make_batch([w for _, w in b_], targs)
        step_batches.append(dict(x=torch.from_numpy(xb_).to(dev), x_sl=torch.from_numpy(slb_).to(dev)))

    def run_step(b_):
        train_step(state, b_, {})

    def run_step_plain(b_):
        with plain():
            train_step(state, b_, {})

    ts = alternate(run_step_plain, run_step, step_batches)
    samples = sum(int(b_["x_sl"].sum()) for b_ in step_batches) / len(step_batches)
    phase("time-lstm-train-step", card=card, utterances=LSTM_B, samples=int(samples), kernel_ms=f"{ts['kernel']:.3f}",
          plain_ms=f"{ts['plain']:.3f}", samples_per_s=f"{samples / ts['kernel'] * 1e3:.0f}")

    # the test pass (one whole-batch forward of phase 21's utterances) and a generation
    model.eval()
    eval_s = []
    for _ in range(3):
        _, _, s_ = test_pass(False)
        eval_s.append(s_)
    gen_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(n_samples=GEN_B, max_timesteps=n_stacks, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    scored = int(x_sl_np.sum())
    phase("time-lstm-test-pass-and-generate", card=card, test_pass_samples=scored,
          test_pass_s=[f"{v:.4f}" for v in eval_s], test_samples_per_s=f"{scored / min(eval_s):.0f}",
          generate_stacks=n_stacks, generate_s=[f"{v:.4f}" for v in gen_s],
          generate_frames_per_s=f"{GEN_B * n_stacks * S / min(gen_s):.0f}")

    # where the train step's device time goes: torch.profiler over the 3 steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b_ in step_batches:
            run_step(b_)
        torch.cuda.synchronize()

    kernels_ = device_kernels(prof)
    busy_ms = sum(device_us(e_) for e_ in kernels_) / 1e3 / 3
    phase("profile-lstm-train-step", card=card, device_ms_per_step=f"{busy_ms:.3f}", step_ms=f"{ts['kernel']:.3f}",
          idle_share=f"{1 - busy_ms / ts['kernel']:.3f}" if busy_ms else "not measured",
          kernel_launches_per_step=sum(e_.count for e_ in kernels_) // 3)
    for e_ in sorted(kernels_, key=device_us, reverse=True)[:10]:
        print(f"  {device_us(e_) / 1e3 / 3:9.3f} ms/step {e_.count // 3:5d} calls/step  {e_.key[:90]}", flush=True)

    require(not failures, f"LSTM phases failed: {failures}")


def vrnn_phases(record, smi, dev):
    """Phases 25-29, the VRNN paths at the width of ``experiments/benchmarks.txt:17``: K8
    against its twin (inference and prior mode), the test pass (whole and with carried
    state), generation through the driver's hook, and their times. Each check is printed
    before any raises, so one run shows every number."""
    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, vrnn_audio
    from blvm_tpu_torch.models import vrnn as vrnn_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.ops import vrnn as vrnn_ops
    from blvm_tpu_torch.ops.padding import get_modulo_length
    from blvm_tpu_torch.ops.sequence import split_sequence

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    args = vrnn_audio.build_args(VRNN_FLAGS.split())
    model = vrnn_audio.build_model(args)
    require(next(model.parameters()).device.type == "cuda", "vrnn_audio.build_model did not build on the card")
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    model.eval()
    cell = model.vrnn.cell
    S, Z, R = args.stack_frames, args.latent_size, cell.r_dim
    rng = np.random.default_rng(args.seed + 25)
    lengths = rng.integers(VRNN_T * S // 3, VRNN_T * S + 1, VRNN_B)  # 24k-72k samples
    lengths[0] = VRNN_T * S  # the longest utterance fills all 1125 stacks
    x_np, x_sl_np = common.make_batch([synthetic_speech(int(n), rng) for n in lengths], args)
    x_dev, x_sl_dev = torch.from_numpy(x_np).to(dev), torch.from_numpy(x_sl_np).to(dev)
    with torch.no_grad():
        enc = model.vrnn.encoder(x_dev[..., None])  # (6, 1125, 256): K8's input on the test pass
    cell_kw = dict(residual_posterior=cell.residual_posterior, condition_h_on_x=cell.condition_h_on_x,
                   sd_beta=cell.prior_head.beta, sd_epsilon=cell.prior_head.epsilon)

    def teacher_forced(w, x, h0, eps, got, **kw):
        """One twin step at every t from the kernel's state entering it (all B T' rows at once)."""
        B_, T_ = x.shape[:2]
        h_prev = torch.cat([h0[:, None], got.h[:, :-1]], dim=1).reshape(B_ * T_, -1)
        one = vrnn_ops.vrnn_cell_plain(w, x.reshape(B_ * T_, 1, -1), h_prev,
                                       None if eps is None else eps.reshape(B_ * T_, 1, -1), **kw)
        return [None if t is None else t.reshape(B_, T_, -1) for t in one]

    def errors(got, ref):
        return {name: (a - b).abs().max().item() for name, a, b in zip(got._fields, got, ref) if b is not None}

    def within(got, ref, atol, rtol):
        return all(bool(((a - b).abs() <= atol + rtol * b.abs()).all()) for a, b in zip(got, ref) if b is not None)

    # 25. K8 against its twin at the test pass's shape and at H = 32 with a given h0. Teacher-forced
    # (one twin step from the kernel's state at every t): the products' summation order only, 1e-5
    # absolute plus 1e-5 relative. Free-running over every step: those differences re-enter the chain
    # each step; the chain does not amplify them (the f32 twin against the f64 twin on the CPU at this
    # width stayed within 1e-6 over 1125 steps), so 1e-4 absolute plus 1e-5 relative.
    small = vrnn_model.VRNNCell(32, 32, 8, 64, residual_posterior=False, device=dev)
    weights.load_jax_params(small, weights.random_jax_params(small, SEED + 25))
    k8_cases = {
        "spec_B6_T1125": (cell.cell_weights(), enc, torch.zeros(VRNN_B, R, device=dev),
                          torch.randn(VRNN_B, VRNN_T, Z, generator=gen, device=dev), cell_kw),
        "H32_given_h0": (small.cell_weights(), torch.randn(3, 40, 32, generator=gen, device=dev) * 0.5,
                         torch.randn(3, 64, generator=gen, device=dev) * 0.3,
                         torch.randn(3, 40, 8, generator=gen, device=dev),
                         dict(cell_kw, residual_posterior=False)),
    }
    k8_err = 0.0
    for name, (w, x, h0, eps, kw) in k8_cases.items():
        w = [t.detach() for t in w]
        with torch.no_grad():
            cuda.reset_launch_counts()
            got = vrnn_ops.vrnn_cell(w, x, h0, eps, inference=True, **kw)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["vrnn_cell"]
            free = vrnn_ops.vrnn_cell_plain(w, x, h0, eps, inference=True, **kw)
            forced = teacher_forced(w, x, h0, eps, got, inference=True, **kw)
        e_free, e_forced = errors(got, free), errors(got, forced)
        expect(launches == 1 and all(bool(torch.isfinite(t).all()) for t in got), f"K8 {name}: launches/finite")
        expect(within(got, forced, 1e-5, 1e-5), f"K8 {name}: teacher-forced {e_forced}")
        expect(within(got, free, 1e-4, 1e-5), f"K8 {name}: free-running {e_free}")
        if name == "spec_B6_T1125":
            k8_err = max(e_free.values())
        phase("K8", mode="inference", case=name, shape=tuple(x.shape), launches=launches,
              free_max_abs_err=f"{max(e_free.values()):.3g}", teacher_forced_max_abs_err=f"{max(e_forced.values()):.3g}",
              worst=max(e_free, key=e_free.get))
    record["vrnn_cell"]["max_abs_err"] = k8_err

    # 26. prior mode (generation): T' = 1 a launch, with noise and at the mode, and T' = 64 steps
    # with the inputs given; the twin at 1e-5 absolute plus 1e-5 relative
    w = [t.detach() for t in cell.cell_weights()]
    for name, (x, use_mode) in {"T1_sampled": (enc[:2, :1], False), "T1_mode": (enc[:2, :1], True),
                                "T64_sampled": (enc[:2, :64], False)}.items():
        h0 = torch.randn(2, R, generator=gen, device=dev) * 0.1
        eps = torch.randn(2, x.shape[1], Z, generator=gen, device=dev)
        with torch.no_grad():
            cuda.reset_launch_counts()
            got = vrnn_ops.vrnn_cell(w, x, h0, eps, inference=False, use_mode=use_mode, **cell_kw)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["vrnn_cell"]
            ref = vrnn_ops.vrnn_cell_plain(w, x, h0, eps, inference=False, use_mode=use_mode, **cell_kw)
        e_ = errors(got, ref)
        expect(launches == 1 and got.enc_mu is None and within(got, ref, 1e-5, 1e-5), f"K8 prior {name}: {e_}")
        phase("K8", mode="prior", case=name, shape=tuple(x.shape), use_mode=use_mode, max_abs_err=f"{max(e_.values()):.3g}")

    # a VRNN forward on the card that needs a gradient runs K8 in save mode, its backward K8-bwd, once each
    cuda.reset_launch_counts()
    model(x_dev[:1, :640], x_sl_dev[:1].clamp_max(640))[0].backward()
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    model.zero_grad(set_to_none=True)
    expect((counts["vrnn_cell"], counts["vrnn_cell_bwd"]) == (1, 1), f"VRNN forward and backward launches {counts}")
    phase("K8-backward-launches", vrnn_cell=counts["vrnn_cell"], vrnn_cell_bwd=counts["vrnn_cell_bwd"])

    # 27. the test pass: flags of benchmarks.txt:17 -> driver -> model on the card -> weights bridge,
    # whole and with --split_eval (h_n carried), kernels against the twins with the same noise (the
    # latent noise drawn from one generator seeded alike for both runs)
    chunk = get_modulo_length(args.random_segment_size or 16 * S, S)
    n_chunks = len(split_sequence(x_np, x_sl_np, length=chunk, overlap=0)[0])

    def seeded_noise():
        g_ = torch.Generator(device=dev).manual_seed(SEED + 27)
        return mock.patch.object(vrnn_model, "gaussian_noise",
                                 lambda _, shape, like: torch.randn(shape, generator=g_, dtype=like.dtype,
                                                                    device=like.device))

    def test_pass(split, plain_path_=False):
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise():
            cuda.reset_launch_counts()
            t0 = time.time()
            values = vrnn_audio.evaluate(model, argparse_copy(args, split_eval=split), [(x_np, x_sl_np)], Tracker(),
                                         generator=torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            return values, cuda.launch_counts(), time.time() - t0

    path_launches = 0
    for split in (False, True):
        values, counts, seconds = test_pass(split)
        values_p, counts_p, seconds_p = test_pass(split, plain_path_=True)
        forwards = n_chunks if split else 1
        expected = dict(vrnn_cell=forwards, dmol_log_prob=forwards, dmol_sample=forwards)
        expect(counts == {**dict.fromkeys(counts, 0), **expected},
               f"VRNN test pass split={split}: launches {counts}, expected {expected}")
        expect(not any(counts_p.values()), f"the plain VRNN test pass launched kernels: {counts_p}")
        path_launches += counts["vrnn_cell"]
        bpd_rel = abs(values["bpd"] - values_p["bpd"]) / abs(values_p["bpd"])
        finite = all(math.isfinite(values[k]) for k in ("loss", "elbo", "rec", "kl", "bpd"))
        # f32 throughout: only the summation orders of K8, K2 and the products differ
        expect(finite and bpd_rel <= 1e-5, f"VRNN test pass split={split}: {values} vs twins {values_p}")
        phase("vrnn-test-pass", split_eval=split, utterances=list(map(int, lengths)), forwards=forwards,
              loss=f"{values['loss']:.6f}", bpd=f"{values['bpd']:.6f}", bpd_plain=f"{values_p['bpd']:.6f}",
              bpd_rel=f"{bpd_rel:.3g}", kl=f"{values['kl']:.3f}", rec=f"{values['rec']:.3f}",
              launches_per_forward={k: v // forwards for k, v in counts.items() if v}, seconds=f"{seconds:.2f}",
              plain_seconds=f"{seconds_p:.2f}")

    # 28. generation through the driver's hook: 2 x 2000 stacks of 64 (--generate_frames 128000), one
    # K8 (prior mode, T' = 1) and one K3 launch a stack; then the rollout from given noise and uniforms
    # against the twins fed the same noise and the kernel's frames (every stack at once)
    out_dir = Path(__file__).resolve().parent / "blvm_tpu_torch" / "_build" / "vrnn_generation_hook"
    hook = vrnn_audio.make_generation_hook(model, argparse_copy(args, generate_every=5))
    cuda.reset_launch_counts()
    t0 = time.time()
    paths = hook(5, out_dir)
    torch.cuda.synchronize()
    hook_s = time.time() - t0
    counts = cuda.launch_counts()
    n_stacks = args.generate_frames // S
    expected = dict(vrnn_cell=n_stacks, dmol_sample=n_stacks)
    expect(counts == {**dict.fromkeys(counts, 0), **expected}, f"VRNN generation launches {counts}, expected {expected}")
    path_launches += counts["vrnn_cell"]
    shapes = []
    for path in paths:
        with wave.open(str(path)) as f:
            shapes.append((f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()))
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        expect(shapes[-1] == (1, 2, 16000, n_stacks * S) and np.abs(pcm).max() > 0, f"VRNN hook wav {path}: {shapes[-1]}")
    expect(len(paths) == 2, f"VRNN hook wrote {paths}")
    phase("vrnn-generation-hook", stacks=n_stacks, launches=counts, seconds=f"{hook_s:.2f}",
          files=[str(p_.relative_to(out_dir.parents[2])) for p_ in paths], wav=shapes)
    record["vrnn_cell"]["launches"] = path_launches

    eps_g = torch.randn(n_stacks, GEN_B, Z, generator=gen, device=dev)
    u_g = (torch.rand(n_stacks * S, GEN_B, 10, generator=gen, device=dev),
           torch.rand(n_stacks * S, GEN_B, 1, generator=gen, device=dev))
    (frames, _), _ = model.generate(n_samples=GEN_B, max_timesteps=n_stacks, eps=eps_g, uniforms=u_g)
    with torch.no_grad():
        stacks_in = torch.cat([torch.zeros(GEN_B, S, device=dev), frames[:, :-S, 0]], dim=1)  # each step's input stack
        enc_g = model.vrnn.encoder(stacks_in[..., None])
        outs = vrnn_ops.vrnn_cell_plain(w, enc_g, torch.zeros(GEN_B, R, device=dev), eps_g.transpose(0, 1),
                                        inference=False, **cell_kw)
        dec_params = model.vrnn.likelihood(model.vrnn.decoder(torch.cat([outs.phi_z, outs.h], dim=-1)))
        twin_frames = variational.rsample_discretized_logistic_mixture(
            None, *dec_params, uniforms=tuple(u.transpose(0, 1) for u in u_g))
    err = (twin_frames - frames).abs()
    share = (err <= 1e-5).double().mean().item()
    # f32: the twins fed the kernel's frames and the same noise; a frame whose Gumbel pick sits within
    # f32 rounding of a tie may pick another component: at most 1e-3 of them
    expect(bool(torch.isfinite(frames).all()) and share >= 1 - 1e-3, f"VRNN rollout vs twins: share {share}")
    phase("vrnn-generate-vs-twins", frames=GEN_B * n_stacks * S, share_within_1e5=f"{share:.6f}",
          max_abs_err=f"{err.max().item():.3g}", frames_outside=int((err > 1e-5).sum().item()))
    del twin_frames, dec_params, outs, u_g

    # 29. times: K8 against its twin at the test pass's shape (a launch, a step) and at T' = 1 (a
    # generation's launch, also split into host and device time); the test pass; a generation;
    # torch.profiler breakdowns
    from torch.profiler import ProfilerActivity, profile

    eps_t = [torch.randn(VRNN_B, VRNN_T, Z, generator=gen, device=dev) for _ in range(3)]

    def k8(eps_):
        with torch.no_grad():
            vrnn_ops.vrnn_cell(w, enc, torch.zeros(VRNN_B, R, device=dev), eps_, inference=True, **cell_kw)

    def k8_plain(eps_):
        with torch.no_grad():
            vrnn_ops.vrnn_cell_plain(w, enc, torch.zeros(VRNN_B, R, device=dev), eps_, inference=True, **cell_kw)

    t8 = alternate(k8_plain, k8, eps_t, warmup=1)
    H_ = args.hidden_size
    X_ = enc.shape[-1]
    macs = (R * H_ + 2 * H_ * H_ + H_ * 2 * Z) + ((R + X_) * H_ + 2 * H_ * H_ + H_ * 2 * Z) + (Z * H_ + 3 * H_ * H_) \
        + (X_ + H_) * 3 * R + R * 3 * R  # a row-step, the hoisted products included
    n_weights = sum(t.numel() for t in w)
    rows = VRNN_B * VRNN_T
    record["vrnn_cell"].update(ms=t8["kernel"], plain_ms=t8["plain"], **roofline(
        bytes_=4 * (n_weights + rows * (X_ + Z) + VRNN_B * R + rows * (R + H_ + 5 * Z)), flops=2 * rows * macs,
        peak=F32_PEAK))
    x1 = enc[:GEN_B, :1]
    eps1 = [torch.randn(GEN_B, 1, Z, generator=gen, device=dev) for _ in range(20)]

    def k8_step(eps_):
        with torch.no_grad():
            vrnn_ops.vrnn_cell(w, x1, torch.zeros(GEN_B, R, device=dev), eps_, inference=False, **cell_kw)

    def k8_step_plain(eps_):
        with torch.no_grad():
            vrnn_ops.vrnn_cell_plain(w, x1, torch.zeros(GEN_B, R, device=dev), eps_, inference=False, **cell_kw)

    t1 = alternate(k8_step_plain, k8_step, eps1)

    def t1_split(fn):
        """A T' = 1 call's host time (the calls enqueued back to back, no wait between them: the
        card runs behind the host) and the device time of all its kernels, and of K8's alone."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e_ in eps1:
            fn(e_)
        host = (time.perf_counter() - t0) * 1e6 / len(eps1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for e_ in eps1:
                fn(e_)
            torch.cuda.synchronize()
        kernels_ = device_kernels(prof)
        k8_us = sum(device_us(e_) for e_ in kernels_ if "vrnn_cell_kernel" in e_.key)
        return host, sum(device_us(e_) for e_ in kernels_) / len(eps1), k8_us / len(eps1)

    split_k, split_p = t1_split(k8_step), t1_split(k8_step_plain)
    phase("time-K8", card=card, shape=f"({VRNN_B},{VRNN_T})", R=R, H=H_, Z=Z, dtype="f32",
          kernel_ms=f"{t8['kernel']:.4f}", plain_ms=f"{t8['plain']:.4f}", us_per_step=f"{t8['kernel'] * 1e3 / VRNN_T:.3f}",
          bound_ms=f"{record['vrnn_cell']['bound_ms']:.4f}", bound_by=record["vrnn_cell"]["bound_by"],
          prior_T1_us_per_launch=f"{t1['kernel'] * 1e3:.2f}", prior_T1_plain_us=f"{t1['plain'] * 1e3:.2f}",
          T1_host_us=f"{split_k[0]:.2f}", T1_device_us=f"{split_k[1]:.2f}", T1_K8_device_us=f"{split_k[2]:.2f}",
          T1_plain_host_us=f"{split_p[0]:.2f}", T1_plain_device_us=f"{split_p[1]:.2f}")

    # where a step's time goes inside K8: the kernel's own trace (SM cycles of each stage's phases as its
    # first CTA sees them, converted at the loop's clock rate), over 3 launches at the spec shape and 20 at T' = 1
    stage_names = ("L1+gh", "L2", "L3", "heads+z", "phi1", "phi2", "phi3", "phi4", "gru")
    for label, (x_, h_, eps_list, kw) in {
            "K8-trace": (enc, torch.zeros(VRNN_B, R, device=dev), eps_t, dict(inference=True)),
            "K8-trace-T1": (x1, torch.zeros(GEN_B, R, device=dev), eps1, dict(inference=False))}.items():
        trace = torch.zeros(vrnn_ops.trace_size(), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for e_ in eps_list:
                vrnn_ops.vrnn_cell(w, x_, h_, e_, trace=trace, **kw, **cell_kw)
        torch.cuda.synchronize()
        per_step = vrnn_ops.read_trace(trace) / (len(eps_list) * x_.shape[1]) / 1e3  # us a step
        phase(label, card=card, steps=len(eps_list) * x_.shape[1], us_per_step=f"{per_step.sum().item():.3f}",
              inputs_us=f"{per_step[:, 0].sum().item():.3f}", products_us=f"{per_step[:, 1].sum().item():.3f}",
              finish_us=f"{per_step[:, 2].sum().item():.3f}", barrier_us=f"{per_step[:, 3].sum().item():.3f}",
              by_stage={n_: f"{v_:.2f}" for n_, v_ in zip(stage_names, per_step.sum(1).tolist())})

    test_s = {False: [], True: []}
    for split in (False, True):
        for _ in range(3 if not split else 2):
            test_s[split].append(test_pass(split)[2])
    gen_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(n_samples=GEN_B, max_timesteps=n_stacks, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    scored = int(x_sl_np.sum())
    phase("time-vrnn-test-pass-and-generate", card=card, test_pass_samples=scored,
          test_pass_s=[f"{v:.4f}" for v in test_s[False]], split_eval_s=[f"{v:.4f}" for v in test_s[True]],
          test_samples_per_s=f"{scored / min(test_s[False]):.0f}", generate_stacks=n_stacks,
          generate_s=[f"{v:.4f}" for v in gen_s], ms_per_stack=f"{min(gen_s) * 1e3 / n_stacks:.3f}",
          generate_frames_per_s=f"{GEN_B * n_stacks * S / min(gen_s):.0f}")

    # where the time goes: torch.profiler over one whole-batch test pass and over 200 generated stacks
    profiled(lambda: test_pass(False), "profile-vrnn-test-pass", 1, "pass", card)
    profiled(lambda: model.generate(n_samples=GEN_B, max_timesteps=200,
                                    generator=torch.Generator(device=dev).manual_seed(SEED)),
             "profile-vrnn-generate", 200, "stack", card)

    require(not failures, f"VRNN phases failed: {failures}")

def vrnn_train_phases(record, smi, dev):
    """Phases 30-32, the VRNN train step at the width of ``experiments/benchmarks.txt:17``:
    K8-bwd against the float64 twin, three steps of the driver's ``train`` with its annealers,
    and their times. Each check is printed before any raises, so one run shows every number."""
    import copy

    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, vrnn_audio
    from blvm_tpu_torch.models import vrnn as vrnn_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.ops import vrnn as vrnn_ops
    from blvm_tpu_torch.training.train_state import TrainState
    from blvm_tpu_torch.training.train_step import make_train_step

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    args = vrnn_audio.build_args(VRNN_FLAGS.split())
    targs = argparse_copy(args, epochs=1, lr=3e-4)
    model = vrnn_audio.build_model(args)
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    cell = model.vrnn.cell
    S, Z, R, H = args.stack_frames, args.latent_size, cell.r_dim, args.hidden_size
    beta_sd, eps_sd = cell.prior_head.beta, cell.prior_head.epsilon

    # the train batches: 19 utterances of 40k-64k samples a step, each step's lengths drawn again until
    # they fit the --batch_len 64 budget, as the length sampler packs a sum of lengths
    rng = np.random.default_rng(args.seed + 31)
    train_batches = []
    for _ in range(3):
        lengths = rng.integers(VRNN_TRAIN_LENGTHS[0], VRNN_TRAIN_LENGTHS[1] + 1, VRNN_TRAIN_B)
        while lengths.sum() > VRNN_BUDGET:
            lengths = rng.integers(VRNN_TRAIN_LENGTHS[0], VRNN_TRAIN_LENGTHS[1] + 1, VRNN_TRAIN_B)
        train_batches.append([(len(train_batches) * VRNN_TRAIN_B + i, synthetic_speech(int(n), rng))
                              for i, n in enumerate(lengths)])
    step_batches = []
    for b_ in train_batches:
        xb_, slb_ = common.make_batch([w for _, w in b_], targs)
        step_batches.append(dict(x=torch.from_numpy(xb_).to(dev), x_sl=torch.from_numpy(slb_).to(dev)))
    x0, sl0 = step_batches[0]["x"], step_batches[0]["x_sl"]
    with torch.no_grad():
        enc0 = model.vrnn.encoder(x0[..., None])  # (19, T', 256): K8's input in the first train step
    T0 = enc0.shape[1]
    stacks0 = torch.ceil(sl0 / S).long()

    def seeded_noise(seed):
        """The latent noise from a generator of its own, drawn in float32 and cast, so every path
        (kernels, f32 twins, f64 twins) and every run sees the same noise."""
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return mock.patch.object(vrnn_model, "gaussian_noise", lambda _, shape, like: torch.randn(
            shape, generator=g_, device=like.device).to(like.dtype))

    def chain_grads(kw, xpost, xg, h0, eps, g_out, dtype, kernel, residual):
        """At K8-bwd's boundary: the gradients of sum(outputs * g_out) by xpost, xg, h0 and the 28
        kernel weights, through VRNNCellFunction (kernel) or autograd of the plain chain."""
        leaves = [None if t is None else t.detach().to(dtype).clone().requires_grad_(True)
                  for t in (xpost, xg, h0, *kw)]
        if kernel:
            outs = vrnn_ops.VRNNCellFunction.apply(residual, beta_sd, eps_sd, leaves[0], leaves[1], leaves[2], eps,
                                                   *leaves[3:])
        else:
            outs = vrnn_ops.vrnn_chain_plain(leaves[3:], leaves[0], leaves[1], leaves[2], eps.to(dtype),
                                             inference=True, residual_posterior=residual, sd_beta=beta_sd,
                                             sd_epsilon=eps_sd)[0]
        loss = sum((o * g.to(dtype)).sum() for o, g in zip(outs, g_out))
        grads = iter(torch.autograd.grad(loss, [t for t in leaves if t is not None]))
        return [None if t is None else next(grads) for t in leaves]

    # 30. K8-bwd against its twin: the train shape (19 rows, the first step's stacks, ragged: no gradient
    # past a row's last stack, as the masked ELBO gives none, orthogonal w_hh), H = 32 with a given h0 and
    # no residual posterior, and h not conditioned on x. K8-bwd (through VRNNCellFunction: K8 in save mode,
    # one K8-bwd launch, the weight-gradient GEMMs) and autograd of the f32 twin are both held to autograd of
    # the f64 twin: every gradient's largest error, relative to its largest value, at most twice the f32
    # twin's plus 1e-6 (~16 f32 ulps of the largest value: where the twin happens to round as f64 does, the
    # kernel's other summation order still costs a few ulps). Then the kernel alone against its f64 twin
    # (vrnn_cell_backward_plain) on the same saved f32 tensors: its max_abs_err.
    small = vrnn_model.VRNNCell(32, 32, 8, 64, residual_posterior=False, device=dev)
    weights.load_jax_params(small, weights.random_jax_params(small, SEED + 30))
    no_x = vrnn_model.VRNNCell(64, 64, 16, 128, condition_h_on_x=False, residual_posterior=True, device=dev)
    weights.load_jax_params(no_x, weights.random_jax_params(no_x, SEED + 31))
    ragged = (torch.arange(T0, device=dev)[None, :] < stacks0[:, None]).float()[..., None]
    bwd_cases = {
        "train_B19": (cell, enc0, torch.zeros(VRNN_TRAIN_B, R, device=dev), ragged),
        "H32_given_h0": (small, torch.randn(3, 40, 32, generator=gen, device=dev) * 0.5,
                         torch.randn(3, 64, generator=gen, device=dev) * 0.3, None),
        "h_not_on_x": (no_x, torch.randn(5, 60, 64, generator=gen, device=dev) * 0.5,
                       torch.randn(5, 128, generator=gen, device=dev) * 0.3, None),
    }
    names_ = ["xpost", "xg", "h0"] + [f"w{i}" for i in range(vrnn_ops.N_WEIGHTS)]
    for name, (c_, x, h0, mask) in bwd_cases.items():
        w = [t.detach() for t in c_.cell_weights()]
        B_, T_ = x.shape[:2]
        Rc, Hc, Zc = c_.r_dim, w[0].shape[1], w[6].shape[1] // 2
        eps = torch.randn(B_, T_, Zc, generator=gen, device=dev)
        g_out = [torch.randn(B_, T_, n, generator=gen, device=dev) * (1.0 if mask is None else mask)
                 for n in (Rc, Zc, Hc, Zc, Zc, Zc, Zc)]
        xpost, xg, kw = vrnn_ops.hoist(w, x, True, c_.condition_h_on_x)
        res_ = c_.residual_posterior
        cuda.reset_launch_counts()
        got = chain_grads(kw, xpost, xg, h0, eps, g_out, torch.float32, True, res_)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        twin = chain_grads(kw, xpost, xg, h0, eps, g_out, torch.float32, False, res_)
        ref = chain_grads(kw, xpost, xg, h0, eps, g_out, torch.float64, False, res_)
        errs = {}
        for n_, a_, b_, r_ in zip(names_, got, twin, ref):
            if r_ is None:
                continue
            scale = r_.abs().max().clamp_min(1e-30)
            errs[n_] = (((a_.double() - r_).abs().max() / scale).item(), ((b_.double() - r_).abs().max() / scale).item())
        finite = all(bool(torch.isfinite(t).all()) for t in got if t is not None)
        over = {k: v for k, v in errs.items() if v[0] > 2 * v[1] + 1e-6}
        expect(finite and not over and (counts["vrnn_cell"], counts["vrnn_cell_bwd"]) == (1, 1),
               f"K8-bwd {name}: launches {counts['vrnn_cell']}/{counts['vrnn_cell_bwd']}, finite {finite}, over {over}")
        worst = max(errs, key=lambda k: errs[k][0])
        phase("K8-bwd", case=name, shape=tuple(x.shape), R=Rc, H=Hc, Z=Zc, gradients=len(errs),
              kernel_max_rel_vs_f64=f"{errs[worst][0]:.3g}", twin_f32_max_rel_vs_f64=f"{max(v[1] for v in errs.values()):.3g}",
              worst=worst, twin_at_worst=f"{errs[worst][1]:.3g}")
        if name == "train_B19":
            with torch.no_grad():
                outs, saved = vrnn_ops.vrnn_cell_save(kw, xpost, xg, h0, eps, residual_posterior=res_, sd_beta=beta_sd,
                                                      sd_epsilon=eps_sd)
                dpre, dh0 = vrnn_ops.vrnn_cell_backward(kw, h0, eps, outs.h, outs.phi_z, saved, g_out,
                                                        residual_posterior=res_, sd_beta=beta_sd)
                d64 = [t.double() for t in (h0, eps, outs.h, outs.phi_z, saved)]
                dpre_r, dh0_r = vrnn_ops.vrnn_cell_backward_plain([t.double() for t in kw], *d64,
                                                                  [g.double() for g in g_out], residual_posterior=res_,
                                                                  sd_beta=beta_sd)
            kernel_err = max((dpre.double() - dpre_r).abs().max().item(), (dh0.double() - dh0_r).abs().max().item())
            scale = max(dpre_r.abs().max().item(), dh0_r.abs().max().item())
            expect(kernel_err <= 1e-4 * scale, f"K8-bwd alone vs its f64 twin: {kernel_err} (largest {scale})")
            record["vrnn_cell_bwd"]["max_abs_err"] = kernel_err
            phase("K8-bwd-alone", case=name, max_abs_err_vs_f64=f"{kernel_err:.3g}", largest=f"{scale:.3g}",
                  saved_MB=f"{saved.numel() * 4 / 2**20:.1f}", dpre_MB=f"{dpre.numel() * 4 / 2**20:.1f}")
            del outs, saved, dpre, dh0, d64, dpre_r, dh0_r
        del got, twin, ref
    torch.cuda.empty_cache()

    # 31. the train slice: flags of benchmarks.txt:17 -> driver -> model on the card -> weights bridge ->
    # vrnn_audio.train with its annealers, 3 Adam steps on 19 utterances a step; the latent noise from a
    # generator of its own, alike for the kernel and the plain runs
    def run_train(plain_path_=False):
        weights.load_jax_params(model, params)
        log = StepLog(Tracker())
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise(SEED + 31):
            cuda.reset_launch_counts()
            t0 = time.time()
            vrnn_audio.train(model, targs, train_batches, log)
            torch.cuda.synchronize()
            return log.steps, cuda.launch_counts(), time.time() - t0

    steps_k, counts, seconds = run_train()
    steps_p, counts_p, seconds_p = run_train(plain_path_=True)
    expected = dict(vrnn_cell=3, vrnn_cell_bwd=3, dmol_log_prob=3, dmol_log_prob_bwd=3, dmol_sample=3)
    expect(counts == {**dict.fromkeys(counts, 0), **expected},
           f"VRNN train-step launches {counts}, expected {expected} (1/1/1/1/1 a step)")
    expect(not any(counts_p.values()), f"the plain VRNN train path launched kernels: {counts_p}")
    record["vrnn_cell"]["launches"] = record["vrnn_cell"].get("launches", 0) + counts["vrnn_cell"]
    record["vrnn_cell_bwd"]["launches"] = counts["vrnn_cell_bwd"]
    losses, losses_p = [st["loss"] for st in steps_k], [st["loss"] for st in steps_p]
    loss_rel = [abs(a_ - b_) / abs(b_) for a_, b_ in zip(losses, losses_p)]
    expect(all(math.isfinite(v) for st in steps_k for v in st.values()), f"VRNN train metrics not finite: {steps_k}")
    # step 0: the same parameters, only the sums' order differs (1e-5). Later steps: Adam's first updates
    # move every parameter by about lr sign(g), so a gradient element near zero whose sign the summation
    # order flips moves by 2 lr: 1e-4
    expect(loss_rel[0] <= 1e-5 and max(loss_rel) <= 1e-4, f"VRNN train losses {losses} vs plain {losses_p}")
    ref_annealers = vrnn_audio.build_annealers(targs)
    ref_values = [{k: float(np.float32(a.step())) for k, a in ref_annealers.items()} for _ in range(3)]
    got_values = [{k: st[k] for k in ("beta", "free_nats")} for st in steps_k]
    expect(got_values == ref_values and got_values[0] == dict(beta=0.0, free_nats=2.0),
           f"annealers {got_values}, expected {ref_values}")
    phase("vrnn-train-slice", steps=3, utterances_per_step=VRNN_TRAIN_B,
          samples_per_step=[sum(len(w) for _, w in b_) for b_ in train_batches],
          stacks_per_step=[int(torch.ceil(b_["x_sl"].max() / S)) for b_ in step_batches],
          losses=[f"{v:.6f}" for v in losses], losses_plain=[f"{v:.6f}" for v in losses_p],
          loss_rel=[f"{v:.3g}" for v in loss_rel], beta=[v["beta"] for v in got_values],
          free_nats=[v["free_nats"] for v in got_values], launches_per_step={k: v // 3 for k, v in counts.items() if v},
          seconds=f"{seconds:.2f}", seconds_plain=f"{seconds_p:.2f}")

    # the step-0 gradients of every parameter at beta 1 and free nats 2 (every gradient path of the cell
    # live): the kernels and the f32 twins both held to the f64 twins, the kernels no further than twice
    # the f32 twins plus 1e-6 (relative norms)
    def step0_grads(m, plain_path_, dtype):
        m.zero_grad(set_to_none=True)
        m.train()
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise(SEED + 32):
            loss, _, _ = m(x0.to(dtype), sl0, beta=1.0, free_nats=2.0,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
            loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return grads, loss.item()

    weights.load_jax_params(model, params)
    g_k, loss_k = step0_grads(model, False, torch.float32)
    g_p, loss_p = step0_grads(model, True, torch.float32)
    model64 = copy.deepcopy(model).double()
    g_64, loss_64 = step0_grads(model64, True, torch.float64)
    del model64
    e_k = {n: rel_norm(g_k[n], g_64[n]) for n in g_64}
    e_p = {n: rel_norm(g_p[n], g_64[n]) for n in g_64}
    over = {n: (e_k[n], e_p[n]) for n in e_k if e_k[n] > 2 * e_p[n] + 1e-6}
    expect(all(torch.isfinite(g_).all() for g_ in g_k.values()) and not over, f"VRNN step-0 gradients: {over}")
    worst = max(e_k, key=e_k.get)
    phase("vrnn-train-grads", loss=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}", loss_f64=f"{loss_64:.6f}",
          kernel_max_rel_vs_f64=f"{e_k[worst]:.3g}", twin_f32_max_rel_vs_f64=f"{max(e_p.values()):.3g}", worst=worst,
          kernel_vs_twin_max_rel=f"{max(rel_norm(g_k[n], g_p[n]) for n in g_p):.3g}", parameters=len(e_k))
    del g_k, g_p, g_64
    torch.cuda.empty_cache()

    # 32. times, CUDA events, a different input each call: K8 in save mode against K8 without it at the train
    # shape; K8-bwd alone, and the cell's backward (K8-bwd and the weight-gradient GEMMs) against autograd
    # of the twin; the whole train step with its host enqueue time; a torch.profiler breakdown of a step;
    # K8-bwd's own trace by stage and phase
    w = [t.detach() for t in cell.cell_weights()]
    xpost, xg, kw = vrnn_ops.hoist(w, enc0, True, True)
    zeros_h = torch.zeros(VRNN_TRAIN_B, R, device=dev)
    eps_t = [torch.randn(VRNN_TRAIN_B, T0, Z, generator=gen, device=dev) for _ in range(3)]
    save_kw = dict(residual_posterior=True, sd_beta=beta_sd, sd_epsilon=eps_sd)

    def k8_no_save(e_):
        with torch.no_grad():
            vrnn_ops.vrnn_cell(w, enc0, zeros_h, e_, inference=True, condition_h_on_x=True, **save_kw)

    def k8_save(e_):
        with torch.no_grad():
            vrnn_ops.vrnn_cell_save(kw, xpost, xg, zeros_h, e_, **save_kw)

    t_save = alternate(k8_no_save, k8_save, eps_t)
    phase("time-K8-save", card=card, shape=f"({VRNN_TRAIN_B},{T0})", dtype="f32", save_ms=f"{t_save['kernel']:.4f}",
          no_save_ms=f"{t_save['plain']:.4f}", us_per_step_save=f"{t_save['kernel'] * 1e3 / T0:.3f}",
          us_per_step_no_save=f"{t_save['plain'] * 1e3 / T0:.3f}", ratio=f"{t_save['kernel'] / t_save['plain']:.4f}")

    def print_trace(label, trace, steps, stage_names):
        per_step = vrnn_ops.read_trace(trace) / steps / 1e3  # us a step
        phase(label, card=card, steps=steps, us_per_step=f"{per_step.sum().item():.3f}",
              inputs_us=f"{per_step[:, 0].sum().item():.3f}", products_us=f"{per_step[:, 1].sum().item():.3f}",
              finish_us=f"{per_step[:, 2].sum().item():.3f}", barrier_us=f"{per_step[:, 3].sum().item():.3f}",
              by_stage={n_: f"{v_:.2f}" for n_, v_ in zip(stage_names, per_step.sum(1).tolist())})

    # K8's own trace at B = 19: three passes of 8 rows a stage where the test pass's B = 6 needs one
    trace = torch.zeros(vrnn_ops.trace_size(), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for e_ in eps_t:
            vrnn_ops.vrnn_cell(w, enc0, zeros_h, e_, inference=True, condition_h_on_x=True, trace=trace, **save_kw)
    torch.cuda.synchronize()
    print_trace("K8-trace-train", trace, len(eps_t) * T0,
                ("L1+gh", "L2", "L3", "heads+z", "phi1", "phi2", "phi3", "phi4", "gru"))

    bwd_inputs = []
    with torch.no_grad():
        for e_ in eps_t:
            outs, saved = vrnn_ops.vrnn_cell_save(kw, xpost, xg, zeros_h, e_, **save_kw)
            g_out = [torch.randn(VRNN_TRAIN_B, T0, n, generator=gen, device=dev) * ragged for n in (R, Z, H, Z, Z, Z, Z)]
            bwd_inputs.append((e_, outs, saved, g_out))

    def k8_bwd(inp, trace=None):
        e_, outs, saved, g_out = inp
        return vrnn_ops.vrnn_cell_backward(kw, zeros_h, e_, outs.h, outs.phi_z, saved, g_out, trace=trace,
                                           residual_posterior=True, sd_beta=beta_sd)

    def cell_bwd(inp):
        e_, outs, saved, _ = inp
        dpre, _ = k8_bwd(inp)
        vrnn_ops.cell_weight_grads(kw, zeros_h, outs.h, outs.z, outs.phi_z, saved, dpre)

    kernel_only = sorted(cuda_time_ms(k8_bwd, bwd_inputs))[1]
    fn_bwd = sorted(cuda_time_ms(cell_bwd, bwd_inputs))[1]

    def graph(kernel, e_, g_out):
        leaves = [t.detach().clone().requires_grad_(True) for t in (xpost, xg, zeros_h, *kw)]
        if kernel:
            outs = vrnn_ops.VRNNCellFunction.apply(True, beta_sd, eps_sd, leaves[0], leaves[1], leaves[2], e_,
                                                   *leaves[3:])
        else:
            outs = vrnn_ops.vrnn_chain_plain(leaves[3:], leaves[0], leaves[1], leaves[2], e_, inference=True, **save_kw)[0]
        return (sum((o * g).sum() for o, g in zip(outs, g_out)),), leaves, None

    def backward_only(g_):
        outputs, inputs, _ = g_
        return torch.autograd.grad(outputs, inputs, retain_graph=True)

    e0, _, _, g0 = bwd_inputs[0]
    pair = [(graph(False, e0, g0), graph(True, e0, g0))]
    t_bwd = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), pair)
    del pair
    rows = VRNN_TRAIN_B * T0
    n_kernel = sum(t.numel() for t in kw[0::2])  # the kernels' elements: one multiply-add a row-step each in the
    dw = sum(w_ for _, w_ in vrnn_ops.grad_fields(R, H, Z).values())  # chain and in the weight gradients
    sw = sum(w_ for _, w_ in vrnn_ops.save_fields(R, H, Z).values())
    # bytes: the kernel weights read and their gradients written; a row-step's saved values, h, phi, z, eps
    # and the outputs' gradients (R + H + 5Z) read, d xpost (H) and d xg (3R) written; h0 and dh0
    record["vrnn_cell_bwd"].update(ms=t_bwd["kernel"], plain_ms=t_bwd["plain"], **roofline(
        bytes_=4 * (2 * sum(t.numel() for t in kw) + rows * (sw + R + H + 2 * Z + (R + H + 5 * Z) + H + 3 * R)
                    + 2 * VRNN_TRAIN_B * R),
        flops=2 * rows * 2 * n_kernel + rows * dw, peak=F32_PEAK))
    phase("time-K8-bwd", card=card, shape=f"({VRNN_TRAIN_B},{T0})", dtype="f32", kernel_alone_ms=f"{kernel_only:.4f}",
          cell_backward_ms=f"{fn_bwd:.4f}", cell_backward_in_turns_ms=f"{t_bwd['kernel']:.4f}",
          twin_autograd_ms=f"{t_bwd['plain']:.4f}", us_per_step=f"{kernel_only * 1e3 / T0:.3f}",
          bound_ms=f"{record['vrnn_cell_bwd']['bound_ms']:.4f}", bound_by=record["vrnn_cell_bwd"]["bound_by"],
          includes="cell backward: K8-bwd, the 14 weight-gradient GEMMs and the bias product")

    # K8-bwd's own trace: the SM cycles of its ten stages' phases as its first CTA sees them
    trace = torch.zeros(vrnn_ops.bwd_trace_size(), dtype=torch.int64, device=dev)
    for inp in bwd_inputs:
        k8_bwd(inp, trace=trace)
    torch.cuda.synchronize()
    print_trace("K8-bwd-trace", trace, len(bwd_inputs) * T0,
                ("gates", "phi4", "phi3", "phi2", "phi1", "z+heads", "mlp3", "mlp2", "mlp1", "dh"))
    del bwd_inputs

    # the train step: the twins once on the first batch (as phases 41 and 65 time theirs), the kernels over the three
    tx, _ = common.build_tx_and_lr(targs)
    weights.load_jax_params(model, params)
    model.train()
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(common.loss_fn)
    scalars = dict(beta=torch.tensor(0.5), free_nats=torch.tensor(2.0))

    def run_step(b_):
        train_step(state, b_, scalars)

    def run_step_plain(b_):
        with plain():
            train_step(state, b_, scalars)

    plain_step_ms = cuda_time_ms(run_step_plain, step_batches[:1], warmup=0)[0]
    torch.cuda.reset_peak_memory_stats()
    ts = sorted(cuda_time_ms(run_step, step_batches))[1]
    torch.cuda.synchronize()
    enqueue = []
    for b_ in step_batches:
        t0 = time.perf_counter()
        run_step(b_)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    samples = sum(int(b_["x_sl"].sum()) for b_ in step_batches) / len(step_batches)
    phase("time-vrnn-train-step", card=card, utterances=VRNN_TRAIN_B, samples=int(samples), kernel_ms=f"{ts:.3f}",
          plain_ms=f"{plain_step_ms:.3f}",
          host_enqueue_ms=f"{sorted(enqueue)[1]:.3f}", samples_per_s=f"{samples / ts * 1e3:.0f}",
          peak_memory_GB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # where the train step's device time goes: torch.profiler over the 3 steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b_ in step_batches:
            run_step(b_)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3

    kernels_ = device_kernels(prof)
    busy_ms = sum(device_us(e_) for e_ in kernels_) / 1e3 / 3
    phase("profile-vrnn-train-step", card=card, device_ms_per_step=f"{busy_ms:.3f}", wall_ms_per_step=f"{wall_ms:.3f}",
          idle_share=f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured",
          kernel_launches_per_step=sum(e_.count for e_ in kernels_) // 3)
    for e_ in sorted(kernels_, key=device_us, reverse=True)[:12]:
        print(f"  {device_us(e_) / 1e3 / 3:9.3f} ms/step {e_.count // 3:5d} calls/step  {e_.key[:90]}", flush=True)
    skip_checks("vrnn", vrnn_audio, model, params, targs, train_batches, train_step, step_batches, scalars, dev, expect)

    require(not failures, f"VRNN train phases failed: {failures}")


def srnn_phases(record, smi, dev):
    """Phases 33-37, the SRNN paths at the width of ``experiments/benchmarks.txt:22``: K7 and K9
    against their twins, the test pass (whole and with carried state), generation through the
    driver's hook, and their times. Each check is printed before any raises, so one run shows
    every number."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, srnn_audio
    from blvm_tpu_torch.models import srnn as srnn_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.ops import srnn as srnn_ops

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    args = srnn_audio.build_args(SRNN_FLAGS.split())
    model = srnn_audio.build_model(args)
    require(next(model.parameters()).device.type == "cuda", "srnn_audio.build_model did not build on the card")
    weights.load_jax_params(model, weights.random_jax_params(model, args.seed))
    model.eval()
    srnn = model.srnn
    S, Z, R, H = args.stack_frames, args.latent_size, srnn.r_dim, args.hidden_size
    rng = np.random.default_rng(args.seed + 33)
    lengths = rng.integers(SRNN_T * S // 3, SRNN_T * S + 1, SRNN_B)  # 24k-72k samples
    lengths[0] = SRNN_T * S  # the longest utterance fills all 1125 stacks
    x_np, x_sl_np = common.make_batch([synthetic_speech(int(n), rng) for n in lengths], args)
    x_dev, x_sl_dev = torch.from_numpy(x_np).to(dev), torch.from_numpy(x_sl_np).to(dev)
    stacks = torch.from_numpy(-(-lengths // S)).to(dev)
    mask = (torch.arange(SRNN_T, device=dev)[None] < stacks[:, None]).float()  # (6, 1125), the d GRU's
    d_gru, a_gru = srnn.d_forward_recurrent, srnn.a_backward_recurrent
    with torch.no_grad():
        enc = srnn.encoder(x_dev[..., None])  # (6, 1125, 256)
        u_enc = torch.cat([torch.zeros_like(enc[:, :1]), enc[:, :-1]], dim=1)
        d_out, _ = d_gru(u_enc, mask=mask)
        d = torch.cat([torch.zeros(SRNN_B, 1, R, device=dev), d_out[:, :-1]], dim=1)
        concat_flip = torch.cat([enc, d], dim=-1).flip(1)  # the a GRU's input (6, 1125, 768), its mask flipped
        a = a_gru(concat_flip, mask=mask.flip(1))[0].flip(1)
        xw_d = u_enc @ d_gru.w_ih + d_gru.b_ih  # K7's inputs on the test pass: (6, 1125, 1536)
        xw_a = concat_flip @ a_gru.w_ih + a_gru.b_ih

    def within(got, ref, atol, rtol):
        return all(bool(((g - r).abs() <= atol + rtol * r.abs()).all()) for g, r in zip(got, ref) if r is not None)

    def max_err(got, ref):
        return max((g - r).abs().max().item() for g, r in zip(got, ref) if r is not None)

    # 33. K7 against its twin at the test pass's shapes: the d GRU's mask and the a GRU's flipped one, and
    # H = 32 with a given h0 and a zero-length row, and T' = 1. Teacher-forced (a twin step from the
    # kernel's state entering every step): the products' summation order only, 1e-5 absolute plus 1e-5
    # relative. Free-running: those differences re-enter the chain every step, which does not amplify them,
    # so 1e-4 absolute plus 1e-5 relative, as K8's
    def k7_state_before(out, m, h0):
        """The state entering each step, from the kernel's outputs: out at the last step t' < t whose mask
        is 1, h0 before any (the state is frozen where the mask is 0)."""
        T_ = out.shape[1]
        steps = torch.arange(T_, device=dev)[None].expand_as(m)
        last = torch.where(m > 0, steps, torch.full_like(steps, -1)).cummax(dim=1).values  # last valid <= t
        prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
        kept = torch.gather(out, 1, prev.clamp_min(0)[..., None].expand(-1, -1, out.shape[-1]))
        return torch.where(prev[..., None] >= 0, kept, h0[:, None])

    g_small = torch.Generator().manual_seed(SEED + 33)
    small_w = [((torch.rand(*shape, generator=g_small) * 2 - 1) / 32**0.5).to(dev) for shape in ((32, 96), (96,))]
    small_mask = torch.ones(3, 40, device=dev)
    small_mask[1, 23:] = 0
    small_mask[2] = 0  # a zero-length row
    k7_cases = {
        "d_B6_T1125": (xw_d, d_gru.w_hh, d_gru.b_hh, mask, torch.zeros(SRNN_B, R, device=dev)),
        "a_flipped_B6_T1125": (xw_a, a_gru.w_hh, a_gru.b_hh, mask.flip(1), torch.zeros(SRNN_B, R, device=dev)),
        "H32_given_h0": ((torch.randn(3, 40, 96, generator=g_small) * 0.5).to(dev), *small_w, small_mask.flip(1),
                         (torch.randn(3, 32, generator=g_small) * 0.3).to(dev)),
        "T1_B2": (xw_d[:GEN_B, :1], d_gru.w_hh, d_gru.b_hh, None, d[:GEN_B, 5]),
    }
    k7_err = 0.0
    for name, (xw, w_hh, b_hh, m, h0) in k7_cases.items():
        w_hh, b_hh = w_hh.detach(), b_hh.detach()
        with torch.no_grad():
            cuda.reset_launch_counts()
            got = recurrent.gru_recurrence(xw, w_hh, b_hh, m, h0)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["gru_recurrence"]
            free = recurrent.gru_recurrence_plain(xw, w_hh, b_hh, m, h0)
            B_, T_ = xw.shape[:2]
            m_ = torch.ones(B_, T_, device=dev) if m is None else m
            h_prev = k7_state_before(got[0], m_, h0)
            forced_out, forced_h = recurrent.gru_recurrence_plain(
                xw.reshape(B_ * T_, 1, -1), w_hh, b_hh, m_.reshape(B_ * T_, 1), h_prev.reshape(B_ * T_, -1))
        forced = (forced_out.reshape(B_, T_, -1), forced_h.reshape(B_, T_, -1)[:, -1])
        e_free, e_forced = max_err(got, free), max_err(got, forced)
        expect(launches == 1 and all(bool(torch.isfinite(t).all()) for t in got), f"K7 {name}: launches/finite")
        expect(within(got, forced, 1e-5, 1e-5), f"K7 {name}: teacher-forced {e_forced}")
        expect(within(got, free, 1e-4, 1e-5), f"K7 {name}: free-running {e_free}")
        if name == "H32_given_h0":
            expect(torch.equal(got[1][2], h0[2]) and not got[0][2].any(), "K7: the zero-length row moved")
        if name.endswith("T1125"):
            k7_err = max(k7_err, e_free)
        phase("K7", case=name, shape=tuple(xw.shape), launches=launches, free_max_abs_err=f"{e_free:.3g}",
              teacher_forced_max_abs_err=f"{e_forced:.3g}")
    record["gru_recurrence"]["max_abs_err"] = k7_err

    # 34. K9 against its twin in inference mode on the test pass's d and a (hoisted), with the residual
    # posterior on and off, on given noise: teacher-forced (a twin step from the kernel's z entering every
    # step) within 1e-5 + 1e-5 |twin|, free-running within 1e-4 + 1e-5 |twin|; prior mode at T' = 1,
    # sampled and at the mode, and over T' = 64 steps, within 1e-5 + 1e-5 |twin|
    step = srnn.step
    head = step.prior_net.layers_1
    chain_kw = dict(sd_beta=head.beta, sd_epsilon=head.epsilon)
    with torch.no_grad():
        xp, xq, kw_ = srnn_ops.hoist(step.chain_weights(), d, a, True)
    kernel_w = [t.detach() for t in kw_]
    eps_k9 = torch.randn(SRNN_B, SRNN_T, Z, generator=gen, device=dev)
    z0 = torch.zeros(SRNN_B, Z, device=dev)
    k9_err = 0.0
    for residual in (True, False):
        kw = dict(inference=True, residual_posterior=residual, **chain_kw)
        with torch.no_grad():
            cuda.reset_launch_counts()
            got = srnn_ops.srnn_chain(kernel_w, xp, xq, z0, eps_k9, **kw)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["srnn_chain"]
            free = srnn_ops.srnn_chain_plain(kernel_w, xp, xq, z0, eps_k9, **kw)
            rows = SRNN_B * SRNN_T
            z_prev = torch.cat([z0[:, None], got.z[:, :-1]], dim=1).reshape(rows, Z)
            forced = srnn_ops.srnn_chain_plain(kernel_w, xp.reshape(rows, 1, -1), xq.reshape(rows, 1, -1), z_prev,
                                               eps_k9.reshape(rows, 1, Z), **kw)
        forced = [t.reshape(SRNN_B, SRNN_T, Z) for t in forced]
        e_free, e_forced = max_err(got, free), max_err(got, forced)
        expect(launches == 1 and all(bool(torch.isfinite(t).all()) for t in got), f"K9 residual={residual}: launches")
        expect(within(got, forced, 1e-5, 1e-5), f"K9 residual={residual}: teacher-forced {e_forced}")
        expect(within(got, free, 1e-4, 1e-5), f"K9 residual={residual}: free-running {e_free}")
        k9_err = max(k9_err, e_free)
        phase("K9", mode="inference", residual_posterior=residual, shape=tuple(xp.shape), launches=launches,
              free_max_abs_err=f"{e_free:.3g}", teacher_forced_max_abs_err=f"{e_forced:.3g}")
    record["srnn_chain"]["max_abs_err"] = k9_err
    for name, (T_, use_mode) in {"T1_sampled": (1, False), "T1_mode": (1, True), "T64_sampled": (64, False)}.items():
        xp_ = xp[:GEN_B, 100:100 + T_]
        z0_ = torch.randn(GEN_B, Z, generator=gen, device=dev) * 0.5
        eps_ = None if use_mode else torch.randn(GEN_B, T_, Z, generator=gen, device=dev)
        kw = dict(inference=False, residual_posterior=True, use_mode=use_mode, **chain_kw)
        with torch.no_grad():
            cuda.reset_launch_counts()
            got = srnn_ops.srnn_chain(kernel_w, xp_, None, z0_, eps_, **kw)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["srnn_chain"]
            ref = srnn_ops.srnn_chain_plain(kernel_w, xp_, None, z0_, eps_, **kw)
        e_ = max_err(got, ref)
        expect(launches == 1 and got.enc_mu is None and within(got, ref, 1e-5, 1e-5), f"K9 prior {name}: {e_}")
        phase("K9", mode="prior", case=name, shape=tuple(xp_.shape), use_mode=use_mode, max_abs_err=f"{e_:.3g}")

    # 35. the test pass: flags of benchmarks.txt:22 -> driver -> model on the card -> weights bridge, whole
    # and with --split_eval (d_n and z_n carried, a from zeros), kernels against the twins with the same
    # noise (the latent noise drawn from one generator seeded alike for both runs)
    n_chunks = len(model.split_sequence(x_np, x_sl_np, length=args.random_segment_size or 16 * S)[0])

    def seeded_noise():
        g_ = torch.Generator(device=dev).manual_seed(SEED + 35)
        return mock.patch.object(srnn_model, "gaussian_noise",
                                 lambda _, shape, like: torch.randn(shape, generator=g_, dtype=like.dtype,
                                                                    device=like.device))

    def test_pass(split, plain_path_=False):
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise():
            cuda.reset_launch_counts()
            t0 = time.time()
            values = srnn_audio.evaluate(model, argparse_copy(args, split_eval=split), [(x_np, x_sl_np)], Tracker(),
                                         generator=torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            return values, cuda.launch_counts(), time.time() - t0

    path_launches = {"gru_recurrence": 0, "srnn_chain": 0}
    for split in (False, True):
        values, counts, seconds = test_pass(split)
        values_p, counts_p, seconds_p = test_pass(split, plain_path_=True)
        forwards = n_chunks if split else 1
        expected = dict(gru_recurrence=2 * forwards, srnn_chain=forwards, dmol_log_prob=forwards,
                        dmol_sample=forwards)
        expect(counts == {**dict.fromkeys(counts, 0), **expected},
               f"SRNN test pass split={split}: launches {counts}, expected {expected}")
        expect(not any(counts_p.values()), f"the plain SRNN test pass launched kernels: {counts_p}")
        for k in path_launches:
            path_launches[k] += counts[k]
        bpd_rel = abs(values["bpd"] - values_p["bpd"]) / abs(values_p["bpd"])
        finite = all(math.isfinite(values[k]) for k in ("loss", "elbo", "rec", "kl", "bpd"))
        # f32 throughout: only the summation orders of K7, K9, K2 and the products differ
        expect(finite and bpd_rel <= 1e-5, f"SRNN test pass split={split}: {values} vs twins {values_p}")
        phase("srnn-test-pass", split_eval=split, utterances=list(map(int, lengths)), forwards=forwards,
              loss=f"{values['loss']:.6f}", bpd=f"{values['bpd']:.6f}", bpd_plain=f"{values_p['bpd']:.6f}",
              bpd_rel=f"{bpd_rel:.3g}", kl=f"{values['kl']:.3f}", rec=f"{values['rec']:.3f}",
              launches_per_forward={k: v // forwards for k, v in counts.items() if v}, seconds=f"{seconds:.2f}",
              plain_seconds=f"{seconds_p:.2f}")
    # the chain in prior mode under a gradient raises on the card: K9-bwd runs the inference mode, and no
    # driver differentiates a generation
    try:
        srnn_ops.srnn_chain(kernel_w, xp[:1, :4].detach().requires_grad_(True), None, z0[:1], eps_k9[:1, :4],
                            inference=False, residual_posterior=True, **chain_kw)
        raised = ""
    except NotImplementedError as err:
        raised = str(err)
    expect("inference mode only" in raised, f"a prior-mode chain with a gradient did not raise: {raised!r}")
    phase("srnn-prior-no-backward", raised=raised.split(";")[0].replace(" ", "_")[:60])

    # 36. generation through the driver's hook: 2 x 2000 stacks of 64 (--generate_frames 128000), one K7
    # (T' = 1), one K9 (prior mode, T' = 1) and one K3 launch a stack; then the rollout from given noise and
    # uniforms against the twins fed the same noise and the kernel's frames (every stack at once)
    out_dir = Path(__file__).resolve().parent / "blvm_tpu_torch" / "_build" / "srnn_generation_hook"
    hook = srnn_audio.make_generation_hook(model, argparse_copy(args, generate_every=5))
    cuda.reset_launch_counts()
    t0 = time.time()
    paths = hook(5, out_dir)
    torch.cuda.synchronize()
    hook_s = time.time() - t0
    counts = cuda.launch_counts()
    n_stacks = args.generate_frames // S
    expected = dict(gru_recurrence=n_stacks, srnn_chain=n_stacks, dmol_sample=n_stacks)
    expect(counts == {**dict.fromkeys(counts, 0), **expected}, f"SRNN generation launches {counts}, expected {expected}")
    for k in path_launches:
        path_launches[k] += counts[k]
    shapes = []
    for path in paths:
        with wave.open(str(path)) as f:
            shapes.append((f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()))
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        expect(shapes[-1] == (1, 2, 16000, n_stacks * S) and np.abs(pcm).max() > 0, f"SRNN hook wav {path}: {shapes[-1]}")
    expect(len(paths) == 2, f"SRNN hook wrote {paths}")
    phase("srnn-generation-hook", stacks=n_stacks, launches=counts, seconds=f"{hook_s:.2f}",
          files=[str(p_.relative_to(out_dir.parents[2])) for p_ in paths], wav=shapes)
    record["gru_recurrence"]["launches"] = path_launches["gru_recurrence"]
    record["srnn_chain"]["launches"] = path_launches["srnn_chain"]

    eps_g = torch.randn(n_stacks, GEN_B, Z, generator=gen, device=dev)
    u_g = (torch.rand(n_stacks * S, GEN_B, 10, generator=gen, device=dev),
           torch.rand(n_stacks * S, GEN_B, 1, generator=gen, device=dev))
    (frames, _), _ = model.generate(n_samples=GEN_B, max_timesteps=n_stacks, eps=eps_g, uniforms=u_g)
    with torch.no_grad():
        stacks_in = torch.cat([torch.zeros(GEN_B, S, device=dev), frames[:, :-S, 0]], dim=1)  # each step's input stack
        xw_g = srnn.encoder(stacks_in[..., None]) @ d_gru.w_ih + d_gru.b_ih
        d_g, _ = recurrent.gru_recurrence_plain(xw_g, d_gru.w_hh, d_gru.b_hh, None, torch.zeros(GEN_B, R, device=dev))
        xp_g, _, kw_g = srnn_ops.hoist(step.chain_weights(), d_g, None, False)
        z_g = srnn_ops.srnn_chain_plain(kw_g, xp_g, None, torch.zeros(GEN_B, Z, device=dev), eps_g.transpose(0, 1),
                                        inference=False, residual_posterior=True, **chain_kw).z
        dec_params = srnn.likelihood(srnn.decoder(torch.cat([z_g, d_g], dim=-1)))
        twin_frames = variational.rsample_discretized_logistic_mixture(
            None, *dec_params, uniforms=tuple(u.transpose(0, 1) for u in u_g))
    err = (twin_frames - frames).abs()
    share = (err <= 1e-5).double().mean().item()
    # f32: the twins fed the kernel's frames and the same noise; a frame whose Gumbel pick sits within
    # f32 rounding of a tie may pick another component: at most 1e-3 of them
    expect(bool(torch.isfinite(frames).all()) and share >= 1 - 1e-3, f"SRNN rollout vs twins: share {share}")
    phase("srnn-generate-vs-twins", frames=GEN_B * n_stacks * S, share_within_1e5=f"{share:.6f}",
          max_abs_err=f"{err.max().item():.3g}", frames_outside=int((err > 1e-5).sum().item()))
    del twin_frames, dec_params, u_g

    # 37. times, CUDA events, a different input each call, kernel and twin in turns: K7 at the d and a
    # shapes against its twin and against torch.nn.GRU (cuDNN, unmasked, with its input projection: the
    # yardstick; the port never calls it) and at T' = 1; K9 a launch and a step, a T' = 1 call split into
    # the wrapper's host time and its kernel's device time, K9's trace by stage; the test pass whole and
    # split; a generation; torch.profiler breakdowns of a test pass and of 200 generated stacks
    xws_d = [xw_d + 0.01 * torch.randn(xw_d.shape, generator=gen, device=dev) for _ in range(3)]
    xws_a = [xw_a + 0.01 * torch.randn(xw_a.shape, generator=gen, device=dev) for _ in range(3)]
    zeros_r = torch.zeros(SRNN_B, R, device=dev)

    def k7_for(gru, m):
        w_hh, b_hh = gru.w_hh.detach(), gru.b_hh.detach()

        def kernel(xw):
            with torch.no_grad():
                recurrent.gru_recurrence(xw, w_hh, b_hh, m, zeros_r)

        def twin(xw):
            with torch.no_grad():
                recurrent.gru_recurrence_plain(xw, w_hh, b_hh, m, zeros_r)

        return twin, kernel

    def cudnn_for(gru, x_in):
        lib = torch.nn.GRU(gru.w_ih.shape[0], R, batch_first=True).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(gru.w_ih.T)
            lib.weight_hh_l0.copy_(gru.w_hh.T)
            lib.bias_ih_l0.copy_(gru.b_ih)
            lib.bias_hh_l0.copy_(gru.b_hh)
            ref_out = lib(x_in)[0]
            ours = gru(x_in)[0]  # unmasked, as cuDNN's is here
        return lib, (ref_out - ours).abs().max().item()

    times_k7 = {}
    for label, gru, m, xws, x_in in (("d", d_gru, mask, xws_d, u_enc), ("a", a_gru, mask.flip(1), xws_a, concat_flip)):
        twin, kernel = k7_for(gru, m)
        t_k7 = alternate(twin, kernel, xws)
        lib, lib_err = cudnn_for(gru, x_in)
        inputs = [x_in + 0.01 * torch.randn(x_in.shape, generator=gen, device=dev) for _ in range(3)]

        def library(x_, lib=lib):
            with torch.no_grad():
                lib(x_)

        def module(x_, gru=gru, m=m):
            with torch.no_grad():
                gru(x_, mask=m)

        t_lib = alternate(library, module, inputs)
        expect(lib_err <= 1e-4, f"the yardstick torch.nn.GRU computes another function ({label}): max err {lib_err}")
        times_k7[label] = (t_k7, t_lib, lib_err)
    t_k7, t_lib, lib_err = times_k7["d"]
    G = 3 * R
    rows = SRNN_B * SRNN_T
    record["gru_recurrence"].update(ms=t_k7["kernel"], plain_ms=t_k7["plain"], library_ms=t_lib["plain"], **roofline(
        bytes_=4 * (rows * (G + 1 + R) + R * G + G + 2 * SRNN_B * R), flops=2 * rows * R * G, peak=F32_PEAK))
    for label, (t_k7_, t_lib_, err_) in times_k7.items():
        phase("time-K7", card=card, gru=label, shape=f"({SRNN_B},{SRNN_T},{G})", dtype="f32",
              kernel_ms=f"{t_k7_['kernel']:.4f}", plain_ms=f"{t_k7_['plain']:.4f}",
              us_per_step=f"{t_k7_['kernel'] * 1e3 / SRNN_T:.3f}", module_ms=f"{t_lib_['kernel']:.4f}",
              cudnn_gru_ms=f"{t_lib_['plain']:.4f}", cudnn_max_abs_err=f"{err_:.3g}",
              bound_ms=f"{record['gru_recurrence']['bound_ms']:.4f}")

    xw1 = [xw_d[:GEN_B, i:i + 1].contiguous() for i in range(20)]
    h1 = d[:GEN_B, 3].contiguous()
    w_hh_d, b_hh_d = d_gru.w_hh.detach(), d_gru.b_hh.detach()

    def k7_step(xw):
        with torch.no_grad():
            recurrent.gru_recurrence(xw, w_hh_d, b_hh_d, None, h1)

    def k7_step_plain(xw):
        with torch.no_grad():
            recurrent.gru_recurrence_plain(xw, w_hh_d, b_hh_d, None, h1)

    t1_k7 = alternate(k7_step_plain, k7_step, xw1)

    eps_t = [torch.randn(SRNN_B, SRNN_T, Z, generator=gen, device=dev) for _ in range(3)]
    chain_inf = dict(inference=True, residual_posterior=True, **chain_kw)

    def k9(eps_):
        with torch.no_grad():
            srnn_ops.srnn_chain(kernel_w, xp, xq, z0, eps_, **chain_inf)

    def k9_plain(eps_):
        with torch.no_grad():
            srnn_ops.srnn_chain_plain(kernel_w, xp, xq, z0, eps_, **chain_inf)

    t9 = alternate(k9_plain, k9, eps_t, warmup=1)
    chain_macs = 2 * (Z * H + 2 * H * H + H * 2 * Z)
    n_weights = sum(t.numel() for t in kernel_w)
    record["srnn_chain"].update(ms=t9["kernel"], plain_ms=t9["plain"], **roofline(
        bytes_=4 * (rows * (2 * H + Z) + SRNN_B * Z + n_weights + rows * 5 * Z), flops=2 * rows * chain_macs,
        peak=F32_PEAK))

    xp1 = xp[:GEN_B, :1].contiguous()
    z1 = torch.zeros(GEN_B, Z, device=dev)
    eps1 = [torch.randn(GEN_B, 1, Z, generator=gen, device=dev) for _ in range(20)]
    chain_prior = dict(inference=False, residual_posterior=True, **chain_kw)

    def k9_step(eps_):
        with torch.no_grad():
            srnn_ops.srnn_chain(kernel_w, xp1, None, z1, eps_, **chain_prior)

    def k9_step_plain(eps_):
        with torch.no_grad():
            srnn_ops.srnn_chain_plain(kernel_w, xp1, None, z1, eps_, **chain_prior)

    t1_k9 = alternate(k9_step_plain, k9_step, eps1)

    def t1_split(fn, inputs, kernel_name):
        """A T' = 1 call's host time (the calls enqueued back to back, no wait between them: the card runs
        behind the host) and the device time of all its kernels, and of the named kernel's alone."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i_ in inputs:
            fn(i_)
        host = (time.perf_counter() - t0) * 1e6 / len(inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i_ in inputs:
                fn(i_)
            torch.cuda.synchronize()
        kernels_ = device_kernels(prof)
        own = sum(device_us(e) for e in kernels_ if kernel_name in e.key)
        return host, sum(device_us(e) for e in kernels_) / len(inputs), own / len(inputs)

    split_7, split_9 = t1_split(k7_step, xw1, "gru_kernel"), t1_split(k9_step, eps1, "srnn_chain_kernel")
    phase("time-K7-T1", card=card, shape=f"({GEN_B},1,{G})", kernel_us=f"{t1_k7['kernel'] * 1e3:.2f}",
          plain_us=f"{t1_k7['plain'] * 1e3:.2f}", host_us=f"{split_7[0]:.2f}", device_us=f"{split_7[1]:.2f}",
          K7_device_us=f"{split_7[2]:.2f}")
    phase("time-K9", card=card, shape=f"({SRNN_B},{SRNN_T})", H=H, Z=Z, dtype="f32", kernel_ms=f"{t9['kernel']:.4f}",
          plain_ms=f"{t9['plain']:.4f}", us_per_step=f"{t9['kernel'] * 1e3 / SRNN_T:.3f}",
          bound_ms=f"{record['srnn_chain']['bound_ms']:.4f}", bound_by=record["srnn_chain"]["bound_by"],
          prior_T1_us_per_launch=f"{t1_k9['kernel'] * 1e3:.2f}", prior_T1_plain_us=f"{t1_k9['plain'] * 1e3:.2f}",
          T1_host_us=f"{split_9[0]:.2f}", T1_device_us=f"{split_9[1]:.2f}", T1_K9_device_us=f"{split_9[2]:.2f}")

    # where a step's time goes inside K9: its own trace (SM cycles of each stage's phases as its first CTA
    # sees them, converted at the loop's clock rate), over 3 launches at the test pass's shape and 20 at T' = 1
    stage_names = ("L1", "L2", "L3", "heads+z")
    for label, (xp_, xq_, z_, eps_list, kw) in {
            "K9-trace": (xp, xq, z0, eps_t, chain_inf),
            "K9-trace-T1": (xp1, None, z1, eps1, chain_prior)}.items():
        trace = torch.zeros(srnn_ops.trace_size(), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for e_ in eps_list:
                srnn_ops.srnn_chain(kernel_w, xp_, xq_, z_, e_, trace=trace, **kw)
        torch.cuda.synchronize()
        per_step = srnn_ops.read_trace(trace) / (len(eps_list) * xp_.shape[1]) / 1e3  # us a step
        phase(label, card=card, steps=len(eps_list) * xp_.shape[1], us_per_step=f"{per_step.sum().item():.3f}",
              inputs_us=f"{per_step[:, 0].sum().item():.3f}", products_us=f"{per_step[:, 1].sum().item():.3f}",
              finish_us=f"{per_step[:, 2].sum().item():.3f}", barrier_us=f"{per_step[:, 3].sum().item():.3f}",
              by_stage={n_: f"{v_:.2f}" for n_, v_ in zip(stage_names, per_step.sum(1).tolist())})

    test_s = {False: [], True: []}
    for split in (False, True):
        for _ in range(3 if not split else 2):
            test_s[split].append(test_pass(split)[2])
    gen_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(n_samples=GEN_B, max_timesteps=n_stacks, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    scored = int(x_sl_np.sum())
    phase("time-srnn-test-pass-and-generate", card=card, test_pass_samples=scored,
          test_pass_s=[f"{v:.4f}" for v in test_s[False]], split_eval_s=[f"{v:.4f}" for v in test_s[True]],
          test_samples_per_s=f"{scored / min(test_s[False]):.0f}", generate_stacks=n_stacks,
          generate_s=[f"{v:.4f}" for v in gen_s], ms_per_stack=f"{min(gen_s) * 1e3 / n_stacks:.3f}",
          generate_frames_per_s=f"{GEN_B * n_stacks * S / min(gen_s):.0f}")

    profiled(lambda: test_pass(False), "profile-srnn-test-pass", 1, "pass", card)
    profiled(lambda: model.generate(n_samples=GEN_B, max_timesteps=200,
                                    generator=torch.Generator(device=dev).manual_seed(SEED)),
             "profile-srnn-generate", 200, "stack", card)

    require(not failures, f"SRNN phases failed: {failures}")


def srnn_train_phases(record, smi, dev):
    """Phases 38-41, the SRNN train step at the width of ``experiments/benchmarks.txt:22``: K7-bwd and
    K9-bwd against the float64 twins, three steps of the driver's ``train`` with its annealers, and
    their times. Each check is printed before any raises, so one run shows every number."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, srnn_audio
    from blvm_tpu_torch.models import srnn as srnn_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.ops import srnn as srnn_ops
    from blvm_tpu_torch.training.train_state import TrainState
    from blvm_tpu_torch.training.train_step import make_train_step

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    args = srnn_audio.build_args(SRNN_FLAGS.split())
    targs = argparse_copy(args, epochs=1, lr=3e-4)
    model = srnn_audio.build_model(args)
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    srnn = model.srnn
    d_gru, a_gru, step = srnn.d_forward_recurrent, srnn.a_backward_recurrent, srnn.step
    S, Z, R, H = args.stack_frames, args.latent_size, srnn.r_dim, args.hidden_size
    head = step.prior_net.layers_1
    beta_sd, eps_sd = head.beta, head.epsilon

    # the train batches: 19 utterances of 40k-64k samples a step, each step's lengths drawn again until they
    # fit the --batch_len 64 budget, as the length sampler packs a sum of lengths (the VRNN train slice's)
    rng = np.random.default_rng(args.seed + 38)
    train_batches = []
    for _ in range(3):
        lengths = rng.integers(VRNN_TRAIN_LENGTHS[0], VRNN_TRAIN_LENGTHS[1] + 1, VRNN_TRAIN_B)
        while lengths.sum() > VRNN_BUDGET:
            lengths = rng.integers(VRNN_TRAIN_LENGTHS[0], VRNN_TRAIN_LENGTHS[1] + 1, VRNN_TRAIN_B)
        train_batches.append([(len(train_batches) * VRNN_TRAIN_B + i, synthetic_speech(int(n), rng))
                              for i, n in enumerate(lengths)])
    step_batches = []
    for b_ in train_batches:
        xb_, slb_ = common.make_batch([w for _, w in b_], targs)
        step_batches.append(dict(x=torch.from_numpy(xb_).to(dev), x_sl=torch.from_numpy(slb_).to(dev)))
    x0, sl0 = step_batches[0]["x"], step_batches[0]["x_sl"]
    B0 = VRNN_TRAIN_B
    # the first train step's inputs of K7 (both GRUs) and K9, as the forward computes them
    with torch.no_grad():
        enc0 = srnn.encoder(x0[..., None])  # (19, T', 256)
        T0 = enc0.shape[1]
        stacks0 = torch.ceil(sl0 / S).long()
        mask0 = (torch.arange(T0, device=dev)[None] < stacks0[:, None]).float()
        u0 = torch.cat([torch.zeros_like(enc0[:, :1]), enc0[:, :-1]], dim=1)
        xw_d = u0 @ d_gru.w_ih + d_gru.b_ih
        d_out, _ = d_gru(u0, mask=mask0)
        d0 = torch.cat([torch.zeros(B0, 1, R, device=dev), d_out[:, :-1]], dim=1)
        concat_flip = torch.cat([enc0, d0], dim=-1).flip(1)
        xw_a = concat_flip @ a_gru.w_ih + a_gru.b_ih
        a0 = a_gru(concat_flip, mask=mask0.flip(1))[0].flip(1)
        xp0, xq0, kw0 = srnn_ops.hoist(step.chain_weights(), d0, a0, True)
    kernel_w = [t.detach() for t in kw0]
    covered = int(stacks0.sum())  # the row-steps the lengths cover: past them every gradient is zero
    zeros_r, zeros_z = torch.zeros(B0, R, device=dev), torch.zeros(B0, Z, device=dev)

    # 38. K7-bwd against its twin: the d GRU at the train shape (19 rows, the first step's stacks, its mask),
    # the a GRU (its flipped mask, zeros leading), H = 200 with a given h0 and a zero-length row, one row;
    # a random gradient of h_n in every case. K7-bwd (through GRURecurrenceFunction: K7 in save mode, one
    # K7-bwd launch, the weight GEMMs) and autograd of the f32 twin are both held to autograd of the f64
    # twin: every gradient's largest error, relative to its largest value, at most twice the f32 twin's plus
    # 1e-6, as K8-bwd is held. Then K7-bwd alone against its f64 twin on the same saved f32 tensors
    def k7_grads(xw, w_hh, b_hh, m, h0, g_out, dtype, kernel):
        leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in (xw, w_hh, b_hh, h0)]
        fn = recurrent.gru_recurrence if kernel else recurrent.gru_recurrence_plain
        outs = fn(leaves[0], leaves[1], leaves[2], None if m is None else m.to(dtype), leaves[3])
        return torch.autograd.grad(sum((o * g.to(dtype)).sum() for o, g in zip(outs, g_out)), leaves)

    g_small = torch.Generator().manual_seed(SEED + 38)
    small_w = [((torch.rand(*shape, generator=g_small) * 2 - 1) / 200**0.5).to(dev) for shape in ((200, 600), (600,))]
    small_mask = (torch.arange(60)[None] < torch.tensor([60, 41, 17, 0, 33, 60, 5, 60, 22, 59, 1])[:, None]).float()
    k7_cases = {
        "d_B19": (xw_d, d_gru.w_hh, d_gru.b_hh, mask0, zeros_r),
        "a_flipped_B19": (xw_a, a_gru.w_hh, a_gru.b_hh, mask0.flip(1), zeros_r),
        "H200_given_h0": ((torch.randn(11, 60, 600, generator=g_small) * 0.5).to(dev), *small_w,
                          small_mask.flip(1).to(dev), (torch.randn(11, 200, generator=g_small) * 0.3).to(dev)),
        "B1": (xw_d[:1], d_gru.w_hh, d_gru.b_hh, None, torch.randn(1, R, generator=gen, device=dev) * 0.3),
    }
    for name, (xw, w_hh, b_hh, m, h0) in k7_cases.items():
        B_, T_, G_ = xw.shape
        g_out = [torch.randn(B_, T_, G_ // 3, generator=gen, device=dev), torch.randn(B_, G_ // 3, generator=gen,
                                                                                      device=dev)]
        cuda.reset_launch_counts()
        got = k7_grads(xw, w_hh, b_hh, m, h0, g_out, torch.float32, True)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        twin = k7_grads(xw, w_hh, b_hh, m, h0, g_out, torch.float32, False)
        ref = k7_grads(xw, w_hh, b_hh, m, h0, g_out, torch.float64, False)
        errs, finite, over = held_to_f64(got, twin, ref, ("xw", "w_hh", "b_hh", "h0"))
        expect(finite and not over and (counts["gru_recurrence"], counts["gru_recurrence_bwd"]) == (1, 1),
               f"K7-bwd {name}: launches {counts['gru_recurrence']}/{counts['gru_recurrence_bwd']}, finite {finite}, "
               f"over {over}")
        worst = max(errs, key=lambda k: errs[k][0])
        phase("K7-bwd", case=name, shape=tuple(xw.shape), launches=counts["gru_recurrence_bwd"],
              kernel_max_rel_vs_f64=f"{errs[worst][0]:.3g}", twin_f32_max_rel_vs_f64=f"{max(v[1] for v in errs.values()):.3g}",
              worst=worst, twin_at_worst=f"{errs[worst][1]:.3g}")
        del got, twin, ref
    with torch.no_grad():
        w_hh_d, b_hh_d = d_gru.w_hh.detach(), d_gru.b_hh.detach()
        _, _, saved7 = recurrent.gru_recurrence_save(xw_d, w_hh_d, b_hh_d, mask0, zeros_r)
        g7 = torch.randn(B0, T0, R, generator=gen, device=dev)
        got7 = recurrent.gru_recurrence_backward(w_hh_d, mask0, saved7, g7, None)
        ref7 = recurrent.gru_recurrence_backward_plain(w_hh_d.double(), mask0, saved7.double(), g7.double(), None)
    k7b_err = max((a_.double() - r_).abs().max().item() for a_, r_ in zip(got7, ref7))
    scale = max(r_.abs().max().item() for r_ in ref7)
    expect(k7b_err <= 1e-4 * scale, f"K7-bwd alone vs its f64 twin: {k7b_err} (largest {scale})")
    record["gru_recurrence_bwd"]["max_abs_err"] = k7b_err
    phase("K7-bwd-alone", case="d_B19", max_abs_err_vs_f64=f"{k7b_err:.3g}", largest=f"{scale:.3g}",
          saved_MB=f"{saved7.numel() * 4 / 2**20:.1f}")
    del got7, ref7

    # 39. K9-bwd against its twin the same way: the train shape's hoisted d and a with the residual posterior
    # on and off (off: no gradient for z and enc_sd), H = 200 and Z = 16 (no gradient for enc_mu and
    # prior_sd), one row; then K9-bwd alone against its f64 twin
    def k9_grads(w, xp, xq, z0, eps, g_out, residual, dtype, kernel):
        leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in (xp, xq, z0, *w)]
        fn = srnn_ops.srnn_chain if kernel else srnn_ops.srnn_chain_plain
        outs = fn(leaves[3:], leaves[0], leaves[1], leaves[2], eps.to(dtype), inference=True,
                  residual_posterior=residual, sd_beta=beta_sd, sd_epsilon=eps_sd)
        loss = sum((o * g.to(dtype)).sum() for o, g in zip(outs, g_out) if g is not None)
        return torch.autograd.grad(loss, leaves)

    def k9_small(B_, T_, H_, Z_):
        def u(*shape, fan_in):
            return ((torch.rand(*shape, generator=g_small) * 2 - 1) / fan_in**0.5).to(dev)

        def net():
            return [u(Z_, H_, fan_in=2 * H_ + Z_), u(H_, H_, fan_in=H_), u(H_, fan_in=H_), u(H_, H_, fan_in=H_),
                    u(H_, fan_in=H_), u(H_, 2 * Z_, fan_in=H_), u(2 * Z_, fan_in=H_)]

        return (net() + net(), *((torch.randn(B_, T_, H_, generator=g_small) * 0.5).to(dev) for _ in range(2)),
                (torch.randn(B_, Z_, generator=g_small) * 0.5).to(dev))

    k9_cases = {
        "train_B19_residual": ((kernel_w, xp0, xq0, zeros_z), True, ()),
        "train_B19_plain_posterior": ((kernel_w, xp0, xq0, zeros_z), False, (0, 2)),
        "H200_Z16": (k9_small(11, 60, 200, 16), True, (1, 4)),
        "B1": ((kernel_w, xp0[:1], xq0[:1], torch.randn(1, Z, generator=gen, device=dev) * 0.5), True, ()),
    }
    names9 = ["xp", "xq", "z0"] + [f"w{i}" for i in range(srnn_ops.N_KERNEL_WEIGHTS)]
    for name, ((w, xp, xq, z0), residual, no_grad) in k9_cases.items():
        B_, T_ = xp.shape[:2]
        Z_ = z0.shape[1]
        eps = torch.randn(B_, T_, Z_, generator=gen, device=dev)
        g_out = [None if i in no_grad else torch.randn(B_, T_, Z_, generator=gen, device=dev) for i in range(5)]
        cuda.reset_launch_counts()
        got = k9_grads(w, xp, xq, z0, eps, g_out, residual, torch.float32, True)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        twin = k9_grads(w, xp, xq, z0, eps, g_out, residual, torch.float32, False)
        ref = k9_grads(w, xp, xq, z0, eps, g_out, residual, torch.float64, False)
        errs, finite, over = held_to_f64(got, twin, ref, names9)
        expect(finite and not over and (counts["srnn_chain"], counts["srnn_chain_bwd"]) == (1, 1),
               f"K9-bwd {name}: launches {counts['srnn_chain']}/{counts['srnn_chain_bwd']}, finite {finite}, over {over}")
        worst = max(errs, key=lambda k: errs[k][0])
        phase("K9-bwd", case=name, shape=tuple(xp.shape), Z=Z_, residual_posterior=residual,
              no_gradient=[srnn_ops.SRNNChainOutputs._fields[i] for i in no_grad], launches=counts["srnn_chain_bwd"],
              kernel_max_rel_vs_f64=f"{errs[worst][0]:.3g}", twin_f32_max_rel_vs_f64=f"{max(v[1] for v in errs.values()):.3g}",
              worst=worst, twin_at_worst=f"{errs[worst][1]:.3g}")
        del got, twin, ref
    ragged = mask0[..., None]
    chain_kw = dict(residual_posterior=True, sd_beta=beta_sd)
    with torch.no_grad():
        eps9 = torch.randn(B0, T0, Z, generator=gen, device=dev)
        outs9, saved9 = srnn_ops.srnn_chain_save(kernel_w, xp0, xq0, zeros_z, eps9, sd_epsilon=eps_sd, **chain_kw)
        g9 = [torch.randn(B0, T0, Z, generator=gen, device=dev) * ragged for _ in range(5)]
        got9 = srnn_ops.srnn_chain_backward(kernel_w, eps9, saved9, g9, **chain_kw)
        ref9 = srnn_ops.srnn_chain_backward_plain([t.double() for t in kernel_w], eps9.double(), saved9.double(),
                                                  [g.double() for g in g9], **chain_kw)
    k9b_err = max((a_.double() - r_).abs().max().item() for a_, r_ in zip(got9, ref9))
    scale = max(r_.abs().max().item() for r_ in ref9)
    expect(k9b_err <= 1e-4 * scale, f"K9-bwd alone vs its f64 twin: {k9b_err} (largest {scale})")
    record["srnn_chain_bwd"]["max_abs_err"] = k9b_err
    phase("K9-bwd-alone", case="train_B19_residual", max_abs_err_vs_f64=f"{k9b_err:.3g}", largest=f"{scale:.3g}",
          saved_MB=f"{saved9.numel() * 4 / 2**20:.1f}", dpre_MB=f"{got9[0].numel() * 4 / 2**20:.1f}")
    del got9, ref9
    torch.cuda.empty_cache()

    # 40. the train slice: flags of benchmarks.txt:22 -> driver -> model on the card -> weights bridge ->
    # srnn_audio.train with its annealers, 3 Adam steps on 19 utterances a step; the latent noise from a
    # generator of its own, alike for the kernel and the plain runs
    def seeded_noise(seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return mock.patch.object(srnn_model, "gaussian_noise", lambda _, shape, like: torch.randn(
            shape, generator=g_, device=like.device).to(like.dtype))

    def run_train(plain_path_=False):
        weights.load_jax_params(model, params)
        log = StepLog(Tracker())
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise(SEED + 40):
            cuda.reset_launch_counts()
            t0 = time.time()
            srnn_audio.train(model, targs, train_batches, log)
            torch.cuda.synchronize()
            return log.steps, cuda.launch_counts(), time.time() - t0

    steps_k, counts, seconds = run_train()
    steps_p, counts_p, seconds_p = run_train(plain_path_=True)
    expected = dict(gru_recurrence=6, gru_recurrence_bwd=6, srnn_chain=3, srnn_chain_bwd=3, dmol_log_prob=3,
                    dmol_log_prob_bwd=3, dmol_sample=3)
    expect(counts == {**dict.fromkeys(counts, 0), **expected},
           f"SRNN train-step launches {counts}, expected {expected} (2/2/1/1/1/1/1 a step)")
    expect(not any(counts_p.values()), f"the plain SRNN train path launched kernels: {counts_p}")
    for k in ("gru_recurrence", "srnn_chain"):
        record[k]["launches"] = record[k].get("launches", 0) + counts[k]
    record["gru_recurrence_bwd"]["launches"] = counts["gru_recurrence_bwd"]
    record["srnn_chain_bwd"]["launches"] = counts["srnn_chain_bwd"]
    losses, losses_p = [st["loss"] for st in steps_k], [st["loss"] for st in steps_p]
    loss_rel = [abs(a_ - b_) / abs(b_) for a_, b_ in zip(losses, losses_p)]
    expect(all(math.isfinite(v) for st in steps_k for v in st.values()), f"SRNN train metrics not finite: {steps_k}")
    # step 0: the same parameters, only the sums' order differs (1e-5). Later steps: Adam's first updates move
    # every parameter by about lr sign(g), so a gradient element near zero whose sign the summation order
    # flips moves by 2 lr: 1e-4
    expect(loss_rel[0] <= 1e-5 and max(loss_rel) <= 1e-4, f"SRNN train losses {losses} vs plain {losses_p}")
    ref_annealers = srnn_audio.build_annealers(targs)
    ref_values = [{k: float(np.float32(a.step())) for k, a in ref_annealers.items()} for _ in range(3)]
    got_values = [{k: st[k] for k in ("beta", "free_nats")} for st in steps_k]
    expect(got_values == ref_values and got_values[0] == dict(beta=0.0, free_nats=2.0),
           f"annealers {got_values}, expected {ref_values}")
    phase("srnn-train-slice", steps=3, utterances_per_step=VRNN_TRAIN_B,
          samples_per_step=[sum(len(w) for _, w in b_) for b_ in train_batches],
          stacks_per_step=[int(torch.ceil(b_["x_sl"].max() / S)) for b_ in step_batches],
          losses=[f"{v:.6f}" for v in losses], losses_plain=[f"{v:.6f}" for v in losses_p],
          loss_rel=[f"{v:.3g}" for v in loss_rel], beta=[v["beta"] for v in got_values],
          free_nats=[v["free_nats"] for v in got_values], launches_per_step={k: v // 3 for k, v in counts.items() if v},
          seconds=f"{seconds:.2f}", seconds_plain=f"{seconds_p:.2f}")

    # the step-0 gradients of every parameter at beta 1 and free nats 2 (every gradient path live): the
    # kernels and the f32 twins both held to the f64 twins, the kernels no further than twice the f32 twins
    # plus 1e-6 (relative norms)
    def step0_grads(m, plain_path_, dtype):
        m.zero_grad(set_to_none=True)
        m.train()
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise(SEED + 41):
            loss, _, _ = m(x0.to(dtype), sl0, beta=1.0, free_nats=2.0,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
            loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return grads, loss.item()

    weights.load_jax_params(model, params)
    g_k, loss_k = step0_grads(model, False, torch.float32)
    g_p, loss_p = step0_grads(model, True, torch.float32)
    model64 = copy.deepcopy(model).double()
    g_64, loss_64 = step0_grads(model64, True, torch.float64)
    del model64
    e_k = {n: rel_norm(g_k[n], g_64[n]) for n in g_64}
    e_p = {n: rel_norm(g_p[n], g_64[n]) for n in g_64}
    over = {n: (e_k[n], e_p[n]) for n in e_k if e_k[n] > 2 * e_p[n] + 1e-6}
    expect(all(torch.isfinite(g_).all() for g_ in g_k.values()) and not over, f"SRNN step-0 gradients: {over}")
    worst = max(e_k, key=e_k.get)
    phase("srnn-train-grads", loss=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}", loss_f64=f"{loss_64:.6f}",
          kernel_max_rel_vs_f64=f"{e_k[worst]:.3g}", twin_f32_max_rel_vs_f64=f"{max(e_p.values()):.3g}", worst=worst,
          kernel_vs_twin_max_rel=f"{max(rel_norm(g_k[n], g_p[n]) for n in g_p):.3g}", parameters=len(e_k))
    del g_k, g_p, g_64
    torch.cuda.empty_cache()

    # 41. times, CUDA events, a different input each call, kernel and twin in turns: K7 and K9 in save mode
    # against the plain launch at the train shape (bitwise equal outputs); K7-bwd and K9-bwd alone against
    # their twins, cuDNN's torch.nn.GRU backward (unmasked, with its input projection's gradients: the
    # yardstick; the port never calls it), the kernels' traces by stage; the GRU's and the chain's backward
    # (the kernel and the weight GEMMs) and the train step, each against one call of the twins' path (warm
    # from phases 38-40: a twin step takes seconds); the step's host enqueue time and a torch.profiler
    # breakdown
    xws = [xw_d + 0.01 * torch.randn(xw_d.shape, generator=gen, device=dev) for _ in range(3)]

    def k7_plain_launch(xw):
        with torch.no_grad():
            return recurrent.gru_recurrence(xw, w_hh_d, b_hh_d, mask0, zeros_r)

    def k7_save(xw):
        with torch.no_grad():
            return recurrent.gru_recurrence_save(xw, w_hh_d, b_hh_d, mask0, zeros_r)

    same7 = all(torch.equal(a_, b_) for a_, b_ in zip(k7_plain_launch(xws[0]), k7_save(xws[0])[:2]))
    t7s = alternate(k7_plain_launch, k7_save, xws)
    expect(same7, "K7's save mode changed its outputs")
    phase("time-K7-save", card=card, shape=f"({B0},{T0},{3 * R})", dtype="f32", bitwise_equal=same7,
          save_ms=f"{t7s['kernel']:.4f}", no_save_ms=f"{t7s['plain']:.4f}",
          us_per_step_save=f"{t7s['kernel'] * 1e3 / T0:.3f}", ratio=f"{t7s['kernel'] / t7s['plain']:.4f}")
    eps_t = [torch.randn(B0, T0, Z, generator=gen, device=dev) for _ in range(3)]

    def k9_plain_launch(e_):
        with torch.no_grad():
            return srnn_ops.srnn_chain(kernel_w, xp0, xq0, zeros_z, e_, inference=True, sd_epsilon=eps_sd, **chain_kw)

    def k9_save(e_):
        with torch.no_grad():
            return srnn_ops.srnn_chain_save(kernel_w, xp0, xq0, zeros_z, e_, sd_epsilon=eps_sd, **chain_kw)

    same9 = all(torch.equal(a_, b_) for a_, b_ in zip(k9_plain_launch(eps_t[0]), k9_save(eps_t[0])[0]))
    t9s = alternate(k9_plain_launch, k9_save, eps_t)
    expect(same9, "K9's save mode changed its outputs")
    phase("time-K9-save", card=card, shape=f"({B0},{T0})", dtype="f32", bitwise_equal=same9,
          save_ms=f"{t9s['kernel']:.4f}", no_save_ms=f"{t9s['plain']:.4f}",
          us_per_step_save=f"{t9s['kernel'] * 1e3 / T0:.3f}", ratio=f"{t9s['kernel'] / t9s['plain']:.4f}")

    def print_trace(label, trace, steps, stage_names):
        per_step = srnn_ops.read_trace(trace) / steps / 1e3  # us a step
        phase(label, card=card, steps=steps, us_per_step=f"{per_step.sum().item():.3f}",
              inputs_us=f"{per_step[:, 0].sum().item():.3f}", products_us=f"{per_step[:, 1].sum().item():.3f}",
              finish_us=f"{per_step[:, 2].sum().item():.3f}", barrier_us=f"{per_step[:, 3].sum().item():.3f}",
              by_stage={n_: f"{v_:.2f}" for n_, v_ in zip(stage_names, per_step.sum(1).tolist())})

    def backward_only(graph):
        outputs, inputs, grad_outputs = graph
        return torch.autograd.grad(outputs, inputs, grad_outputs, retain_graph=True)

    # K7-bwd: the d GRU's saved forward, a different output gradient each call (zero past each row's end)
    g7s = [torch.randn(B0, T0, R, generator=gen, device=dev) * ragged for _ in range(3)]

    def k7b(g_, trace=None):
        return recurrent.gru_recurrence_backward(w_hh_d, mask0, saved7, g_, None, trace=trace)

    def k7b_plain(g_):
        return recurrent.gru_recurrence_backward_plain(w_hh_d, mask0, saved7, g_, None)

    t7b = alternate(k7b_plain, k7b, g7s, warmup=1)

    def gru_graph(fn, g_):
        leaves = [t.detach().clone().requires_grad_(True) for t in (xw_d, w_hh_d, b_hh_d)]
        out_ = fn(leaves[0], leaves[1], leaves[2], mask0, zeros_r)[0]
        return (out_,), leaves, (g_,)

    pair = [(gru_graph(recurrent.gru_recurrence_plain, g7s[0]), gru_graph(recurrent.gru_recurrence, g7s[0]))]
    t7_fn = dict(plain=cuda_time_ms(lambda g_: backward_only(g_[0]), pair, warmup=0)[0],
                 kernel=sorted(cuda_time_ms(lambda g_: backward_only(g_[1]), pair * 3, warmup=1))[1])
    del pair
    cudnn = torch.nn.GRU(d_gru.w_ih.shape[0], R, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(d_gru.w_ih.T)
        cudnn.weight_hh_l0.copy_(d_gru.w_hh.T)
        cudnn.bias_ih_l0.copy_(d_gru.b_ih)
        cudnn.bias_hh_l0.copy_(d_gru.b_hh)

    def lib_graph(g_):
        leaves = [u0.detach().clone().requires_grad_(True)] + list(cudnn.parameters())
        return (cudnn(leaves[0])[0],), leaves, (g_,)

    def layer_graph(g_):
        """Our layer as cuDNN's autograd sees it: the input projection and K7, differentiated by the input
        and all four parameters (unmasked, as cuDNN's here)."""
        leaves = [t.detach().clone().requires_grad_(True) for t in (u0, d_gru.w_ih, d_gru.b_ih, w_hh_d, b_hh_d)]
        out_ = recurrent.gru_recurrence(leaves[0] @ leaves[1] + leaves[2], leaves[3], leaves[4], None, zeros_r)[0]
        return (out_,), leaves, (g_,)

    lib_pairs = [(lib_graph(g_), layer_graph(g_)) for g_ in g7s]
    t7_lib = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), lib_pairs)
    del lib_pairs
    trace7 = torch.zeros(recurrent.gru_bwd_trace_size(), dtype=torch.int64, device=dev)
    for g_ in g7s:
        k7b(g_, trace=trace7)
    torch.cuda.synchronize()
    G = 3 * R
    rows = B0 * T0
    # bytes: W_hh read; a row-step's saved values (5R), mask and output gradient (R) read, d gi and d gh
    # (2 x 3R) written; d h0. Operations: d gh W_hh^T over the row-steps the lengths cover
    record["gru_recurrence_bwd"].update(ms=t7b["kernel"], plain_ms=t7b["plain"], library_ms=t7_lib["plain"], **roofline(
        bytes_=4 * (R * G + rows * (5 * R + 1 + R + 2 * G) + B0 * R), flops=2 * covered * G * R, peak=F32_PEAK))
    phase("time-K7-bwd", card=card, shape=f"({B0},{T0},{G})", dtype="f32", kernel_ms=f"{t7b['kernel']:.4f}",
          plain_ms=f"{t7b['plain']:.4f}", us_per_step=f"{t7b['kernel'] * 1e3 / T0:.3f}",
          gru_backward_ms=f"{t7_fn['kernel']:.4f}", twin_autograd_ms=f"{t7_fn['plain']:.4f}",
          layer_backward_ms=f"{t7_lib['kernel']:.4f}", cudnn_gru_backward_ms=f"{t7_lib['plain']:.4f}",
          bound_ms=f"{record['gru_recurrence_bwd']['bound_ms']:.4f}", bound_by=record["gru_recurrence_bwd"]["bound_by"],
          includes="kernel: K7-bwd alone; gru backward: also dW_hh, db_hh; layer and cuDNN: also dx, dW_ih, db_ih")
    print_trace("K7-bwd-trace", trace7, len(g7s) * T0, ("gates", "dh"))

    # K9-bwd: the first step's saved chain, a different set of output gradients each call
    g9s = [[torch.randn(B0, T0, Z, generator=gen, device=dev) * ragged for _ in range(5)] for _ in range(3)]

    def k9b(g_, trace=None):
        return srnn_ops.srnn_chain_backward(kernel_w, eps9, saved9, g_, trace=trace, **chain_kw)

    def k9b_plain(g_):
        return srnn_ops.srnn_chain_backward_plain(kernel_w, eps9, saved9, g_, **chain_kw)

    t9b = alternate(k9b_plain, k9b, g9s, warmup=1)

    def chain_graph(kernel, g_):
        leaves = [t.detach().clone().requires_grad_(True) for t in (xp0, xq0, *kernel_w)]
        fn = srnn_ops.srnn_chain if kernel else srnn_ops.srnn_chain_plain
        outs = fn(leaves[2:], leaves[0], leaves[1], zeros_z, eps9, inference=True, sd_epsilon=eps_sd, **chain_kw)
        return tuple(outs), leaves, tuple(g_)

    pair = [(chain_graph(False, g9s[0]), chain_graph(True, g9s[0]))]
    t9_fn = dict(plain=cuda_time_ms(lambda g_: backward_only(g_[0]), pair, warmup=0)[0],
                 kernel=sorted(cuda_time_ms(lambda g_: backward_only(g_[1]), pair * 3, warmup=1))[1])
    del pair
    trace9 = torch.zeros(srnn_ops.trace_size(), dtype=torch.int64, device=dev)
    for g_ in g9s:
        k9b(g_, trace=trace9)
    torch.cuda.synchronize()
    n_kernel = sum(t.numel() for t in kernel_w if t.ndim == 2)  # the eight kernels (the biases are not read)
    macs9 = 2 * (Z * H + 2 * H * H + H * 2 * Z)  # a row-step of both nets: z rows, L2, L3, the heads
    # bytes: the kernels read; a row-step's noise, saved values (6H + 2Z) and five output gradients read, its
    # pre-activation gradients (4Z + 6H) written; d z0. Operations over the row-steps the lengths cover
    record["srnn_chain_bwd"].update(ms=t9b["kernel"], plain_ms=t9b["plain"], **roofline(
        bytes_=4 * (n_kernel + rows * (Z + 6 * H + 2 * Z + 5 * Z + 4 * Z + 6 * H) + B0 * Z),
        flops=2 * covered * macs9, peak=F32_PEAK))
    phase("time-K9-bwd", card=card, shape=f"({B0},{T0})", H=H, Z=Z, dtype="f32", kernel_ms=f"{t9b['kernel']:.4f}",
          plain_ms=f"{t9b['plain']:.4f}", us_per_step=f"{t9b['kernel'] * 1e3 / T0:.3f}",
          chain_backward_ms=f"{t9_fn['kernel']:.4f}", twin_autograd_ms=f"{t9_fn['plain']:.4f}",
          bound_ms=f"{record['srnn_chain_bwd']['bound_ms']:.4f}", bound_by=record["srnn_chain_bwd"]["bound_by"],
          includes="kernel: K9-bwd alone; chain backward: also the 14 weight-gradient GEMMs and the bias product")
    print_trace("K9-bwd-trace", trace9, len(g9s) * T0, ("z+heads", "L3", "L2", "L1"))
    del g7s, g9s, saved7, saved9, outs9

    # the train step, kernels against twins in turns on the first batch, the kernels alone over the three
    tx, _ = common.build_tx_and_lr(targs)
    weights.load_jax_params(model, params)
    model.train()
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(common.loss_fn)
    scalars = dict(beta=torch.tensor(0.5), free_nats=torch.tensor(2.0))

    def run_step(b_):
        train_step(state, b_, scalars)

    def run_step_plain(b_):
        with plain():
            train_step(state, b_, scalars)

    plain_step_ms = cuda_time_ms(run_step_plain, step_batches[:1], warmup=0)[0]
    torch.cuda.reset_peak_memory_stats()
    ts = sorted(cuda_time_ms(run_step, step_batches))[1]
    torch.cuda.synchronize()
    enqueue = []
    for b_ in step_batches:
        t0 = time.perf_counter()
        run_step(b_)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    samples = sum(int(b_["x_sl"].sum()) for b_ in step_batches) / len(step_batches)
    phase("time-srnn-train-step", card=card, utterances=VRNN_TRAIN_B, samples=int(samples), kernel_ms=f"{ts:.3f}",
          plain_ms=f"{plain_step_ms:.3f}",
          host_enqueue_ms=f"{sorted(enqueue)[1]:.3f}", samples_per_s=f"{samples / ts * 1e3:.0f}",
          peak_memory_GB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b_ in step_batches:
            run_step(b_)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    kernels_ = device_kernels(prof)
    busy_ms = sum(device_us(e_) for e_ in kernels_) / 1e3 / 3
    phase("profile-srnn-train-step", card=card, device_ms_per_step=f"{busy_ms:.3f}", wall_ms_per_step=f"{wall_ms:.3f}",
          idle_share=f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured",
          kernel_launches_per_step=sum(e_.count for e_ in kernels_) // 3)
    for e_ in sorted(kernels_, key=device_us, reverse=True)[:12]:
        print(f"  {device_us(e_) / 1e3 / 3:9.3f} ms/step {e_.count // 3:5d} calls/step  {e_.key[:90]}", flush=True)
    skip_checks("srnn", srnn_audio, model, params, targs, train_batches, train_step, step_batches, scalars, dev, expect)

    require(not failures, f"SRNN train phases failed: {failures}")


def stcn_phases(record, smi, dev):
    """Phases 42-46, STCN's serving path at the width of ``experiments/benchmarks.txt:26`` (s = 1,
    z = [256, 128, 64, 32, 16], 256 channels, 5 x 5 encoder blocks, a 5-block decode stack, f32): K1 at
    STCN's width against its twin, the test pass whole and rf-chunked, K12 against the plain frame loop
    and the fast path against the windowed one, generation through the driver's hook, and their times.
    Each check is printed before any raises, so one run shows every number."""
    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, stcn_audio
    from blvm_tpu_torch.models import stcn as stcn_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.ops.generation import STCNDecoder

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    args = stcn_audio.build_args(STCN_FLAGS.split())
    model = stcn_audio.build_model(args)
    require(next(model.parameters()).device.type == "cuda", "stcn_audio.build_model did not build on the card")
    weights.load_jax_params(model, weights.random_jax_params(model, args.seed))
    model.eval()
    C, rf = args.hidden_size, model.receptive_field
    block_names = ("gate_kernel_t", "gate_kernel_s", "gate_bias_t", "gate_bias_s", "rs_kernel", "rs_bias")

    def block_weights(i, dtype=torch.float32):
        b = model.res_stack.blocks[i]
        return [getattr(b, n).detach().to(dtype) for n in block_names]

    # 42. K1 at STCN's width against its twin, f32 and bf16, B = 6 at the test pass's first-block length: the
    # used blocks' weights (dilation 16) and the first block's (dilation 1), with the skip at skip_size = all
    # rows and = the last 1000, and skip-free; phase 4's tolerances (f32: the FMA order against cuBLAS's over
    # 512- and 256-term sums, 1e-5 + 1e-5 |twin|; bf16: two ulps plus 5e-2)
    T_in = STCN_T + rf - 1
    k1_tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0**-6, 5e-2)}
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(STCN_B, T_in, C, generator=gen, device=dev).to(dtype)
        for block, d in ((0, 1), (4, 16)):
            w = block_weights(block, dtype)
            for need_skip, skip in ((True, T_in - d), (True, 1000), (False, 0)):
                o, s_ = modules.residual_glu(x, *w, dilation=d, skip_size=skip, need_skip=need_skip)
                torch.cuda.synchronize()
                o_ref, s_ref = modules.residual_glu_plain(x, *w, dilation=d, skip_size=skip, need_skip=need_skip)
                rtol, atol = k1_tol[dtype]
                errs = []
                for got, ref in ((o, o_ref), (s_, s_ref)):
                    if ref is None:
                        expect(got is None, f"K1-stcn skip-free returned a skip {type(got)}")
                        continue
                    err = (got.float() - ref.float()).abs()
                    ok = got.shape == ref.shape and bool(torch.isfinite(got).all())
                    expect(ok and (err - (atol + rtol * ref.float().abs())).max().item() <= 0,
                           f"K1-stcn {dtype} d={d} skip={skip}: max err {err.max().item()}")
                    errs.append(err.max().item())
                k1_err = max(k1_err, *errs)
                phase("K1-stcn", dtype=str(dtype).split(".")[1], dilation=d, need_skip=need_skip, skip_rows=skip,
                      max_abs_err=f"{max(errs):.3g}")
        del x, o, s_, o_ref, s_ref
    record["residual_glu"]["max_abs_err"] = max(record["residual_glu"].get("max_abs_err", 0.0), k1_err)

    # 43. the test pass: flags of benchmarks.txt:26 -> driver -> model on the card -> weights bridge, the 6
    # utterances of the SRNN phases' geometry (24k-72k samples), whole and --split_eval (chunks of 1000 with
    # the receptive field's overlap), kernels against the twins fed the same latent noise
    rng = np.random.default_rng(args.seed + 43)
    lengths = rng.integers(STCN_T // 3, STCN_T + 1, STCN_B)
    lengths[0] = STCN_T
    x_np, x_sl_np = common.make_batch([synthetic_speech(int(n), rng) for n in lengths], args)
    n_chunks = len(model.split_sequence(x_np, x_sl_np, length=args.random_segment_size)[0])

    def seeded_noise():
        g_ = torch.Generator(device=dev).manual_seed(SEED + 43)
        return mock.patch.object(stcn_model, "gaussian_noise",
                                 lambda _, shape, like: torch.randn(shape, generator=g_, dtype=like.dtype,
                                                                    device=like.device))

    def test_pass(split, plain_path_=False):
        counting, tally = counting_glu(modules)
        with plain() if plain_path_ else counting, seeded_noise():
            cuda.reset_launch_counts()
            t0 = time.time()
            values = stcn_audio.evaluate(model, argparse_copy(args, split_eval=split), [(x_np, x_sl_np)], Tracker(),
                                         generator=torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            return values, cuda.launch_counts(), tally["skip_free"], time.time() - t0

    path_k1 = 0
    passes = {}
    levels = len(args.latent_size)
    compared = ["loss", "elbo (bpx)", "rec (bpx)", "kl (nats)", *[f"kl_{l} (nats)" for l in range(levels)]]
    for split in (False, True):
        values, counts, skip_free, seconds = test_pass(split)
        values_p, counts_p, _, seconds_p = test_pass(split, plain_path_=True)
        forwards = n_chunks if split else 1
        expected = dict(residual_glu=30 * forwards, dmol_log_prob=forwards, dmol_sample=forwards)
        expect(counts == {**dict.fromkeys(counts, 0), **expected} and skip_free == 20 * forwards,
               f"STCN test pass split={split}: launches {counts} ({skip_free} skip-free), expected {expected}")
        expect(not any(counts_p.values()), f"the plain STCN test pass launched kernels: {counts_p}")
        path_k1 += counts["residual_glu"]
        rel = {k: abs(values[k] - values_p[k]) / max(abs(values_p[k]), 1e-30) for k in compared}
        finite = all(math.isfinite(values[k]) for k in compared)
        # f32 throughout: only the summation orders of K1, K2 and the products differ
        expect(finite and max(rel.values()) <= 1e-5, f"STCN test pass split={split}: {values} vs twins {values_p}")
        passes[split] = values
        phase("stcn-test-pass", split_eval=split, utterances=list(map(int, lengths)), forwards=forwards,
              loss=f"{values['loss']:.6f}", elbo_bpx=f"{values['elbo (bpx)']:.6f}",
              elbo_bpx_plain=f"{values_p['elbo (bpx)']:.6f}", rec_bpx=f"{values['rec (bpx)']:.6f}",
              kl_nats=f"{values['kl (nats)']:.3f}", kl_levels=[f"{values[f'kl_{l} (nats)']:.3f}" for l in range(levels)],
              max_rel_vs_twins=f"{max(rel.values()):.3g}", launches_per_forward={k: v // forwards for k, v in counts.items() if v},
              skip_free_per_forward=skip_free // forwards, seconds=f"{seconds:.2f}", plain_seconds=f"{seconds_p:.2f}")
    # the chunks score the same frames; what differs is each later chunk's decode stack, which starts from
    # zeros (its left padding) where the whole pass has the previous frames' z, as JAX's chunking does: held
    # to 1 % of the bits/frame
    chunk_rel = {k: abs(passes[True][k] - passes[False][k]) / abs(passes[False][k]) for k in ("elbo (bpx)", "rec (bpx)")}
    expect(max(chunk_rel.values()) <= 1e-2, f"STCN chunked vs whole: {chunk_rel}")
    phase("stcn-chunked-vs-whole", elbo_bpx_chunked=f"{passes[True]['elbo (bpx)']:.6f}",
          elbo_bpx_whole=f"{passes[False]['elbo (bpx)']:.6f}", rel={k: f"{v:.3g}" for k, v in chunk_rel.items()})

    # 44. K12 (one launch for all frames) against the plain frame loop over 256 frames, from a zero history and a
    # speech prefix, fed the same prior noise and uniforms. Teacher-forced (the loop fed K12's frames): each
    # frame's z and DMoL parameters within the order of the sums, 1e-5 + 1e-5 |twin|; free-running, every frame
    # within the same (and the share within 1e-5 reported). Two launches give the same bits.
    speech, _ = common.make_batch([synthetic_speech(rf, rng) for _ in range(GEN_B)], args)  # mu-law coded
    histories = {"zero": None, "speech": torch.from_numpy(speech).to(dev)}
    k12_err = 0.0
    with torch.no_grad():
        for name, hist in histories.items():
            window = model._window(GEN_B, hist)
            enc_tails, dec_tails, d0 = model._prime(window)
            eps = torch.randn(N_K12, GEN_B, sum(args.latent_size), generator=gen, device=dev)
            keys = variational.FrameKeys(None, dev, (torch.rand(N_K12, GEN_B, 10, generator=gen, device=dev),
                                                     torch.rand(N_K12, GEN_B, 1, generator=gen, device=dev)))
            fixed = (window[:, -1:], d0, enc_tails, dec_tails, N_K12, eps, keys)
            cuda.reset_launch_counts()
            x_k, z_k, p_k = STCNDecoder(model, enc_tails, dec_tails).run(window[:, -1, 0], d0, N_K12, eps, keys,
                                                                           record=True)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["stcn_decode"]
            again = STCNDecoder(model, enc_tails, dec_tails).run(window[:, -1, 0], d0, N_K12, eps, keys, record=True)
            expect(all(torch.equal(a, b) for a, b in zip((x_k, z_k, p_k), again)), f"K12 {name}: two runs differ")
            x_t, z_t, p_t = model._generate_fast_plain(*fixed, forced=x_k)
            x_f, _, _ = model._generate_fast_plain(*fixed)
            errs = {}
            for label, got, ref in (("z", z_k, z_t), ("params", p_k, p_t), ("frames", x_k, x_t),
                                    ("free-running frames", x_k, x_f)):
                err = (got - ref).abs()
                errs[label] = err.max().item()
                expect(bool(torch.isfinite(got).all()) and bool((err <= 1e-5 + 1e-5 * ref.abs()).all()),
                       f"K12 {name} {label}: max err {errs[label]}")
            k12_err = max(k12_err, *(v for k, v in errs.items() if not k.startswith("free")))
            share = ((x_k - x_f).abs() <= 1e-5).double().mean().item()
            expect(launches == 1, f"K12 launches {launches} for {N_K12} frames")
            phase("K12", history=name, frames=N_K12, launches=launches,
                  max_abs_err={k: f"{v:.3g}" for k, v in errs.items()}, free_running_share_within_1e5=f"{share:.4f}")
    record["stcn_decode"]["max_abs_err"] = k12_err

    # the fast path (K12, one launch) against the windowed one (K1 x 30 and K3 a frame) over 16 frames, from one
    # generator state and the same prior noise: one Philox key a generation, stepped by the frame, so both
    # draw the same numbers for the same frame (f32, 1e-5)
    for name, hist in histories.items():
        eps16 = torch.randn(N_NAIVE, GEN_B, sum(args.latent_size), generator=gen, device=dev)
        outs, counts = {}, {}
        for fast in (True, False):
            cuda.reset_launch_counts()
            (outs[fast], _), _ = model.generate(GEN_B, N_NAIVE, x=hist, fast=fast, eps=eps16,
                                                generator=torch.Generator(device=dev).manual_seed(SEED + 44))
            counts[fast] = {k: v for k, v in cuda.launch_counts().items() if v}
        err = (outs[True] - outs[False]).abs().max().item()
        expect(err <= 1e-5 and counts[True] == dict(residual_glu=30, stcn_decode=1)
               and counts[False] == dict(residual_glu=30 * N_NAIVE, dmol_sample=N_NAIVE),
               f"STCN fast vs windowed {name}: err {err}, launches {counts}")
        phase("stcn-fast-vs-windowed", history=name, frames=N_NAIVE, max_abs_err=f"{err:.3g}",
              fast_launches=counts[True], windowed_launches=counts[False])

    # 45. generation through the driver's hook: 2 x 16000 frames, K12 once a generation, K1 30 times (the primes)
    out_dir = Path(__file__).resolve().parent / "blvm_tpu_torch" / "_build" / "stcn_generation_hook"
    hook = stcn_audio.make_generation_hook(model, argparse_copy(args, generate_every=5))
    cuda.reset_launch_counts()
    t0 = time.time()
    paths = hook(5, out_dir)
    torch.cuda.synchronize()
    hook_s = time.time() - t0
    counts = cuda.launch_counts()
    expected = dict(residual_glu=30, stcn_decode=1)
    expect(counts == {**dict.fromkeys(counts, 0), **expected}, f"STCN generation launches {counts}, expected {expected}")
    path_k1 += counts["residual_glu"]
    shapes = []
    for path in paths:
        with wave.open(str(path)) as f:
            shapes.append((f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()))
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        expect(shapes[-1] == (1, 2, 16000, args.generate_frames) and np.abs(pcm).max() > 0,
               f"STCN hook wav {path}: {shapes[-1]}")
    expect(len(paths) == 2, f"STCN hook wrote {paths}")
    phase("stcn-generation-hook", frames=args.generate_frames, launches=counts, seconds=f"{hook_s:.2f}",
          frames_per_s=f"{GEN_B * args.generate_frames / hook_s:.1f}",
          files=[str(p_.relative_to(out_dir.parents[2])) for p_ in paths], wav=shapes)
    record["residual_glu"]["launches"] = record["residual_glu"].get("launches", 0) + path_k1
    record["stcn_decode"]["launches"] = counts["stcn_decode"]

    # 46. times, CUDA events, a different input each call, kernel and twin in turns: K1 at STCN's width (a
    # used block with its skip, the first block skip-free), K12 a frame against the plain loop and the
    # windowed path a frame, the test pass, a generation, torch.profiler breakdowns of both
    xs = [torch.randn(STCN_B, T_in, C, generator=gen, device=dev) for _ in range(3)]
    for label, block, d, skip, need_skip in (("skip", 4, 16, STCN_T + 1, True), ("skip_free", 0, 1, 0, False)):
        w = block_weights(block)
        t = alternate(lambda x_: modules.residual_glu_plain(x_, *w, dilation=d, skip_size=skip, need_skip=need_skip),
                      lambda x_: modules.residual_glu(x_, *w, dilation=d, skip_size=skip, need_skip=need_skip), xs,
                      warmup=1)
        bound = roofline(**residual_glu_work(STCN_B, T_in, C, C, C if need_skip else 0, d, skip), peak=F32_PEAK)
        record["residual_glu"].update({f"stcn_{label}_ms": t["kernel"], f"stcn_{label}_plain_ms": t["plain"],
                                       f"stcn_{label}_bound_ms": bound["bound_ms"]})
        tflops = residual_glu_work(STCN_B, T_in, C, C, C if need_skip else 0, d, skip)["flops"] / t["kernel"] / 1e9
        phase("time-K1-stcn", card=card, mode=label, shape=f"({STCN_B},{T_in},{C})", dilation=d, dtype="f32",
              kernel_ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}", bound_ms=f"{bound['bound_ms']:.4f}",
              bound_by=bound["bound_by"], tflops=f"{tflops:.2f}")
    del xs

    window = model._window(GEN_B, None)
    with torch.no_grad():
        enc_tails, dec_tails, d0 = model._prime(window)
    eps_t = torch.randn(N_GEN, GEN_B, sum(args.latent_size), generator=gen, device=dev)
    keys_t = variational.FrameKeys(gen, dev)

    def k12_run(n, trace=None):
        """K12 over n frames: its time a frame by CUDA events, and the host's time in the wrapper a frame (the
        launch and the one wait for the status word)."""
        with torch.no_grad():
            decoder = STCNDecoder(model, enc_tails, dec_tails)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            decoder.run(window[:, -1, 0], d0, n, eps_t[:n], keys_t, trace=trace)
            end.record()
            host = time.perf_counter() - t0
            end.synchronize()
            return start.elapsed_time(end) / n, host * 1e3 / n

    def plain_frame_ms(n):
        keys_p = variational.FrameKeys(gen, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model._generate_fast_plain(window[:, -1:], d0, enc_tails, dec_tails, n, eps_t[:n], keys_p)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def windowed_frame_ms(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(GEN_B, n, fast=False, eps=eps_t[:n], generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    k12_run(50)  # warm-up
    # where a frame's time goes inside K12: its own trace (SM cycles of CTA 0's thread 0 by phase, summed over
    # every product of 2000 frames, converted at the launch's clock rate): the waits for inputs and the frames'
    # barriers, the waits for streamed weights, the sums, the finishes, the head, the whole launch
    n_trace = 2000
    trace = torch.zeros(7, dtype=torch.int64, device=dev)
    with torch.no_grad():
        STCNDecoder(model, enc_tails, dec_tails).run(window[:, -1, 0], d0, n_trace, eps_t[:n_trace], keys_t,
                                                     trace=trace)
    cyc = trace.tolist()
    us = [c / max(cyc[5], 1) * cyc[6] / 1e3 / n_trace for c in cyc[:6]]  # each phase's share of the launch's time
    phase("K12-trace", card=card, frames=n_trace, us_per_frame={name: f"{v:.2f}" for name, v in zip(
        ("waits", "weights", "products", "finish", "head", "launch"), us)},
          clock_ghz=f"{cyc[5] / max(cyc[6], 1):.3f}")
    plain_a = plain_frame_ms(32)
    k12 = {n: [k12_run(n) for _ in range(2)] for n in (2000, N_GEN)}
    plain_b = plain_frame_ms(32)
    naive = windowed_frame_ms(N_NAIVE_TIME)
    # the bound of a frame from what the 16000-frame launch moves (every weight once, each slot once), and the
    # per-frame design's yardstick (every weight every frame) beside it for before and after
    enc_dilations = [b.dilation for b in model.res_stack.blocks]
    work, legacy = (stcn_frame_work(GEN_B, C, C, C, enc_dilations, levels, len(model.out_transform.blocks),
                                    args.latent_size, 30, frames) for frames in (N_GEN, 1))
    bound = roofline(**work, peak=F32_PEAK)
    legacy_ms = legacy["bytes_"] / HBM_BYTES_PER_S * 1e3
    k12_ms = min(ms for ms, _ in k12[N_GEN])
    record["stcn_decode"].update(ms=k12_ms, plain_ms=min(plain_a, plain_b), legacy_bytes_ms=legacy_ms, **bound)
    phase("time-K12", card=card, sequences=GEN_B, ms_per_frame={n: [f"{ms:.5f}" for ms, _ in v] for n, v in k12.items()},
          host_ms_per_frame={n: [f"{h:.5f}" for _, h in v] for n, v in k12.items()},
          plain_loop_ms_per_frame=[f"{plain_a:.3f}", f"{plain_b:.3f}"], windowed_ms_per_frame=f"{naive:.3f}",
          bound_ms=f"{bound['bound_ms']:.7f}", bound_by=bound["bound_by"],
          bytes_ms=f"{work['bytes_'] / HBM_BYTES_PER_S * 1e3:.7f}",
          operations_ms=f"{work['flops'] / F32_PEAK * 1e3:.7f}", times_bound=f"{k12_ms / bound['bound_ms']:.1f}",
          legacy_bytes_ms=f"{legacy_ms:.5f}", times_legacy=f"{k12_ms / legacy_ms:.1f}")

    # the test pass (one whole-batch forward, kernels and twins in turns) and a generation of 2 x 16000 frames
    def forward_pass(plain_path_=False):
        def run(_):
            with plain() if plain_path_ else contextlib.nullcontext():
                stcn_audio.evaluate(model, argparse_copy(args, split_eval=False), [(x_np, x_sl_np)], Tracker(),
                                    generator=torch.Generator(device=dev).manual_seed(SEED))
        return run

    tp = alternate(forward_pass(True), forward_pass(), [None], warmup=1)
    scored = int(x_sl_np.sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (frames_out, _), _ = model.generate(GEN_B, args.generate_frames, generator=gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    expect(bool(torch.isfinite(frames_out).all()) and frames_out.shape == (GEN_B, args.generate_frames),
           "STCN generation: shape, finite")
    phase("time-stcn-test-pass-and-generate", card=card, test_pass_samples=scored, test_pass_ms=f"{tp['kernel']:.2f}",
          test_pass_plain_ms=f"{tp['plain']:.2f}", test_pass_samples_per_s=f"{scored / tp['kernel'] * 1e3:.0f}",
          generate_frames=GEN_B * args.generate_frames, generate_s=f"{gen_s:.3f}",
          generate_frames_per_s=f"{GEN_B * args.generate_frames / gen_s:.1f}")
    profiled(lambda: forward_pass()(None), "profile-stcn-test-pass", per=1, unit="pass", card=card)
    profiled(lambda: model.generate(GEN_B, 600, generator=gen), "profile-stcn-generate", per=600, unit="frame",
             card=card)

    require(not failures, f"STCN phases failed: {failures}")


def counting_glu(modules):
    """K1's wrapper with a tally of its skip-free launches (a CUDA call launches or raises): ``(patch, tally)``."""
    tally = {"skip_free": 0}
    real = modules.residual_glu

    def glu(*a, need_skip=True, **kw):
        tally["skip_free"] += int(a[0].is_cuda and not need_skip)
        return real(*a, need_skip=need_skip, **kw)

    return mock.patch.object(modules, "residual_glu", glu), tally


def stcn_train_phases(record, smi, dev):
    """Phases 47-53, STCN's train step at the width of ``experiments/benchmarks.txt:26`` (s = 1, z = [256, 128,
    64, 32, 16], 256 channels, f32; --batch_size 20 in --accum_steps 4 microbatches of 5 random segments of
    1000 samples, the value and norm clips, the beta and free-nats annealers): K1-bwd at STCN's width against
    the float64 twin, three steps of the driver's ``train``, the step-0 gradients, K1-bwd's and the step's
    times and a profile of the step with the host's waits counted inside the microbatch loop; then one train
    step at ``:27`` (s = 64, z = [256], --num_stacks 5, whole utterances) against its twins. Each check is
    printed before any raises, so one run shows every number."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.data.transforms import RandomSegment
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, stcn_audio
    from blvm_tpu_torch.models import stcn as stcn_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.training.train_state import TrainState
    from blvm_tpu_torch.training.train_step import MICROBATCH_SPAN, make_train_step

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    args = stcn_audio.build_args(STCN_FLAGS.split())
    targs = argparse_copy(args, epochs=1, lr=3e-4)
    model = stcn_audio.build_model(args)
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    C, rf, seg = args.hidden_size, model.receptive_field, args.random_segment_size
    micro = args.batch_size // args.accum_steps  # 5 segments a microbatch
    block_names = ("gate_kernel_t", "gate_kernel_s", "gate_bias_t", "gate_bias_s", "rs_kernel", "rs_bias")

    # 47. K1-bwd at STCN's width against autograd of the f64 twin, at the train step's shapes: its first block
    # (skip-free, d = 1, (5, 1156, 256)) and its first used block (the skip at d = 16, (5, 1141, 256), the last
    # 1001 rows), both T uneven to the kernel's 32-row tiles; every gradient of the kernel and of the f32 twin
    # held to the f64 twin, the kernel's largest error within twice the f32 twin's plus 1e-6 (the convention of
    # K7-bwd, K8-bwd and K9-bwd)
    cases = {"skip_free": (0, 1, seg + rf - 1, 0, False), "skip": (4, 16, seg + rf - 1 - 15, seg + 1, True)}

    def block_grads(block, x, cotangents, d, skip, need_skip, fn, dtype):
        b = model.res_stack.blocks[block]
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in [x] + [getattr(b, n) for n in block_names]]
        o, s_ = fn(*leaves, dilation=d, skip_size=skip, need_skip=need_skip)
        outs = [o, s_] if need_skip else [o]
        torch.autograd.backward(outs, [c.to(dtype) for c in cotangents[: len(outs)]])
        return [leaf.grad.double() for leaf in leaves]

    k1b_err = 0.0
    for label, (block, d, T_in, skip, need_skip) in cases.items():
        x = torch.randn(micro, T_in, C, generator=gen, device=dev)
        cot = [torch.randn(micro, T_in - d, C, generator=gen, device=dev),
               torch.randn(micro, skip, C, generator=gen, device=dev)]
        cuda.reset_launch_counts()
        got = block_grads(block, x, cot, d, skip, need_skip, modules.residual_glu, torch.float32)
        torch.cuda.synchronize()
        launches = cuda.launch_counts()["residual_glu_bwd"]
        twin = block_grads(block, x, cot, d, skip, need_skip, modules.residual_glu_plain, torch.float32)
        ref = block_grads(block, x, cot, d, skip, need_skip, modules.residual_glu_plain, torch.float64)
        errs = {n: ((k - r).abs().max().item(), (t - r).abs().max().item())
                for n, k, t, r in zip(("x",) + block_names, got, twin, ref)}
        over = {n: e for n, e in errs.items() if e[0] > 2 * e[1] + 1e-6}
        finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
        dead = need_skip or not (got[5][..., C:].any() or got[6][C:].any())
        expect(finite and not over and dead and launches == 1,
               f"K1-bwd-stcn {label}: over {over}, finite {finite}, skip columns zero {dead}, launches {launches}")
        k1b_err = max(k1b_err, *(e[0] for e in errs.values()))
        phase("K1-bwd-stcn", mode=label, shape=f"({micro},{T_in},{C})", dilation=d, skip_rows=skip, dtype="f32",
              max_abs_err_vs_f64={n: f"{e[0]:.3g}" for n, e in errs.items()},
              twin_f32_max_abs_err_vs_f64={n: f"{e[1]:.3g}" for n, e in errs.items()})
    record["residual_glu_bwd"]["stcn_max_abs_err_vs_f64"] = k1b_err

    # 48. the train slice: flags of benchmarks.txt:26 -> driver -> model on the card -> weights bridge ->
    # stcn_audio.train with its annealers, 3 Adam steps on 20 utterances of 24k-72k samples a step, each cropped
    # to a random segment of 1000 as the driver crops; the latent noise from a generator of its own, alike for
    # the kernel and the plain runs
    rng = np.random.default_rng(args.seed + 48)
    lengths = rng.integers(STCN_T // 3, STCN_T + 1, 3 * args.batch_size)
    utterances = [(i, synthetic_speech(int(n), rng)) for i, n in enumerate(lengths)]
    train_batches = [utterances[i * args.batch_size : (i + 1) * args.batch_size] for i in range(3)]

    def seeded_noise(seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return mock.patch.object(stcn_model, "gaussian_noise", lambda _, shape, like: torch.randn(
            shape, generator=g_, device=like.device).to(like.dtype))

    def run_train(m, a, batches, plain_path_=False):
        log = StepLog(Tracker())
        counting, tally = counting_glu(modules)
        with plain() if plain_path_ else counting, seeded_noise(SEED + 48):
            cuda.reset_launch_counts()
            t0 = time.time()
            stcn_audio.train(m, a, batches, log)
            torch.cuda.synchronize()
            return log.steps, cuda.launch_counts(), tally["skip_free"], time.time() - t0

    weights.load_jax_params(model, params)
    steps_k, counts, skip_free, seconds = run_train(model, targs, train_batches)
    weights.load_jax_params(model, params)
    steps_p, counts_p, _, seconds_p = run_train(model, targs, train_batches, plain_path_=True)
    expected = dict(residual_glu=360, residual_glu_bwd=360, dmol_log_prob=12, dmol_log_prob_bwd=12, dmol_sample=12)
    expect(counts == {**dict.fromkeys(counts, 0), **expected} and skip_free == 240,
           f"STCN train-step launches {counts} ({skip_free} skip-free), expected {expected} and 240 skip-free "
           "(120/120/4/4/4 a step, 80 skip-free)")
    expect(not any(counts_p.values()), f"the plain STCN train path launched kernels: {counts_p}")
    for k, v in expected.items():
        record[k]["launches"] = record[k].get("launches", 0) + counts[k]
    losses, losses_p = [st["loss"] for st in steps_k], [st["loss"] for st in steps_p]
    loss_rel = [abs(a_ - b_) / abs(b_) for a_, b_ in zip(losses, losses_p)]
    expect(all(math.isfinite(v) for st in steps_k for v in st.values()), f"STCN train metrics not finite: {steps_k}")
    # step 0: the same parameters, only the sums' order differs (1e-5); later steps: Adam's first updates move
    # every parameter by about lr sign(g), so a gradient element near zero whose sign the order flips moves by
    # 2 lr (1e-4)
    expect(loss_rel[0] <= 1e-5 and max(loss_rel) <= 1e-4, f"STCN train losses {losses} vs plain {losses_p}")
    ref_annealers = stcn_audio.build_annealers(targs)
    ref_values = [{k: float(np.float32(a_.step())) for k, a_ in ref_annealers.items()} for _ in range(3)]
    got_values = [{k: st[k] for k in ("beta", "free_nats")} for st in steps_k]
    expect(got_values == ref_values and got_values[0] == dict(beta=1.0, free_nats=0.0625),
           f"STCN annealers {got_values}, expected {ref_values}")
    phase("stcn-train-slice", steps=3, segments_per_step=args.batch_size, microbatches=args.accum_steps,
          samples_per_step=seg * args.batch_size, losses=[f"{v:.6f}" for v in losses],
          losses_plain=[f"{v:.6f}" for v in losses_p], loss_rel=[f"{v:.3g}" for v in loss_rel],
          beta=[v["beta"] for v in got_values], free_nats=[v["free_nats"] for v in got_values],
          launches_per_step={k: v // 3 for k, v in counts.items() if v}, skip_free_per_step=skip_free // 3,
          seconds=f"{seconds:.2f}", seconds_plain=f"{seconds_p:.2f}")

    # 49. the step-0 gradients of every parameter on the first microbatch of the first step (its crops), at beta 1
    # and the first free-nats value: the kernels and the f32 twins both held to the f64 twins, the kernels no
    # further than twice the f32 twins plus 1e-6 (relative norms)
    crop = RandomSegment(seg, seed=targs.seed)
    x0, sl0 = common.make_train_batch(train_batches[0], targs, 1, crop)
    x0, sl0 = torch.from_numpy(x0[:micro]).to(dev), torch.from_numpy(sl0[:micro]).to(dev)

    def step0_grads(m, x_, sl_, plain_path_, dtype):
        m.zero_grad(set_to_none=True)
        m.train()
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise(SEED + 49):
            loss, _, _ = m(x_.to(dtype), sl_, beta=1.0, free_nats=0.0625,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
            loss.backward()
        # a parameter off every path to the loss (at :27 the encoder's blocks after the only used one) has none
        grads = {n: (p_.grad if p_.grad is not None else torch.zeros_like(p_)).detach().clone()
                 for n, p_ in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return grads, loss.item()

    def grads_against_f64(m, p_, x_, sl_):
        weights.load_jax_params(m, p_)
        g_k, loss_k = step0_grads(m, x_, sl_, False, torch.float32)
        g_p, loss_p = step0_grads(m, x_, sl_, True, torch.float32)
        m64 = copy.deepcopy(m).double()
        g_64, loss_64 = step0_grads(m64, x_, sl_, True, torch.float64)
        del m64
        e_k = {n: rel_norm(g_k[n], g_64[n]) for n in g_64}
        e_p = {n: rel_norm(g_p[n], g_64[n]) for n in g_64}
        over = {n: (e_k[n], e_p[n]) for n in e_k if e_k[n] > 2 * e_p[n] + 1e-6}
        finite = all(bool(torch.isfinite(g_).all()) for g_ in g_k.values())
        worst = max(e_k, key=e_k.get)
        values = dict(loss=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}", loss_f64=f"{loss_64:.6f}",
                      kernel_max_rel_vs_f64=f"{e_k[worst]:.3g}", twin_f32_max_rel_vs_f64=f"{max(e_p.values()):.3g}",
                      worst=worst, kernel_vs_twin_max_rel=f"{max(rel_norm(g_k[n], g_p[n]) for n in g_p):.3g}",
                      parameters=len(e_k), without_gradient=sum(not g_.any() for g_ in g_64.values()))
        return finite and not over, over, values

    ok, over, values = grads_against_f64(model, params, x0, sl0)
    expect(ok, f"STCN step-0 gradients: {over}")
    phase("stcn-train-grads", **values)
    torch.cuda.empty_cache()

    # 50. K1-bwd's time a call at the train step's shapes of 47, CUDA events, a different input each call: the
    # whole backward (the kernel and the weight-gradient products) against autograd of the twin in turns, and
    # the kernel alone (its C entry point on buffers made beforehand), each beside its roofline() bound
    def backward_only(graph):
        outputs, inputs, grad_outputs = graph
        return torch.autograd.grad(outputs, inputs, grad_outputs, retain_graph=True)

    lib = cuda.library()
    for label, (block, d, T_in, skip, need_skip) in cases.items():
        b = model.res_stack.blocks[block]
        w = [getattr(b, n).detach() for n in block_names]
        S = C if need_skip else 0

        def glu_graph(fn, x_):
            leaves = [x_.requires_grad_(True)] + [t.clone().requires_grad_(True) for t in w]
            o, s_ = fn(*leaves, dilation=d, skip_size=skip, need_skip=need_skip)
            outs = (o, s_) if need_skip else (o,)
            return outs, leaves, tuple(torch.randn_like(t) for t in outs)

        graphs = []
        for _ in range(3):
            x_ = torch.randn(micro, T_in, C, generator=gen, device=dev)
            graphs.append((glu_graph(modules.residual_glu_plain, x_.clone()), glu_graph(modules.residual_glu, x_.clone())))
        t = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), graphs, warmup=1)
        # the kernel alone: x, the weights and the cotangents of each graph, d_pre, act and dx made beforehand
        L = T_in - d
        bufs = []
        for g_ in graphs:
            (outs, leaves, cots) = g_[1]
            d_s = cots[1] if need_skip else torch.empty(0, device=dev)
            bufs.append([leaves[0].detach(), *w[:5], cots[0], d_s, torch.empty(micro, L, 2 * C, device=dev),
                         torch.empty(micro, L, C, device=dev), torch.empty(micro, T_in, C, device=dev)])

        def kernel_alone(buf):
            cuda.check(lib.blvm_residual_glu_bwd(*(t_.data_ptr() for t_ in buf), micro, T_in, C, C, C, S, 2 * C, d, skip,
                                                 0, cuda.stream_handle(buf[0])), "residual_glu_bwd")

        alone = sorted(cuda_time_ms(kernel_alone, bufs, warmup=1))[1]
        bound = roofline(**residual_glu_bwd_work(micro, T_in, C, C, S, d, skip), peak=F32_PEAK)
        bound_alone = roofline(**residual_glu_bwd_work(micro, T_in, C, C, S, d, skip, weight_grads=False), peak=F32_PEAK)
        if label == "skip":  # K1-bwd's own kernel (the WaveNet step takes the warpgroup route): STCN's block with its skip
            record["residual_glu_bwd"].update(ms=t["kernel"], plain_ms=t["plain"], **bound)
        record["residual_glu_bwd"].update({
            f"stcn_{label}_ms": t["kernel"], f"stcn_{label}_plain_ms": t["plain"], f"stcn_{label}_bound_ms": bound["bound_ms"],
            f"stcn_{label}_kernel_alone_ms": alone, f"stcn_{label}_kernel_alone_bound_ms": bound_alone["bound_ms"]})
        flops = residual_glu_bwd_work(micro, T_in, C, C, S, d, skip, weight_grads=False)["flops"]
        phase("time-K1-bwd-stcn", card=card, mode=label, shape=f"({micro},{T_in},{C})", dilation=d, dtype="f32",
              backward_ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}", bound_ms=f"{bound['bound_ms']:.4f}",
              kernel_alone_ms=f"{alone:.4f}", kernel_alone_bound_ms=f"{bound_alone['bound_ms']:.4f}",
              bound_by=bound_alone["bound_by"], kernel_alone_tflops=f"{flops / alone / 1e9:.2f}",
              includes="backward: both passes + weight-gradient GEMMs")
        del graphs, bufs

    # 51. the train step (accum 4, the clips, Adam) on 4 batches of crops, kernels and twins in turns; its host
    # enqueue time (the step returns before the card finishes) and peak memory
    tx, _ = common.build_tx_and_lr(targs)
    weights.load_jax_params(model, params)
    model.train()
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(common.loss_fn, accum=args.accum_steps,
                                 loss_weight=lambda mb, mets: mb["x_sl_host"].sum())
    scalars = dict(beta=torch.tensor(1.0), free_nats=torch.tensor(0.0625))
    step_batches = []
    for i in range(4):
        xb_, slb_ = common.make_train_batch(train_batches[i % 3], targs, i + 2, crop)
        step_batches.append(dict(x=torch.from_numpy(xb_).to(dev), x_sl=torch.from_numpy(slb_).to(dev),
                                 x_sl_host=torch.from_numpy(slb_)))

    def run_step(b_):
        train_step(state, b_, scalars)

    def run_step_plain(b_):
        with plain():
            train_step(state, b_, scalars)

    torch.cuda.reset_peak_memory_stats()
    ts = alternate(run_step_plain, run_step, step_batches, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    enqueue = []
    for b_ in step_batches:
        t0 = time.perf_counter()
        run_step(b_)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    samples = seg * args.batch_size
    phase("time-stcn-train-step", card=card, segments=args.batch_size, microbatches=args.accum_steps, samples=samples,
          kernel_ms=f"{ts['kernel']:.3f}", plain_ms=f"{ts['plain']:.3f}",
          samples_per_s=f"{samples / ts['kernel'] * 1e3:.0f}", host_enqueue_ms=f"{sorted(enqueue)[1]:.3f}",
          peak_memory_GB=f"{peak_gb:.2f}")

    # 52. torch.profiler over one step (reading the trace of its ~11000 launches takes ~20 s a step):
    # device time, idle share, launches, the top kernels; inside the microbatch loop's spans no host wait on the
    # card (a stream synchronization or a device value read to the host); and one step run with torch's sync debug
    # mode raising on any synchronizing call
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step(step_batches[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels_ = device_kernels(prof)
    busy_ms = sum(device_us(e_) for e_ in kernels_) / 1e3
    spans, waits_in_loop = 0, []
    for e_ in prof.events():
        if e_.device_type != torch.autograd.DeviceType.CPU:  # the span's copy on the device's timeline
            continue
        spans += e_.name == MICROBATCH_SPAN
        if e_.name in SYNC_EVENTS:
            parent = e_.cpu_parent
            while parent is not None and parent.name != MICROBATCH_SPAN:
                parent = parent.cpu_parent
            if parent is not None:
                waits_in_loop.append(e_.name)
    waits_anywhere = {n: sum(e_.count for e_ in averages if e_.key == n) for n in SYNC_EVENTS}
    try:
        torch.cuda.set_sync_debug_mode("error")
        run_step(step_batches[3])
        sync_free = True
    except RuntimeError as err:
        sync_free = False
        print(f"  sync debug mode: {err}", flush=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    expect(spans == args.accum_steps and not waits_in_loop and sync_free,
           f"STCN train step: {spans} microbatch spans, host waits inside them {waits_in_loop}, "
           f"sync debug mode passed {sync_free}")
    # the idle share against the step's time by CUDA events (51): the profiler's own host work a launch
    # stretches its wall time, and this step is launch-heavy
    phase("profile-stcn-train-step", card=card, device_ms_per_step=f"{busy_ms:.3f}", step_ms=f"{ts['kernel']:.3f}",
          idle_share=f"{1 - busy_ms / ts['kernel']:.3f}" if busy_ms else "not measured",
          wall_ms_per_step_under_profiler=f"{wall_ms:.3f}",
          kernel_launches_per_step=sum(e_.count for e_ in kernels_),
          host_enqueue_ms=f"{sorted(enqueue)[1]:.3f}", microbatch_spans=spans, host_waits_in_loop=len(waits_in_loop),
          host_waits_in_profile=waits_anywhere, sync_debug_mode_step="passed" if sync_free else "raised")
    for e_ in sorted(kernels_, key=device_us, reverse=True)[:10]:
        print(f"  {device_us(e_) / 1e3:9.3f} ms/step {e_.count:5d} calls/step  {e_.key[:90]}", flush=True)
    for e_ in sorted(kernels_, key=lambda e: e.count, reverse=True)[:8]:  # where the launches come from
        print(f"  launches {e_.count:5d}/step {device_us(e_) / 1e3:9.3f} ms/step  {e_.key[:90]}", flush=True)
    del state, step_batches
    torch.cuda.empty_cache()

    # 53. one train step at benchmarks.txt:27 (s = 64, z = [256], 5 stacks: 24 of the 25 encoder blocks skip-free,
    # the stacked input and the upsampling head under a gradient) on 20 whole utterances of 24k-72k samples
    # through stcn_audio.train, kernels against twins; its step-0 gradients held to the f64 twins as in 49. The
    # one level reads block 0's skip only, so the 24 blocks after it reach no output, as in JAX: they do not run,
    # and the forward runs 6 K1 (block 0 and the 5 decode blocks), the backward K1-bwd for the same 6
    args27 = stcn_audio.build_args(STCN27_FLAGS.split())
    targs27 = argparse_copy(args27, epochs=1, lr=3e-4)
    model27 = stcn_audio.build_model(args27)
    params27 = weights.random_jax_params(model27, args27.seed)
    rng27 = np.random.default_rng(args27.seed + 53)
    batch27 = [[(i, synthetic_speech(int(n), rng27))
                for i, n in enumerate(rng27.integers(STCN_T // 3, STCN_T + 1, args27.batch_size))]]
    weights.load_jax_params(model27, params27)
    steps27, counts27, skip_free27, seconds27 = run_train(model27, targs27, batch27)
    weights.load_jax_params(model27, params27)
    steps27_p, counts27_p, _, _ = run_train(model27, targs27, batch27, plain_path_=True)
    expected27 = dict(residual_glu=6, residual_glu_bwd=6, dmol_log_prob=1, dmol_log_prob_bwd=1, dmol_sample=1)
    expect(counts27 == {**dict.fromkeys(counts27, 0), **expected27} and skip_free27 == 0 and not any(counts27_p.values()),
           f"STCN :27 step launches {counts27} ({skip_free27} skip-free), plain {counts27_p}, expected {expected27}")
    for k, v in expected27.items():
        record[k]["launches"] = record[k].get("launches", 0) + counts27[k]
    rel27 = abs(steps27[0]["loss"] - steps27_p[0]["loss"]) / abs(steps27_p[0]["loss"])
    expect(math.isfinite(steps27[0]["loss"]) and rel27 <= 1e-5, f"STCN :27 loss {steps27} vs plain {steps27_p}")
    x27, sl27 = common.make_train_batch(batch27[0], targs27, 1, None)
    ok, over, values = grads_against_f64(model27, params27, torch.from_numpy(x27).to(dev), torch.from_numpy(sl27).to(dev))
    expect(ok, f"STCN :27 step-0 gradients: {over}")
    phase("stcn27-train-step", utterances=args27.batch_size, samples=int(sl27.sum()), stacks=int(math.ceil(sl27.max() / 64)),
          loss_step=f"{steps27[0]['loss']:.6f}", loss_step_plain=f"{steps27_p[0]['loss']:.6f}", loss_rel=f"{rel27:.3g}",
          launches={k: v for k, v in counts27.items() if v}, skip_free=skip_free27, seconds=f"{seconds27:.2f}",
          step0_grads=values)
    del model27
    torch.cuda.empty_cache()

    require(not failures, f"STCN train phases failed: {failures}")


def driver_loop_phases(smi, dev):
    """Phase 54, the drivers' loops on the card (the repair of their host waits): the flagship WaveNet
    train loop (``wavenet_audio.train``, 10 steps) and the whole-batch test pass (``evaluate``, 10 batches) at
    ``--metric_fetch_lag`` 0 and 8: wall ms a step, the host's waits on the card inside the steps' spans and in
    all, and the tracker's values, which must be the same at both lags."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common, wavenet_audio

    card = smi.replace(" ", "_")
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
    args = wavenet_audio.build_args(FLAGSHIP_FLAGS.split())
    model = wavenet_audio.build_model(args)
    params = weights.random_jax_params(model, args.seed)
    rng = np.random.default_rng(SEED + 54)
    n_steps = 10
    batches = [[(i * B + j, synthetic_speech(int(n), rng)) for j, n in enumerate(rng.integers(T, 2 * T, B))]
               for i in range(n_steps)]
    eval_batches = [wavenet_audio.make_batch([w for _, w in b], args) for b in batches]

    def run(kind, lag, profiler=None):
        weights.load_jax_params(model, params)
        tracker = Tracker()
        largs = argparse_copy(args, metric_fetch_lag=lag, epochs=1, split_eval=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "train":
            wavenet_audio.train(model, largs, batches, tracker)
        else:
            with torch.no_grad():
                wavenet_audio.evaluate(model, largs, eval_batches, tracker)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps, tracker.values

    failures = []
    for kind in ("train", "evaluate"):
        ms = {0: [], 8: []}
        values = {}
        for lag in (0, 8, 8, 0):
            step_ms, values[lag] = run(kind, lag)
            ms[lag].append(step_ms)
        counts = {}
        for lag in (0, 8):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(kind, lag)
            in_steps, total = 0, 0
            for e_ in prof.events():
                if e_.device_type == torch.autograd.DeviceType.CPU and e_.name in waits:
                    total += 1
                    parent = e_.cpu_parent
                    while parent is not None and parent.name != common.STEP_SPAN:
                        parent = parent.cpu_parent
                    in_steps += parent is not None
            counts[lag] = (in_steps, total)
        # the same numbers in the same merge order: equal, unless cuBLAS picks another reduction order between runs
        exact = values[0] == values[8]
        rel = max(abs(values[8][src][name] - v) / max(abs(v), 1e-30) for src in values[0]
                  for name, v in values[0][src].items())
        if not (rel <= 1e-5 and counts[8][0] == 0):
            failures.append(f"{kind}: waits (in steps, all) {counts}, values rel {rel}")
        phase("driver-loop-lag", card=card, loop=kind, steps=n_steps, B=B, ms_per_step_lag0=f"{min(ms[0]):.3f}",
              ms_per_step_lag8=f"{min(ms[8]):.3f}", host_waits_in_steps_lag0=counts[0][0],
              host_waits_in_steps_lag8=counts[8][0], host_waits_all_lag0=counts[0][1],
              host_waits_all_lag8=counts[8][1], tracker_values_exact=exact, tracker_values_rel=f"{rel:.3g}")
    del model
    torch.cuda.empty_cache()
    require(not failures, f"driver loop phases failed: {failures}")


def depthwise_work(B, N_in, N_out, C, k):
    """``roofline`` keywords of one K11 call (f32): u read once, z written once, the six (C,) vectors and the
    (k, C) kernel read once; relu, the statistics and the normalization of each input element (6 operations) and
    of each output element, with the taps (2k + 6)."""
    return dict(bytes_=4 * (B * N_in * C + B * N_out * C + (6 + k) * C),
                flops=B * N_in * C * 6 + B * N_out * C * (2 * k + 6))


def rssm_work(B, T, H, Z, save=False):
    """``roofline`` keywords of one K10 launch in inference mode (f32): xg, xq, the noise, z0, h0 and the 20 kernel
    weights read once, z, h and both heads' mu and sd written once (in save mode also the saved 11 H + 4 Z a
    row-step); a row-step's multiply-adds (gru_in's z rows, the GRU's two products, both MLPs' three layers and
    both heads, 12 H^2 + 5 H Z) at two operations each."""
    rows = B * T
    weights_ = Z * H + 2 * (3 * H * H + 3 * H) + 2 * (3 * H * H + 2 * H + H * 2 * Z + 2 * Z) - H
    saved = rows * (11 * H + 4 * Z) if save else 0
    return dict(bytes_=4 * (rows * (2 * H + Z) + B * (Z + H) + weights_ + rows * (H + 5 * Z) + saved),
                flops=2 * rows * (12 * H * H + 5 * H * Z))


def rssm_bwd_work(B, T, H, Z, covered):
    """``roofline`` keywords of one K10-bwd launch (f32): the 12 kernel matrices read once (the biases are not
    read), a row-step's noise, saved values (11 H + 4 Z), h and six output gradients read and its pre-activation
    gradients (13 H + 4 Z) written, h0 read, d z0 and d h0 written; the backward's products, one a kernel matrix a
    row-step (12 H^2 + 5 H Z multiply-adds), over the ``covered`` row-steps the lengths reach (past them every
    gradient is zero)."""
    rows = B * T
    matrices = 12 * H * H + 5 * H * Z
    per_row = Z + (11 * H + 4 * Z) + H + (H + 5 * Z) + (13 * H + 4 * Z)
    return dict(bytes_=4 * (matrices + rows * per_row + 2 * B * (Z + H)), flops=2 * covered * matrices)


def depthwise_bwd_work(B, N_in, N_out, C, k):
    """``roofline`` keywords of one K11-bwd call (f32): u and dz read once, the saved statistics (8 B C), the kernel
    and four (C,) vectors read once, du and the (k + 5, C) parameter gradients written once; a GroupNorm's backward
    and the relu's mask on each input element (6 operations, with the conv's input gradient 2k more) and on each
    output element (6, with y recomputed, dv and the taps' gradients 4k more)."""
    return dict(bytes_=4 * (2 * B * N_in * C + B * N_out * C + 8 * B * C + (2 * k + 9) * C),
                flops=B * N_in * C * (2 * k + 6) + B * N_out * C * (4 * k + 6))


def cwvae_phases(record, smi, dev):
    """Phases 55-60, the CW-VAE's serving path at the width of ``experiments/benchmarks.txt:33`` (d = 192, z = 128,
    strides [64], the precision-weighted posterior, 3 encoder and 3 decoder blocks expanding 192 -> 768 with k = 5
    and stride 4, DMoL 10 x 2^16, f32): K11 and K10 against their twins at every shape the path gives them (and at
    the driver's default two-level width 96, strides [64, 16]), the test pass whole and in carried-state chunks,
    generation through the driver's hook, and their times. Each check is printed before any raises."""
    import copy

    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import clockwork_audio, common
    from blvm_tpu_torch.models.clockwork_vae import clockwork_vae as cw_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, depthwise, likelihoods, recurrent, rssm, variational

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 55)
    args = clockwork_audio.build_args(CWVAE_FLAGS.split())
    model = clockwork_audio.build_model(args)
    require(next(model.parameters()).device.type == "cuda", "clockwork_audio.build_model did not build on the card")
    weights.load_jax_params(model, weights.random_jax_params(model, args.seed))
    model.eval()
    H, Z = args.hidden_size[0], args.latent_size[0]
    rng = np.random.default_rng(args.seed + 55)
    # the --batch_len 16000 x 16 budget: the longest utterance of 72000 samples and four of 24k-46k
    lengths = np.concatenate([[CWVAE_T], rng.integers(24000, 46001, CWVAE_B - 1)])
    require(lengths.sum() <= CWVAE_BUDGET, f"the test batch {lengths} exceeds --batch_len")
    x_np, x_sl_np = common.make_batch([synthetic_speech(int(n), rng) for n in lengths], args)
    x_dev, x_sl_dev = torch.from_numpy(x_np).to(dev), torch.from_numpy(x_sl_np).to(dev)

    def seeded_noise():
        g_ = torch.Generator(device=dev).manual_seed(SEED + 57)
        return mock.patch.object(cw_model, "gaussian_noise",
                                 lambda _, shape, like: torch.randn(shape, generator=g_, dtype=like.dtype,
                                                                    device=like.device))

    # the calls of the test pass's forward, one chunk of --split_eval (the first, then the last with same
    # padding), and the default two-level model's forward on the first two utterances
    k11_calls, k11_patch = recorded(depthwise, "depthwise_norm")
    k10_calls, k10_patch = recorded(rssm, "rssm_chain")
    chunks, chunk_lens = model.split_sequence(x_np, x_sl_np, length=args.random_segment_size or 4 * model.overall_stride)
    args2 = clockwork_audio.build_args("--strides 64 16 --seed 0".split())
    model2 = clockwork_audio.build_model(args2)
    weights.load_jax_params(model2, weights.random_jax_params(model2, 1))
    with torch.no_grad(), k11_patch, k10_patch, seeded_noise():
        model(x_dev, x_sl_dev)
        n_whole = len(k11_calls)
        for i in (0, len(chunks) - 1):
            model(torch.from_numpy(chunks[i]).to(dev), torch.from_numpy(chunk_lens[i]).to(dev), pad_strideable=False,
                  pad_same=i == len(chunks) - 1)
        n_chunks_calls = len(k11_calls)
        model2(x_dev[:2], x_sl_dev[:2])
    labels = ([f"enc{i}" for i in range(3)] + [f"dec{i}" for i in range(3)]
              + [f"chunk_first_enc{i}" for i in range(3)] + [f"chunk_first_dec{i}" for i in range(3)]
              + [f"chunk_last_enc{i}" for i in range(3)] + [f"chunk_last_dec{i}" for i in range(3)]
              + [f"two_level_{s}{i}" for s in ("enc0_", "enc1_") for i in range(3)]
              + [f"two_level_{s}{i}" for s in ("dec1_", "dec0_") for i in range(3)])
    require(n_whole == 6 and n_chunks_calls == 18 and len(k11_calls) == 30 and len(k10_calls) == 5,
            f"K11 calls {n_whole}, {n_chunks_calls}, {len(k11_calls)}; K10 calls {len(k10_calls)}")

    # 55. K11 against its twins at every block shape. The whole test pass's and the two-level forward's blocks: within
    # K11_F64_ATOL of the f64 twin, fixed (the kernel sums its statistics in double; the f32 twin's fast variance,
    # E[x^2] - E[x]^2 summed in f32 over 72021 rows, lies up to 9.7e-5 from the f64 twin at encoder block 0, the kernel
    # 1.7e-5, and 1.8e-5 at most over these shapes in an earlier run on an H100). A --split_eval chunk's blocks, where
    # GroupNorm runs over a handful of rows (5 in a last chunk's top block) and amplifies any rounding: within 1e-5 +
    # 1e-5 |twin| of the f32 twin, or else within twice the f32 twin's own error of the f64 twin
    K11_F64_ATOL = 5e-5
    k11_err = 0.0
    for label, (a, k) in zip(labels, k11_calls):
        with torch.no_grad():
            cuda.reset_launch_counts()
            got = depthwise.depthwise_norm(*a, **k)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["depthwise_norm"]
            ref = depthwise.depthwise_norm_plain(*a, **k)
            ref64 = depthwise.depthwise_norm_plain(*(t.double() for t in a), **k)
        err = (got - ref).abs()
        close = bool((err <= 1e-5 + 1e-5 * ref.abs()).all())
        e64, t64 = (got.double() - ref64).abs().max().item(), (ref.double() - ref64).abs().max().item()
        agrees = (close or e64 <= 2 * t64) if label.startswith("chunk") else e64 <= K11_F64_ATOL
        expect(launches == 1 and bool(torch.isfinite(got).all()) and agrees,
               f"K11 {label}: max err {err.max().item()}, vs f64 {e64} (twin {t64})")
        if not label.startswith("chunk") and not label.startswith("two"):
            k11_err = max(k11_err, err.max().item())
        phase("K11", case=label, u=tuple(a[0].shape), out=tuple(got.shape), stride=k["stride"],
              transposed=k["transposed"], max_abs_err=f"{err.max().item():.3g}", within_1e5=close,
              kernel_vs_f64=f"{e64:.3g}", twin_vs_f64=f"{t64:.3g}")
        del got, ref, ref64
    record["depthwise_norm"]["max_abs_err"] = k11_err

    # 56. K10 against its twin: inference mode on the test pass's hoisted products (5, 1125), teacher-forced (a twin
    # step from the kernel's z and h entering every step) within 1e-5 + 1e-5 |twin| and free-running within 1e-4 +
    # 1e-5 |twin|; the same at the two-level model's levels (level 0 with the context of width 96); prior mode at a
    # generation's shape (2, 2000) from the hook below
    def within(got, ref, atol, rtol):
        return all(bool(((g - r).abs() <= atol + rtol * r.abs()).all()) for g, r in zip(got, ref) if r is not None)

    def max_err(got, ref):
        return max((g - r).abs().max().item() for g, r in zip(got, ref) if r is not None)

    def check_k10(label, a, k):
        kw_, xg, xq, z0, h0, eps, *rest = a
        resets = rest[0] if rest else None
        with torch.no_grad():
            cuda.reset_launch_counts()
            got = rssm.rssm_chain(*a, **k)
            torch.cuda.synchronize()
            launches = cuda.launch_counts()["rssm_chain"]
            free = rssm.rssm_chain_plain(*a, **k)
            B_, T_, H_ = xg.shape
            z_prev = torch.cat([z0[:, None], got.z[:, :-1]], dim=1).reshape(B_ * T_, -1)
            h_prev = torch.cat([h0[:, None], got.h[:, :-1]], dim=1).reshape(B_ * T_, -1)
            flat = lambda t: None if t is None else t.reshape(B_ * T_, 1, -1)
            forced = rssm.rssm_chain_plain(kw_, flat(xg), flat(xq), z_prev, h_prev, flat(eps), **k)
        forced = [None if t is None else t.reshape(B_, T_, -1) for t in forced]
        e_free, e_forced = max_err(got, free), max_err(got, forced)
        ok = launches == 1 and all(bool(torch.isfinite(t).all()) for t in got if t is not None)
        expect(ok and (resets is not None or within(got, forced, 1e-5, 1e-5)), f"K10 {label}: teacher-forced {e_forced}")
        expect(within(got, free, 1e-4, 1e-5), f"K10 {label}: free-running {e_free}")
        phase("K10", case=label, shape=tuple(xg.shape), Z=z0.shape[1], inference=k["inference"], launches=launches,
              free_max_abs_err=f"{e_free:.3g}", teacher_forced_max_abs_err=f"{e_forced:.3g}")
        return e_free

    record["rssm_chain"]["max_abs_err"] = check_k10("test_pass_B5", *k10_calls[0])
    check_k10("chunk_first", *k10_calls[1])
    check_k10("two_level_top", *k10_calls[3])
    check_k10("two_level_bottom_with_context", *k10_calls[4])

    # 57. the test pass: flags of benchmarks.txt:33 -> driver -> model on the card -> weights bridge, whole and with
    # --split_eval (each level's state carried), kernels against the twins with the same latent noise: 1 K10, 6 K11,
    # 1 K2, 1 K3 a forward, none on the plain path; bits/frame rel 1e-5 (f32 throughout; only summation orders
    # differ, and the kernel's GroupNorm statistics are summed in double)
    n_chunks = len(chunks)

    def test_pass(split, plain_path_=False):
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise():
            cuda.reset_launch_counts()
            t0 = time.time()
            values = clockwork_audio.evaluate(model, argparse_copy(args, split_eval=split), [(x_np, x_sl_np)],
                                              Tracker(), generator=torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            return values, cuda.launch_counts(), time.time() - t0

    path_launches = {"rssm_chain": 0, "depthwise_norm": 0}
    bpt = "elbo (bpt)"
    for split in (False, True):
        values, counts, seconds = test_pass(split)
        values_p, counts_p, seconds_p = test_pass(split, plain_path_=True)
        forwards = n_chunks if split else 1
        expected = dict(rssm_chain=forwards, depthwise_norm=6 * forwards, dmol_log_prob=forwards, dmol_sample=forwards)
        expect(counts == {**dict.fromkeys(counts, 0), **expected},
               f"CW-VAE test pass split={split}: launches {counts}, expected {expected}")
        expect(not any(counts_p.values()), f"the plain CW-VAE test pass launched kernels: {counts_p}")
        for k_ in path_launches:
            path_launches[k_] += counts[k_]
        rel = abs(values[bpt] - values_p[bpt]) / abs(values_p[bpt])
        finite = all(math.isfinite(v) for v in values.values())
        expect(finite and rel <= 1e-5, f"CW-VAE test pass split={split}: {values} vs twins {values_p}")
        phase("cwvae-test-pass", split_eval=split, utterances=list(map(int, lengths)), forwards=forwards,
              loss=f"{values['loss']:.6f}", bpt=f"{values[bpt]:.6f}", bpt_plain=f"{values_p[bpt]:.6f}",
              bpt_rel=f"{rel:.3g}", kl_bpt=f"{values['kl (bpt)']:.4f}", rec_bpt=f"{values['rec (bpt)']:.6f}",
              launches_per_forward={k_: v // forwards for k_, v in counts.items() if v}, seconds=f"{seconds:.2f}",
              plain_seconds=f"{seconds_p:.2f}")

    # 58. generation through the driver's hook: 2 x 128000 frames at the DMoL mode, the latents sampled: one K10
    # launch (prior mode, 2000 steps) and the decoder's 3 K11, no K3; two wav files. Then a generation from given
    # latent noise against the twins fed the same noise, held to the f64 twins within twice the f32 twins' error
    out_dir = Path(__file__).resolve().parent / "blvm_tpu_torch" / "_build" / "cwvae_generation_hook"
    hook = clockwork_audio.make_generation_hook(model, argparse_copy(args, generate_every=5))
    k10_gen, k10_gen_patch = recorded(rssm, "rssm_chain")
    with k10_gen_patch:
        cuda.reset_launch_counts()
        t0 = time.time()
        paths = hook(5, out_dir)
        torch.cuda.synchronize()
        hook_s = time.time() - t0
        counts = cuda.launch_counts()
    n_top = args.generate_frames // model.overall_stride
    expected = dict(rssm_chain=1, depthwise_norm=3)
    expect(counts == {**dict.fromkeys(counts, 0), **expected}, f"CW-VAE generation launches {counts}, expected {expected}")
    for k_ in path_launches:
        path_launches[k_] += counts[k_]
    shapes = []
    for path in paths:
        with wave.open(str(path)) as f:
            shapes.append((f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()))
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        expect(shapes[-1] == (1, 2, 16000, args.generate_frames) and np.abs(pcm).max() > 0,
               f"CW-VAE hook wav {path}: {shapes[-1]}")
    expect(len(paths) == 2, f"CW-VAE hook wrote {paths}")
    phase("cwvae-generation-hook", frames=args.generate_frames, top_steps=n_top, launches=counts,
          seconds=f"{hook_s:.2f}", files=[str(p_.relative_to(out_dir.parents[2])) for p_ in paths], wav=shapes)
    record["rssm_chain"]["launches"] = path_launches["rssm_chain"]
    record["depthwise_norm"]["launches"] = path_launches["depthwise_norm"]
    check_k10("generation_prior", *k10_gen[0])

    eps_g = [torch.randn(GEN_B, n_top, Z, generator=gen, device=dev)]
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        (frames, _), _ = model.generate(GEN_B, args.generate_frames, use_mode_observations=True, eps=eps_g)
        with plain():
            (twin, _), _ = model.generate(GEN_B, args.generate_frames, use_mode_observations=True, eps=eps_g)
            (twin64, _), _ = model64.generate(GEN_B, args.generate_frames, use_mode_observations=True,
                                             eps=[e.double() for e in eps_g])
    del model64
    e_twin, e_k64, e_t64 = ((a.double() - b.double()).abs().max().item()
                            for a, b in ((frames, twin), (frames, twin64), (twin, twin64)))
    share = ((frames - twin).abs() <= 1e-5).double().mean().item()
    # each frame is the location of its most probable mixture component: where two components' logits lie within
    # f32 rounding of each other the pick may differ (the f64 twins differ from both f32 paths there), at most 1e-3
    # of the frames
    expect(bool(torch.isfinite(frames).all()) and share >= 1 - 1e-3,
           f"CW-VAE generation vs twins: {e_twin}, share {share} (vs f64: kernels {e_k64}, twins {e_t64})")
    phase("cwvae-generate-vs-twins", frames=GEN_B * args.generate_frames, share_within_1e5=f"{share:.6f}",
          max_abs_err=f"{e_twin:.3g}", kernels_vs_f64=f"{e_k64:.3g}", twins_vs_f64=f"{e_t64:.3g}")
    del frames, twin, twin64

    # 59. times: CUDA events, a different input each call, kernel and twin in turns (one warm-up: the twins take
    # ~0.5 s a call): K10 a launch and a step at the test pass's shape and in prior mode at (2, 2000); K11 at the
    # test pass's six block shapes, beside the composite of PyTorch calls for the same chain (relu, F.group_norm,
    # the grouped conv, relu, F.group_norm; none computes it in one call) and the block's two 1x1 GEMMs (cuBLAS)
    a10, k10kw = k10_calls[0]
    eps_t = [torch.randn(a10[5].shape, generator=gen, device=dev) for _ in range(2)]

    def k10(e_):
        with torch.no_grad():
            rssm.rssm_chain(*a10[:5], e_, **k10kw)

    def k10_plain(e_):
        with torch.no_grad():
            rssm.rssm_chain_plain(*a10[:5], e_, **k10kw)

    t10 = alternate(k10_plain, k10, eps_t, warmup=1)
    B10, T10 = a10[1].shape[:2]
    record["rssm_chain"].update(ms=t10["kernel"], plain_ms=t10["plain"], library_ms=None,
                                **roofline(**rssm_work(B10, T10, H, Z), peak=F32_PEAK))
    ag, kg = k10_gen[0]
    eps_p = [torch.randn(ag[5].shape, generator=gen, device=dev) for _ in range(2)]

    def k10_prior(e_):
        with torch.no_grad():
            rssm.rssm_chain(*ag[:5], e_, **kg)

    def k10_prior_plain(e_):
        with torch.no_grad():
            rssm.rssm_chain_plain(*ag[:5], e_, **kg)

    t10p = alternate(k10_prior_plain, k10_prior, eps_p, warmup=1)
    phase("time-K10", card=card, shape=f"({B10},{T10})", H=H, Z=Z, dtype="f32", kernel_ms=f"{t10['kernel']:.4f}",
          plain_ms=f"{t10['plain']:.4f}", us_per_step=f"{t10['kernel'] * 1e3 / T10:.3f}",
          bound_ms=f"{record['rssm_chain']['bound_ms']:.4f}", bound_by=record["rssm_chain"]["bound_by"],
          prior_shape=f"({ag[1].shape[0]},{ag[1].shape[1]})", prior_kernel_ms=f"{t10p['kernel']:.4f}",
          prior_plain_ms=f"{t10p['plain']:.4f}", prior_us_per_step=f"{t10p['kernel'] * 1e3 / ag[1].shape[1]:.3f}")

    blocks = model.cwvae.encoder.levels[0] + model.cwvae.decoder.levels[0]
    k11_ms = k11_plain_ms = k11_lib_ms = gemm_ms = 0.0
    bytes_k11 = flops_k11 = gemm_flops = 0
    for label, (a, k), block in zip(labels[:6], k11_calls[:6], blocks):
        inputs = [a[0]] + [a[0] + 0.01 * torch.randn(a[0].shape, generator=gen, device=dev)]

        def kern(u, a=a, k=k):
            with torch.no_grad():
                depthwise.depthwise_norm(u, *a[1:], **k)

        def twin_(u, a=a, k=k):
            with torch.no_grad():
                depthwise.depthwise_norm_plain(u, *a[1:], **k)

        def lib_(u, a=a, k=k):
            with torch.no_grad():
                depthwise_composite((u, *a[1:]), k)

        t = alternate(twin_, kern, inputs, warmup=1)
        t_lib = alternate(lib_, kern, inputs, warmup=1)
        B_, N_in, C = a[0].shape
        N_out = depthwise.output_length(N_in, 5, k["stride"], k["dilation"], k["transposed"])
        w1, w2 = block.Conv1d_0.kernel[0].detach(), block._DepthwiseSeparable_0.Conv1d_0.kernel[0].detach()
        x_in = torch.randn(B_, N_in, H, generator=gen, device=dev)
        z_out = torch.randn(B_, N_out, C, generator=gen, device=dev)

        def gemms(_, x_in=x_in, z_out=z_out, w1=w1, w2=w2):
            with torch.no_grad():
                torch.addmm(block.Conv1d_0.bias, x_in.reshape(-1, H), w1)
                z_out.reshape(-1, C) @ w2

        t_gemm = cuda_time_ms(gemms, [None] * 4, warmup=1)
        t_gemm = sorted(t_gemm)[len(t_gemm) // 2]
        work = depthwise_work(B_, N_in, N_out, C, 5)
        b_ = roofline(**work, peak=F32_PEAK)
        g_flops = 2 * B_ * (N_in + N_out) * H * C
        k11_ms, k11_plain_ms, k11_lib_ms, gemm_ms = (k11_ms + t["kernel"], k11_plain_ms + t["plain"],
                                                     k11_lib_ms + t_lib["plain"], gemm_ms + t_gemm)
        bytes_k11, flops_k11, gemm_flops = bytes_k11 + work["bytes_"], flops_k11 + work["flops"], gemm_flops + g_flops
        phase("time-K11", card=card, block=label, u=f"({B_},{N_in},{C})", out_rows=N_out, kernel_ms=f"{t['kernel']:.4f}",
              plain_ms=f"{t['plain']:.4f}", composite_ms=f"{t_lib['plain']:.4f}", bound_ms=f"{b_['bound_ms']:.4f}",
              bound_by=b_["bound_by"], gemms_ms=f"{t_gemm:.4f}",
              gemms_bound_ms=f"{g_flops / F32_PEAK * 1e3:.4f}")
    record["depthwise_norm"].update(ms=k11_ms, plain_ms=k11_plain_ms, library_ms=None,
                                    **roofline(bytes_k11, flops_k11, F32_PEAK))
    phase("time-K11-forward", card=card, blocks=6, kernel_ms=f"{k11_ms:.4f}", plain_ms=f"{k11_plain_ms:.4f}",
          composite_ms=f"{k11_lib_ms:.4f}", bound_ms=f"{record['depthwise_norm']['bound_ms']:.4f}",
          bound_by=record["depthwise_norm"]["bound_by"], gemms_ms=f"{gemm_ms:.4f}",
          gemms_GFLOP=f"{gemm_flops / 1e9:.1f}", gemms_bound_ms=f"{gemm_flops / F32_PEAK * 1e3:.4f}")
    del k11_calls, k10_calls

    # 60. the test pass (whole: samples/s; split) and a generation (frames/s), and torch.profiler breakdowns
    test_s = {False: [], True: []}
    for split in (False, True):
        for _ in range(3 if not split else 2):
            test_s[split].append(test_pass(split)[2])
    gen_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(GEN_B, args.generate_frames, use_mode_observations=True,
                       generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    scored = int(x_sl_np.sum())
    phase("time-cwvae-test-pass-and-generate", card=card, test_pass_samples=scored,
          test_pass_s=[f"{v:.4f}" for v in test_s[False]], split_eval_s=[f"{v:.4f}" for v in test_s[True]],
          test_samples_per_s=f"{scored / min(test_s[False]):.0f}", generate_frames=args.generate_frames,
          generate_s=[f"{v:.4f}" for v in gen_s], generate_frames_per_s=f"{GEN_B * args.generate_frames / min(gen_s):.0f}")
    profiled(lambda: test_pass(False), "profile-cwvae-test-pass", 1, "pass", card)
    profiled(lambda: model.generate(GEN_B, args.generate_frames, use_mode_observations=True,
                                    generator=torch.Generator(device=dev).manual_seed(SEED)),
             "profile-cwvae-generate", 1, "generation", card)
    del model, model2
    torch.cuda.empty_cache()
    require(not failures, f"CW-VAE phases failed: {failures}")


def cwvae_train_phases(record, smi, dev):
    """Phases 61-65, the CW-VAE train step at the width of ``experiments/benchmarks.txt:33`` (d = 192, z = 128,
    strides [64], the precision-weighted posterior, 3 encoder and 3 decoder blocks expanding 192 -> 768 with k = 5
    and stride 4, DMoL 10 x 2^16, f32, the beta and free-nats annealers, Adam): K11-bwd and K10-bwd against the f64
    twins at the shapes the step gives them, three steps of the driver's ``train``, the step-0 gradients, and their
    times. Each check is printed before any raises."""
    import copy

    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import clockwork_audio, common
    from blvm_tpu_torch.models.clockwork_vae import clockwork_vae as cw_model
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import cuda, depthwise, likelihoods, recurrent, rssm, variational
    from blvm_tpu_torch.training.train_state import TrainState
    from blvm_tpu_torch.training.train_step import make_train_step

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    args = clockwork_audio.build_args(CWVAE_FLAGS.split())
    targs = argparse_copy(args, epochs=1)
    model = clockwork_audio.build_model(args)
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    H, Z = args.hidden_size[0], args.latent_size[0]
    head = model.cwvae.cells[0].prior_head
    chain_kw = dict(residual_posterior=False, precision_posterior=True, sd_beta=head.beta, sd_epsilon=head.epsilon)

    # the train batches: 5 utterances of 46k-51k samples a step within the --batch_len budget
    rng = np.random.default_rng(args.seed + 61)
    train_batches = []
    for i in range(3):
        lengths = rng.integers(CWVAE_TRAIN_LENGTHS[0], CWVAE_TRAIN_LENGTHS[1] + 1, CWVAE_TRAIN_B)
        require(lengths.sum() <= CWVAE_BUDGET, f"the train batch {lengths} exceeds --batch_len")
        train_batches.append([(i * CWVAE_TRAIN_B + j, synthetic_speech(int(n), rng)) for j, n in enumerate(lengths)])
    step_batches = []
    for b_ in train_batches:
        xb_, slb_ = common.make_batch([w for _, w in b_], targs)
        step_batches.append(dict(x=torch.from_numpy(xb_).to(dev), x_sl=torch.from_numpy(slb_).to(dev),
                                 kwargs=dict(pad_strideable=True)))
    x0, sl0 = step_batches[0]["x"], step_batches[0]["x_sl"]

    def seeded_noise(seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return mock.patch.object(cw_model, "gaussian_noise", lambda _, shape, like: torch.randn(
            shape, generator=g_, device=like.device).to(like.dtype))

    # the first train batch's calls of K11 and K10 (the train loss's same padding), and a --split_eval chunk's
    k11_calls, k11_patch = recorded(depthwise, "depthwise_norm")
    k10_calls, k10_patch = recorded(rssm, "rssm_chain")
    x_np0, sl_np0 = common.make_batch([w for _, w in train_batches[0]], targs)
    chunks, chunk_lens = model.split_sequence(x_np0, sl_np0, length=4 * model.overall_stride)
    with torch.no_grad(), k11_patch, k10_patch, seeded_noise(SEED + 61):
        model(x0, sl0, pad_strideable=True)
        model(torch.from_numpy(chunks[0]).to(dev), torch.from_numpy(chunk_lens[0]).to(dev), pad_strideable=False,
              pad_same=False)
    require(len(k11_calls) == 12 and len(k10_calls) == 2, f"K11 calls {len(k11_calls)}, K10 calls {len(k10_calls)}")
    labels6 = [f"enc{i}" for i in range(3)] + [f"dec{i}" for i in range(3)]

    # 61. K11-bwd against its twins: the first train batch's six blocks, the chunk's top encoder block (a handful of
    # rows) and the first block with row 1 all padding (u constant along time, as x = 0 expands to the 1x1's bias,
    # and no output gradient). The kernel (through DepthwiseNormFunction: K11 in save mode, one K11-bwd) and
    # autograd of the f32 twin both held to autograd of the f64 twin: every gradient's largest error, relative to
    # its largest value, at most twice the f32 twin's plus 1e-6. Then K11-bwd alone against its f64 twin on the
    # kernel's own saved statistics at the six train shapes
    names11 = ("u", "scale1", "bias1", "kernel", "depthwise_bias", "scale2", "bias2")

    def k11_grads(a, k, dz, dtype, kernel):
        leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in a]
        fn = depthwise.depthwise_norm if kernel else depthwise.depthwise_norm_plain
        return torch.autograd.grad((fn(*leaves, **k) * dz.to(dtype)).sum(), leaves)

    a_first, k_first = k11_calls[0]
    u_pad = a_first[0].detach().clone()
    u_pad[1] = u_pad[1, :1]
    cases11 = ([(f"train_{lb}", a, k) for lb, (a, k) in zip(labels6, k11_calls[:6])]
               + [("chunk_enc2", *k11_calls[8]), ("train_enc0_padding_row", (u_pad, *a_first[1:]), k_first)])
    for label, a, k in cases11:
        B_, N_in, C = a[0].shape
        N_out = depthwise.output_length(N_in, a[3].shape[0], k["stride"], k["dilation"], k["transposed"])
        dz = torch.randn(B_, N_out, C, generator=gen, device=dev)
        if label.endswith("padding_row"):
            dz[1] = 0.0
        cuda.reset_launch_counts()
        got = k11_grads(a, k, dz, torch.float32, True)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        twin = k11_grads(a, k, dz, torch.float32, False)
        ref = k11_grads(a, k, dz, torch.float64, False)
        errs, finite, over = held_to_f64(got, twin, ref, names11)
        pad_zero = not label.endswith("padding_row") or not bool(got[0][1].abs().any())
        expect(finite and not over and pad_zero and (counts["depthwise_norm"], counts["depthwise_norm_bwd"]) == (1, 1),
               f"K11-bwd {label}: launches {counts['depthwise_norm']}/{counts['depthwise_norm_bwd']}, finite {finite}, "
               f"over {over}, padding row's du zero {pad_zero}")
        worst = max(errs, key=lambda k_: errs[k_][0])
        phase("K11-bwd", case=label, u=tuple(a[0].shape), out_rows=N_out, stride=k["stride"],
              transposed=k["transposed"], launches=counts["depthwise_norm_bwd"],
              kernel_max_rel_vs_f64=f"{errs[worst][0]:.3g}", twin_f32_max_rel_vs_f64=f"{max(v[1] for v in errs.values()):.3g}",
              worst=worst, twin_at_worst=f"{errs[worst][1]:.3g}",
              **({"padding_row_du_zero": pad_zero} if label.endswith("padding_row") else {}))
        del got, twin, ref, dz
    del u_pad
    torch.cuda.empty_cache()
    k11b_err = 0.0
    saved11 = []
    for label, (a, k) in zip(labels6, k11_calls[:6]):
        B_, N_in, C = a[0].shape
        N_out = depthwise.output_length(N_in, a[3].shape[0], k["stride"], k["dilation"], k["transposed"])
        with torch.no_grad():
            _, stats = depthwise.depthwise_norm_save(*a, **k)
            dz = torch.randn(B_, N_out, C, generator=gen, device=dev)
            got = depthwise.depthwise_norm_backward(dz, *a[:6], stats, **k)
            ref = depthwise.depthwise_norm_backward_plain(dz.double(), *(t.double() for t in a[:6]), stats.double(),
                                                          **k)
        err = max((g_.double() - r_).abs().max().item() for g_, r_ in zip(got, ref))
        scale = max(r_.abs().max().item() for r_ in ref)
        expect(err <= 1e-4 * scale, f"K11-bwd alone {label} vs its f64 twin: {err} (largest {scale})")
        k11b_err = max(k11b_err, err)
        saved11.append(stats)
        phase("K11-bwd-alone", case=f"train_{label}", max_abs_err_vs_f64=f"{err:.3g}", largest=f"{scale:.3g}")
        del got, ref, dz
    record["depthwise_norm_bwd"]["max_abs_err"] = k11b_err
    torch.cuda.empty_cache()

    # 62. K10-bwd against its twin the same way: the train step's hoisted products (5, T') with the precision
    # posterior and gradients of all six outputs (zero past each row's steps), H = 32 and Z = 16 with a given (z0,
    # h0) and no gradient for h and enc_sd, and a reset every 4 steps (11 rows: two passes of 8); K10's save mode
    # against the plain launch at the train shape (bitwise); then K10-bwd alone against its f64 twin
    a10, k10kw = k10_calls[0]
    kernel_w = [t.detach() for t in a10[0]]
    xg0, xq0, z00, h00 = (t.detach() for t in a10[1:5])
    B0, T0 = xg0.shape[:2]
    steps0 = torch.ceil(sl0.double() / model.overall_stride).long()
    ragged = (torch.arange(T0, device=dev)[None] < steps0[:, None])[..., None].float()
    covered = int(steps0.clamp_max(T0).sum())
    require(k10kw["inference"] and k10kw["precision_posterior"] and not k10kw["residual_posterior"],
            f"the train forward's K10 call: {k10kw}")
    widths = (Z, H, Z, Z, Z, Z)

    def k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, dtype, kernel):
        leaves = [t.detach().to(dtype).clone().requires_grad_(True) for t in (xg, xq, z0, h0, *w)]
        fn = rssm.rssm_chain if kernel else rssm.rssm_chain_plain
        outs = fn(leaves[4:], *leaves[:4], eps.to(dtype), resets, inference=True, **chain_kw)
        loss = sum((o * g_.to(dtype)).sum() for o, g_ in zip(outs, g_out) if g_ is not None)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(t) if g_ is None else g_ for g_, t in zip(grads, leaves)]

    g_small = torch.Generator().manual_seed(SEED + 62)

    def k10_small(B_, T_, H_, Z_):
        def u(*shape, fan_in):
            return ((torch.rand(*shape, generator=g_small) * 2 - 1) / fan_in**0.5).to(dev)

        w = [u(Z_, H_, fan_in=Z_), u(H_, 3 * H_, fan_in=H_), u(3 * H_, fan_in=H_), u(H_, 3 * H_, fan_in=H_),
             u(3 * H_, fan_in=H_)]
        for first in (True, False):
            layers = [t for _ in range(3) for t in (u(H_, H_, fan_in=H_), u(H_, fan_in=H_))]
            if not first:
                del layers[1]  # the posterior's first bias is in xq
            w += layers + [u(H_, 2 * Z_, fan_in=H_), u(2 * Z_, fan_in=H_)]
        return (w, *((torch.randn(B_, T_, H_, generator=g_small) * 0.5).to(dev) for _ in range(2)),
                (torch.randn(B_, Z_, generator=g_small) * 0.5).to(dev),
                (torch.randn(B_, H_, generator=g_small) * 0.5).to(dev))

    cases10 = {
        "train_B5": ((kernel_w, xg0, xq0, z00, h00), None, ()),
        "H32_Z16_given_state": (k10_small(3, 40, 32, 16), None, (1, 3)),
        "resets_every_4": (k10_small(11, 30, 64, 16), torch.arange(30, device=dev) % 4 == 0, ()),
    }
    names10 = ["xg", "xq", "z0", "h0"] + [f"w{i}" for i in range(rssm.N_KERNEL_WEIGHTS)]
    for name, ((w, xg, xq, z0, h0), resets, no_grad) in cases10.items():
        B_, T_, H_ = xg.shape
        Z_ = z0.shape[1]
        mask = ragged if name == "train_B5" else 1.0
        eps = torch.randn(B_, T_, Z_, generator=gen, device=dev)
        g_out = [None if i in no_grad else torch.randn(B_, T_, H_ if i == 1 else Z_, generator=gen, device=dev) * mask
                 for i in range(6)]
        cuda.reset_launch_counts()
        got = k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, torch.float32, True)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        twin = k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, torch.float32, False)
        ref = k10_grads(w, xg, xq, z0, h0, eps, resets, g_out, torch.float64, False)
        errs, finite, over = held_to_f64(got, twin, ref, names10)
        expect(finite and not over and (counts["rssm_chain"], counts["rssm_chain_bwd"]) == (1, 1),
               f"K10-bwd {name}: launches {counts['rssm_chain']}/{counts['rssm_chain_bwd']}, finite {finite}, over {over}")
        worst = max(errs, key=lambda k_: errs[k_][0])
        phase("K10-bwd", case=name, shape=tuple(xg.shape), Z=Z_, resets=resets is not None,
              no_gradient=[rssm.RSSMChainOutputs._fields[i] for i in no_grad], launches=counts["rssm_chain_bwd"],
              kernel_max_rel_vs_f64=f"{errs[worst][0]:.3g}", twin_f32_max_rel_vs_f64=f"{max(v[1] for v in errs.values()):.3g}",
              worst=worst, twin_at_worst=f"{errs[worst][1]:.3g}")
        del got, twin, ref
    with torch.no_grad():
        eps10 = torch.randn(B0, T0, Z, generator=gen, device=dev)
        plain10 = rssm.rssm_chain(kernel_w, xg0, xq0, z00, h00, eps10, inference=True, **chain_kw)
        outs10, saved10 = rssm.rssm_chain_save(kernel_w, xg0, xq0, z00, h00, eps10, **chain_kw)
        same10 = all(torch.equal(a_, b_) for a_, b_ in zip(plain10, outs10))
        g10 = [torch.randn(B0, T0, w_, generator=gen, device=dev) * ragged for w_ in widths]
        got10 = rssm.rssm_chain_backward(kernel_w, eps10, saved10, outs10.h, h00, None, g10, **chain_kw)
        ref10 = rssm.rssm_chain_backward_plain([t.double() for t in kernel_w], eps10.double(), saved10.double(),
                                               outs10.h.double(), h00.double(), None, [g_.double() for g_ in g10],
                                               **chain_kw)
    k10b_err = max((a_.double() - r_).abs().max().item() for a_, r_ in zip(got10, ref10))
    scale = max(r_.abs().max().item() for r_ in ref10)
    expect(same10, "K10's save mode changed its outputs")
    expect(k10b_err <= 1e-4 * scale, f"K10-bwd alone vs its f64 twin: {k10b_err} (largest {scale})")
    record["rssm_chain_bwd"]["max_abs_err"] = k10b_err
    phase("K10-bwd-alone", case="train_B5", shape=(B0, T0), max_abs_err_vs_f64=f"{k10b_err:.3g}",
          largest=f"{scale:.3g}", save_bitwise_equal=same10, saved_MB=f"{saved10.numel() * 4 / 2**20:.1f}",
          dpre_MB=f"{got10[0].numel() * 4 / 2**20:.1f}")
    del got10, ref10, plain10, k10_calls
    torch.cuda.empty_cache()

    # 63. the train slice: flags of benchmarks.txt:33 -> driver -> model on the card -> weights bridge ->
    # clockwork_audio.train with its annealers, 3 Adam steps; the latent noise from a generator of its own, alike for
    # the kernel and the plain runs (autograd of the twins)
    def run_train(plain_path_=False):
        weights.load_jax_params(model, params)
        log = StepLog(Tracker())
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise(SEED + 63):
            cuda.reset_launch_counts()
            t0 = time.time()
            clockwork_audio.train(model, targs, train_batches, log)
            torch.cuda.synchronize()
            return log.steps, cuda.launch_counts(), time.time() - t0

    steps_k, counts, seconds = run_train()
    steps_p, counts_p, seconds_p = run_train(plain_path_=True)
    expected = dict(rssm_chain=3, rssm_chain_bwd=3, depthwise_norm=18, depthwise_norm_bwd=18, dmol_log_prob=3,
                    dmol_log_prob_bwd=3, dmol_sample=3)
    expect(counts == {**dict.fromkeys(counts, 0), **expected},
           f"CW-VAE train-step launches {counts}, expected {expected} (1/1/6/6/1/1/1 a step)")
    expect(not any(counts_p.values()), f"the plain CW-VAE train path launched kernels: {counts_p}")
    for k in ("rssm_chain", "depthwise_norm"):
        record[k]["launches"] = record[k].get("launches", 0) + counts[k]
    record["rssm_chain_bwd"]["launches"] = counts["rssm_chain_bwd"]
    record["depthwise_norm_bwd"]["launches"] = counts["depthwise_norm_bwd"]
    losses, losses_p = [st["loss"] for st in steps_k], [st["loss"] for st in steps_p]
    loss_rel = [abs(a_ - b_) / abs(b_) for a_, b_ in zip(losses, losses_p)]
    expect(all(math.isfinite(v) for st in steps_k for v in st.values()), f"CW-VAE train metrics not finite: {steps_k}")
    # the same parameters at step 0, only the sums' order differs; Adam's first updates move every parameter by about
    # lr sign(g), so a gradient element near zero whose sign the summation order flipped would show in later steps
    expect(max(loss_rel) <= 1e-5, f"CW-VAE train losses {losses} vs plain {losses_p}")
    ref_annealers = clockwork_audio.build_annealers(targs)
    ref_values = [{k: float(np.float32(a.step())) for k, a in ref_annealers.items()} for _ in range(3)]
    got_values = [{k: st[k] for k in ("beta", "free_nats")} for st in steps_k]
    expect(got_values == ref_values and got_values[0] == dict(beta=0.0, free_nats=2.0),
           f"annealers {got_values}, expected {ref_values}")
    phase("cwvae-train-slice", steps=3, utterances_per_step=CWVAE_TRAIN_B,
          samples_per_step=[sum(len(w) for _, w in b_) for b_ in train_batches],
          top_steps_per_step=[int(math.ceil(b_["x_sl"].max().item() / model.overall_stride)) for b_ in step_batches],
          losses=[f"{v:.6f}" for v in losses], losses_plain=[f"{v:.6f}" for v in losses_p],
          loss_rel=[f"{v:.3g}" for v in loss_rel], beta=[v["beta"] for v in got_values],
          free_nats=[v["free_nats"] for v in got_values], launches_per_step={k: v // 3 for k, v in counts.items() if v},
          seconds=f"{seconds:.2f}", seconds_plain=f"{seconds_p:.2f}")

    # 64. the step-0 gradients of every parameter on the first batch, at the driver's first scalars (beta 0, free
    # nats 2: the KL's gradient cut) and at beta 1, free nats 0 (every head's backward live): the kernels and the
    # f32 twins both held to the f64 twins, the kernels no further than twice the f32 twins plus 1e-6 (relative
    # norms)
    def step0_grads(m, plain_path_, dtype, scalars):
        m.zero_grad(set_to_none=True)
        m.train()
        with plain() if plain_path_ else contextlib.nullcontext(), seeded_noise(SEED + 64):
            loss, _, _ = m(x0.to(dtype), sl0, pad_strideable=True, generator=torch.Generator(device=dev).manual_seed(SEED),
                           **scalars)
            loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return grads, loss.item()

    for label, scalars in (("driver_step0", ref_values[0]), ("beta1_free_nats0", dict(beta=1.0, free_nats=0.0))):
        weights.load_jax_params(model, params)
        g_k, loss_k = step0_grads(model, False, torch.float32, scalars)
        g_p, loss_p = step0_grads(model, True, torch.float32, scalars)
        model64 = copy.deepcopy(model).double()
        g_64, loss_64 = step0_grads(model64, True, torch.float64, scalars)
        del model64
        e_k = {n: rel_norm(g_k[n], g_64[n]) for n in g_64}
        e_p = {n: rel_norm(g_p[n], g_64[n]) for n in g_64}
        over = {n: (e_k[n], e_p[n]) for n in e_k if e_k[n] > 2 * e_p[n] + 1e-6}
        expect(all(torch.isfinite(g_).all() for g_ in g_k.values()) and not over,
               f"CW-VAE step-0 gradients at {label}: {over}")
        worst = max(e_k, key=e_k.get)
        phase("cwvae-train-grads", scalars=label, beta=scalars["beta"], free_nats=scalars["free_nats"],
              loss=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}", loss_f64=f"{loss_64:.6f}",
              kernel_max_rel_vs_f64=f"{e_k[worst]:.3g}", twin_f32_max_rel_vs_f64=f"{max(e_p.values()):.3g}",
              worst=worst, twin_at_worst=f"{e_p[worst]:.3g}", parameters=len(e_k))
        del g_k, g_p, g_64
        torch.cuda.empty_cache()

    # 65. times, CUDA events, a different input each call, kernel and twin in turns: K10 in save mode against the
    # plain launch at the train shape; K10-bwd alone against its twin, and the chain's whole backward (the kernel,
    # the weight GEMMs); K11-bwd alone at the six block shapes against its twin and against autograd of the
    # composite of PyTorch calls for the same chain (the yardstick; the port never calls it); the train step against
    # one call of the twins' path; the step's host enqueue, peak memory and a torch.profiler breakdown
    eps_t = [torch.randn(B0, T0, Z, generator=gen, device=dev) for _ in range(3)]

    def k10_launch(e_):
        with torch.no_grad():
            return rssm.rssm_chain(kernel_w, xg0, xq0, z00, h00, e_, inference=True, **chain_kw)

    def k10_save(e_):
        with torch.no_grad():
            return rssm.rssm_chain_save(kernel_w, xg0, xq0, z00, h00, e_, **chain_kw)

    t10s = alternate(k10_launch, k10_save, eps_t)
    save_bound = roofline(**rssm_work(B0, T0, H, Z, save=True), peak=F32_PEAK)
    phase("time-K10-save", card=card, shape=f"({B0},{T0})", dtype="f32", save_ms=f"{t10s['kernel']:.4f}",
          no_save_ms=f"{t10s['plain']:.4f}", us_per_step_save=f"{t10s['kernel'] * 1e3 / T0:.3f}",
          ratio=f"{t10s['kernel'] / t10s['plain']:.4f}", save_bound_ms=f"{save_bound['bound_ms']:.4f}",
          save_bound_by=save_bound["bound_by"])
    g10s = [[torch.randn(B0, T0, w_, generator=gen, device=dev) * ragged for w_ in widths] for _ in range(2)]

    def k10b(g_):
        return rssm.rssm_chain_backward(kernel_w, eps10, saved10, outs10.h, h00, None, g_, **chain_kw)

    def k10b_plain(g_):
        return rssm.rssm_chain_backward_plain(kernel_w, eps10, saved10, outs10.h, h00, None, g_, **chain_kw)

    t10b = alternate(k10b_plain, k10b, g10s, warmup=1)

    def backward_only(graph):
        outputs, inputs, grad_outputs = graph
        return torch.autograd.grad(outputs, inputs, grad_outputs, retain_graph=True)

    leaves = [t.detach().clone().requires_grad_(True) for t in (xg0, xq0, *kernel_w)]
    outs_ = rssm.rssm_chain(leaves[2:], leaves[0], leaves[1], z00, h00, eps10, inference=True, **chain_kw)
    graph10 = (tuple(outs_), leaves, tuple(g10s[0]))
    t10_fn = sorted(cuda_time_ms(backward_only, [graph10] * 3, warmup=1))[1]
    del graph10, outs_, leaves
    record["rssm_chain_bwd"].update(ms=t10b["kernel"], plain_ms=t10b["plain"], library_ms=None,
                                    **roofline(**rssm_bwd_work(B0, T0, H, Z, covered), peak=F32_PEAK))
    phase("time-K10-bwd", card=card, shape=f"({B0},{T0})", H=H, Z=Z, dtype="f32", kernel_ms=f"{t10b['kernel']:.4f}",
          plain_ms=f"{t10b['plain']:.4f}", us_per_step=f"{t10b['kernel'] * 1e3 / T0:.3f}",
          chain_backward_ms=f"{t10_fn:.4f}", bound_ms=f"{record['rssm_chain_bwd']['bound_ms']:.4f}",
          bound_by=record["rssm_chain_bwd"]["bound_by"], covered_row_steps=covered,
          includes="kernel: K10-bwd alone; chain backward: also the 20 weight-gradient GEMMs and the bias product")
    del saved10, outs10, g10s

    k11b_ms = k11b_plain_ms = k11b_lib_ms = 0.0
    bytes_b = flops_b = 0
    for label, (a, k), stats in zip(labels6, k11_calls[:6], saved11):
        B_, N_in, C = a[0].shape
        N_out = depthwise.output_length(N_in, a[3].shape[0], k["stride"], k["dilation"], k["transposed"])
        dzs = [torch.randn(B_, N_out, C, generator=gen, device=dev) for _ in range(2)]

        def kern(dz, a=a, k=k, stats=stats):
            with torch.no_grad():
                depthwise.depthwise_norm_backward(dz, *a[:6], stats, **k)

        def twin_(dz, a=a, k=k, stats=stats):
            with torch.no_grad():
                depthwise.depthwise_norm_backward_plain(dz, *a[:6], stats, **k)

        t = alternate(twin_, kern, dzs, warmup=1)
        lib_leaves = [t_.detach().clone().requires_grad_(True) for t_ in a]
        lib_graph = ((depthwise_composite(lib_leaves, k),), lib_leaves, (dzs[0],))
        t_lib = sorted(cuda_time_ms(backward_only, [lib_graph] * 3, warmup=1))[1]
        del lib_graph, lib_leaves, dzs
        work = depthwise_bwd_work(B_, N_in, N_out, C, a[3].shape[0])
        b_ = roofline(**work, peak=F32_PEAK)
        k11b_ms, k11b_plain_ms, k11b_lib_ms = k11b_ms + t["kernel"], k11b_plain_ms + t["plain"], k11b_lib_ms + t_lib
        bytes_b, flops_b = bytes_b + work["bytes_"], flops_b + work["flops"]
        phase("time-K11-bwd", card=card, block=label, u=f"({B_},{N_in},{C})", out_rows=N_out,
              kernel_ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}", composite_backward_ms=f"{t_lib:.4f}",
              bound_ms=f"{b_['bound_ms']:.4f}", bound_by=b_["bound_by"])
    record["depthwise_norm_bwd"].update(ms=k11b_ms, plain_ms=k11b_plain_ms, library_ms=k11b_lib_ms,
                                        **roofline(bytes_b, flops_b, F32_PEAK))
    phase("time-K11-bwd-step", card=card, blocks=6, kernel_ms=f"{k11b_ms:.4f}", plain_ms=f"{k11b_plain_ms:.4f}",
          composite_backward_ms=f"{k11b_lib_ms:.4f}", bound_ms=f"{record['depthwise_norm_bwd']['bound_ms']:.4f}",
          bound_by=record["depthwise_norm_bwd"]["bound_by"])
    del k11_calls, saved11
    torch.cuda.empty_cache()

    # the train step, kernels against twins in turns on the first batch, the kernels alone over the three
    tx, _ = common.build_tx_and_lr(targs)
    weights.load_jax_params(model, params)
    model.train()
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(common.loss_fn)
    scalars = dict(beta=torch.tensor(0.5), free_nats=torch.tensor(2.0))

    def run_step(b_):
        train_step(state, b_, scalars)

    def run_step_plain(b_):
        with plain():
            train_step(state, b_, scalars)

    plain_step_ms = cuda_time_ms(run_step_plain, step_batches[:1], warmup=0)[0]
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_time_ms(run_step, step_batches)
    ts = sorted(step_ms)[1]
    torch.cuda.synchronize()
    enqueue = []
    for b_ in step_batches:
        t0 = time.perf_counter()
        run_step(b_)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    samples = sum(int(b_["x_sl"].sum()) for b_ in step_batches) / len(step_batches)
    phase("time-cwvae-train-step", card=card, utterances=CWVAE_TRAIN_B, samples=int(samples), kernel_ms=f"{ts:.3f}",
          kernel_ms_all=[f"{v:.3f}" for v in step_ms], plain_ms=f"{plain_step_ms:.3f}",
          host_enqueue_ms=f"{sorted(enqueue)[1]:.3f}", samples_per_s=f"{samples / ts * 1e3:.0f}",
          peak_memory_GB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # the driver's loop under the profiler (three steps, metrics read 8 steps late): the device's busy time by
    # kernel, and no host wait on the card inside the driver's step spans (the CUDA synchronizing calls, as phase 54
    # counts them: Adam's per-parameter step counters are host tensors, so their aten::item reads wait on nothing);
    # then one step under torch's sync debug mode, which raises on any synchronizing call
    def run_loop():
        with seeded_noise(SEED + 65):
            clockwork_audio.train(model, targs, train_batches, Tracker())

    checks = driver_step_checks(run_loop, lambda: run_step(step_batches[0]))
    kernels_ = checks["kernels"]
    busy_ms = sum(device_us(e_) for e_ in kernels_) / 1e3 / 3
    expect(checks["spans"] == 3 and not checks["waits"] and checks["sync_free"],
           f"CW-VAE train step: {checks['spans']} step spans, host waits inside them {sorted(set(checks['waits']))} "
           f"({len(checks['waits'])}), sync debug mode passed {checks['sync_free']}")
    phase("profile-cwvae-train-step", card=card, device_ms_per_step=f"{busy_ms:.3f}", step_ms=f"{ts:.3f}",
          idle_share=f"{1 - busy_ms / ts:.3f}" if busy_ms else "not measured",
          wall_ms_per_step_under_profiler=f"{checks['wall_ms'] / 3:.3f}",
          kernel_launches_per_step=sum(e_.count for e_ in kernels_), step_spans=checks["spans"],
          host_waits_in_steps=len(checks["waits"]), sync_debug_mode_step="passed" if checks["sync_free"] else "raised")
    for e_ in sorted(kernels_, key=device_us, reverse=True)[:14]:
        print(f"  {device_us(e_) / 1e3 / 3:9.3f} ms/step {e_.count // 3:5d} calls/step  {e_.key[:90]}", flush=True)
    del state, model, step_batches
    torch.cuda.empty_cache()
    require(not failures, f"CW-VAE train phases failed: {failures}")


def skip_checks(family, driver, model, params, targs, train_batches, train_step, step_batches, scalars, dev, expect):
    """The driver's train loop under ``--skip_nonfinite_updates`` (the SRNN driver's default; the optimizer decides the
    skip on the card): three steps under torch.profiler with no host wait inside the driver's step spans, one step
    clean under torch's sync debug mode, and a step whose gradient holds a NaN leaving the parameters as they were."""
    from blvm_tpu_torch import weights
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import common
    from blvm_tpu_torch.training.train_state import TrainState

    sargs = argparse_copy(targs, skip_nonfinite_updates=True)
    weights.load_jax_params(model, params)
    model.train()
    state = TrainState.create(model=model, tx=common.build_tx_and_lr(sargs)[0],
                              generator=torch.Generator(device=dev).manual_seed(SEED))
    checks = driver_step_checks(lambda: driver.train(model, sargs, train_batches, Tracker()),
                                lambda: train_step(state, step_batches[0], scalars))
    before = [p.detach().clone() for p in model.parameters()]
    state.optimizer.zero_grad()
    loss = common.loss_fn(model, state.generator, step_batches[0], scalars)[0]
    (loss * float("nan")).backward()
    applied = state.optimizer.step()
    kept = all(torch.equal(a, p.detach()) for a, p in zip(before, model.parameters()))
    expect(checks["spans"] == 3 and not checks["waits"] and checks["sync_free"] and not bool(applied) and kept,
           f"{family} train step under --skip_nonfinite_updates: {checks['spans']} step spans, host waits inside them "
           f"{sorted(set(checks['waits']))}, sync debug mode passed {checks['sync_free']}, a NaN step applied "
           f"{bool(applied)}, parameters kept {kept}")
    phase(f"{family}-train-skip-nonfinite", step_spans=checks["spans"], host_waits_in_steps=len(checks["waits"]),
          sync_debug_mode_step="passed" if checks["sync_free"] else "raised", nan_step_applied=bool(applied),
          parameters_kept=kept, notfinite_count=int(state.optimizer.notfinite_count),
          wall_ms_per_step_under_profiler=f"{checks['wall_ms'] / 3:.3f}")


def driver_step_checks(run_loop, run_step):
    """``run_loop()`` (a driver's loop over some steps) under torch.profiler, then ``run_step()`` once under torch's
    sync debug mode ("error", which raises on any synchronizing call). Returns the loop's ``driver.step`` spans, the
    host's waits on the card inside them (the CUDA synchronizing calls), its wall ms, its device kernels and whether
    the step passed the sync debug mode."""
    from torch.profiler import ProfilerActivity, profile

    from blvm_tpu_torch.experiments import common

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_loop()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, waits = 0, []
    for e_ in prof.events():
        if e_.device_type != torch.autograd.DeviceType.CPU:
            continue
        spans += e_.name == common.STEP_SPAN
        if e_.name in SYNC_EVENTS[:3]:
            parent = e_.cpu_parent
            while parent is not None and parent.name != common.STEP_SPAN:
                parent = parent.cpu_parent
            if parent is not None:
                waits.append(e_.name)
    try:
        torch.cuda.set_sync_debug_mode("error")
        run_step()
        sync_free = True
    except RuntimeError as err:
        sync_free = False
        print(f"  sync debug mode: {err}", flush=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(spans=spans, waits=waits, wall_ms=wall_ms, kernels=device_kernels(prof), sync_free=sync_free)


def phone_transcript(seconds, rng, phones):
    """A TIMIT ``.PHN`` text of ``seconds`` of speech: ~12 phones a second drawn from the phone set, each line
    ``start end phone`` in samples, ``h#`` at both ends (the driver's cleaner removes it)."""
    import numpy as np

    n = max(1, int(round(12 * seconds)))
    seq = ["h#"] + list(rng.choice(phones, n)) + ["h#"]
    edges = np.linspace(0, int(seconds * 16000), len(seq) + 1).astype(int)
    return "".join(f"{a} {b} {p}\n" for a, b, p in zip(edges[:-1], edges[1:], seq))


def bilstm_work(B, T, H, covered, backward=False):
    """``roofline`` keywords of one K6 launch (f32): xw, the mask and W_hh read once, out written once (in save mode
    also the gates and the carried state); each direction's h W_hh product over the row-steps the lengths cover.
    ``backward``: K6-bwd with the dW_hh and db_hh products (the Function's backward): the saved gates, c_prev, h_prev,
    the mask and d out read, d gates and the weight gradients written, the chain's and dW_hh's products."""
    G = 4 * H
    if not backward:
        return dict(bytes_=4 * (B * T * (2 * G + 1 + 2 * H) + 2 * (H * G + G)), flops=2 * 2 * covered * H * G)
    return dict(bytes_=4 * (B * T * (2 * G + 2 * H + 2 * H + 1 + 2 * H + 2 * G) + 2 * 2 * (H * G + G)),
                flops=2 * 2 * 2 * covered * H * G)


def ctc_work(T, K, N, frames, labels, save=False, backward=False):
    """``roofline`` keywords of one K13 launch over rows of ``frames`` frames and ``labels`` labels each (their
    lengths, clamped to T and N). A row of ls labels has 2 ls + 1 live states (phi_0..phi_ls, emit_0..emit_{ls-1});
    the rest of the N padded columns have no path to the loss, and no work on them is counted. K13: the
    log-probabilities of the covered frames (a frame's whole row of K, the sectors its blank and labels lie in), the
    int64 labels and two lengths a row read once, the f32 losses written once, and per covered frame and live
    position (ls + 1 a row) alpha's two logsumexps of three (10 operations each, an exp or a log counted as one).
    ``save``: alpha and beta, the live double states before every covered frame and after the last, written once,
    and beta's logsumexps of two and four (16 operations). ``backward``: K13-bwd runs no recursion: it reads alpha
    and beta at the live states after each covered frame, the labels, lengths and the losses' gradient, writes d lp
    (B, T, K) whole, and per covered frame and live state takes an exp and two sums (4 operations). The doubles are
    priced at ``F64_PEAK``; the bytes bound all three."""
    rows = [(min(max(int(z), 0), T), min(max(int(ls), 0), N)) for z, ls in zip(frames, labels)]
    B = len(rows)
    ints = 8 * (sum(ls for _, ls in rows) + 2 * B)
    if backward:
        live = sum(z * (2 * ls + 1) for z, ls in rows)
        return dict(bytes_=8 * 2 * live + ints + 4 * B + 4 * B * T * K, flops=4 * live)
    covered = sum(z for z, _ in rows)
    flops = sum(z * (ls + 1) for z, ls in rows) * (2 * 10 + (16 if save else 0))
    saved = 8 * 2 * sum((z + 1) * (2 * ls + 1) for z, ls in rows) if save else 0
    return dict(bytes_=4 * covered * K + ints + 4 * B + saved, flops=flops)


def asr_phases(record, smi, dev):
    """Phases 66-70, the CTC phoneme probe at the width of ``experiments/phoneme.txt:8`` (3 bidirectional layers of
    H = 256, 80 log-mel bins at hop 64, temporal dropout 0.3, 65 classes, CTC, f32): K6 and K6-bwd against their
    twins at the shapes the probe gives them, three train steps and the test pass through the driver, one step at
    ``:7``, and their times. Each check is printed before any raises."""
    import numpy as np

    from blvm_tpu_torch import weights
    from blvm_tpu_torch.data.tokens import TIMIT_PHONESET
    from blvm_tpu_torch.evaluation.tracker import Tracker
    from blvm_tpu_torch.experiments import asr_ctc
    from blvm_tpu_torch.models.wavenet import modules
    from blvm_tpu_torch.modules import distributions
    from blvm_tpu_torch.ops import ctc, cuda, likelihoods, recurrent, variational
    from blvm_tpu_torch.training.train_state import TrainState
    from blvm_tpu_torch.training.train_step import make_train_step

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)
            print(f"  FAIL: {message}", flush=True)

    card = smi.replace(" ", "_")
    plain = plain_path(modules, likelihoods, distributions, variational, recurrent)
    gen = torch.Generator(device=dev).manual_seed(SEED + 66)
    args = asr_ctc.build_args(ASR_FLAGS.split())
    targs = argparse_copy(args, epochs=1)
    token_map = asr_ctc.build_token_map(args)
    transforms = asr_ctc.build_transforms(args, token_map)
    rng = np.random.default_rng(args.seed + 66)

    def examples(seconds_range, budget, args_=args, transforms_=transforms):
        """Utterances of lengths drawn from ``seconds_range`` as the length samplers fill a batch: while the
        total stays within ``budget`` seconds."""
        seconds = rng.uniform(*seconds_range, int(budget / seconds_range[0]) + 1)
        seconds = seconds[np.cumsum(seconds) <= budget]
        return [asr_ctc.encode_example(synthetic_speech(int(s * 16000), rng), phone_transcript(s, rng, TIMIT_PHONESET),
                                       args_, token_map, transforms_) for s in seconds]

    # the train batches: ~38 utterances of 3.0-3.3 s (the sampler's 0.3 s pool) within --batch_len 120 s; a long one of
    # ~16 of 7.0-7.3 s; the eval batch: ~110 utterances of 1.5-5 s within the eval sampler's 3 x 120 s
    t0 = time.time()
    train_batches = [examples(ASR_TRAIN_SECONDS, args.batch_len) for _ in range(3)]
    long_batch = examples(ASR_LONG_SECONDS, args.batch_len)
    eval_batch = examples(ASR_EVAL_SECONDS, 3 * args.batch_len)
    features_s = time.time() - t0
    model = asr_ctc.build_model(args, input_size=args.n_mels, token_map=token_map)
    params = weights.random_jax_params(model, args.seed)
    weights.load_jax_params(model, params)
    H = args.hidden_size

    def upload(batch):
        return asr_ctc.upload_batch(asr_ctc.make_batch(batch, targs), dev)[0]

    def audio_seconds(batch):
        return sum(f.shape[0] for f, _ in batch) * args.hop_length / 16000

    named_batches = {"train": train_batches[0], "long": long_batch, "eval": eval_batch}
    on_card = {name: upload(b) for name, b in named_batches.items()}
    lengths = {name: torch.tensor([f.shape[0] for f, _ in b]) for name, b in named_batches.items()}
    calls = {}
    model.eval()
    for name, b in on_card.items():
        k6_calls, k6_patch = recorded(recurrent, "bilstm_recurrence")
        with torch.no_grad(), k6_patch:
            model(b["x"], b["x_sl"], b["y"], b["y_sl"])
        calls[name] = [a for a, _ in k6_calls]
    require(all(len(c) == args.num_layers for c in calls.values()), f"K6 calls a forward: {[len(c) for c in calls.values()]}")
    phase("asr-batches", features_seconds=f"{features_s:.2f}",
          **{f"{name}_shape": tuple(b["x"].shape) for name, b in on_card.items()},
          **{f"{name}_audio_s": f"{audio_seconds(b):.1f}" for name, b in named_batches.items()})

    # 66. K6 against its twin, free-running in f32, at layer 0 (D = 80) and layer 1 (D = 512) of the train, the long
    # and the eval batch: within K5's 1e-5, or, where the f32 twin itself lies further than that from the f64 twin,
    # within twice the f32 twin's error of the f64 twin
    k6_err = 0.0
    for name, layer_calls in calls.items():
        for layer in (0, 1):
            xw, w_hh, b_hh, mask = layer_calls[layer]
            cuda.reset_launch_counts()
            with torch.no_grad():
                got = recurrent.bilstm_recurrence(xw, w_hh, b_hh, mask)
                torch.cuda.synchronize()
                launches = cuda.launch_counts()["bilstm_recurrence"]
                twin = recurrent.bilstm_recurrence_plain(xw, w_hh, b_hh, mask)
                ref = recurrent.bilstm_recurrence_plain(xw.double(), w_hh.double(), b_hh.double(), mask)
            err = (got - twin).abs().max().item()
            err64, twin64 = ((t.double() - ref).abs().max().item() for t in (got, twin))
            zeros = not got[mask == 0].any()
            expect(launches == 1 and zeros and (err <= 1e-5 or err64 <= 2 * twin64 + 1e-6),
                   f"K6 {name} layer {layer}: launches {launches}, max err {err} vs twin, {err64} vs f64 (twin "
                   f"{twin64}), zeros past the lengths {zeros}")
            k6_err = max(k6_err, err)
            phase("K6", case=f"{name}_layer{layer}", xw=tuple(xw.shape), rows_steps=int(mask.sum().item()),
                  max_abs_err=f"{err:.3g}", kernel_vs_f64=f"{err64:.3g}", twin_f32_vs_f64=f"{twin64:.3g}",
                  zeros_past_lengths=zeros)
            del got, twin, ref
    record["bilstm_recurrence"]["max_abs_err"] = k6_err

    # 67. K6-bwd: the kernel (through BiLSTMRecurrenceFunction: K6 in save mode, one K6-bwd, the dW_hh and db_hh
    # products) and autograd of the f32 twin both held to autograd of the f64 twin, each gradient's largest error within
    # twice the f32 twin's plus 1e-6 of its largest value: the train batch's layer 0, its layer 1 with row 1 all
    # padding (its gradient exactly 0) and the long batch's layer 1; then K6-bwd alone against its f64 twin on the
    # kernel's own saved forward
    def k6_grads(a, d_out, fn, dtype):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in a[:3]]
        return torch.autograd.grad((fn(*leaves, a[3]) * d_out.to(dtype)).sum(), leaves)

    xw1, w1, b1, m1 = calls["train"][1]
    m_pad = m1.clone()
    m_pad[1] = 0.0
    cases67 = {"train_layer0": calls["train"][0], "train_layer1_padding_row": (xw1, w1, b1, m_pad),
               "long_layer1": calls["long"][1]}
    for name, a in cases67.items():
        d_out = torch.randn(*a[0].shape[:2], 2 * H, generator=gen, device=dev)
        cuda.reset_launch_counts()
        got = k6_grads(a, d_out, recurrent.bilstm_recurrence, torch.float32)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        twin = k6_grads(a, d_out, recurrent.bilstm_recurrence_plain, torch.float32)
        ref = k6_grads(a, d_out, recurrent.bilstm_recurrence_plain, torch.float64)
        errs, finite, over = held_to_f64(got, twin, ref, ("xw", "w_hh", "b_hh"))
        pad_zero = "padding" not in name or not bool(got[0][1].any())
        expect(finite and not over and pad_zero and (counts["bilstm_recurrence"], counts["bilstm_recurrence_bwd"]) == (1, 1),
               f"K6-bwd {name}: launches {counts['bilstm_recurrence']}/{counts['bilstm_recurrence_bwd']}, finite "
               f"{finite}, over {over}, padding row's gradient zero {pad_zero}")
        worst = max(errs, key=lambda k_: errs[k_][0])
        phase("K6-bwd", case=name, xw=tuple(a[0].shape), launches=counts["bilstm_recurrence_bwd"],
              kernel_max_rel_vs_f64=f"{errs[worst][0]:.3g}", twin_f32_max_rel_vs_f64=f"{max(v[1] for v in errs.values()):.3g}",
              worst=worst, twin_at_worst=f"{errs[worst][1]:.3g}",
              **({"padding_row_gradient_zero": pad_zero} if "padding" in name else {}))
        del got, twin, ref
    with torch.no_grad():
        _, gates1, h_prev1, c_prev1 = recurrent.bilstm_recurrence_save(xw1, w1, b1, m1)
        d_out1 = torch.randn(*xw1.shape[:2], 2 * H, generator=gen, device=dev)
        got = recurrent.bilstm_recurrence_backward(w1, m1, gates1, c_prev1, d_out1)
        ref = recurrent.bilstm_recurrence_backward_plain(w1.double(), m1, gates1.double(), c_prev1.double(),
                                                         d_out1.double())
    k6b_err = (got.double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    expect(k6b_err <= 1e-4 * scale, f"K6-bwd alone vs its f64 twin: {k6b_err} (largest {scale})")
    record["bilstm_recurrence_bwd"]["max_abs_err"] = k6b_err
    phase("K6-bwd-alone", case="train_layer1", max_abs_err_vs_f64=f"{k6b_err:.3g}", largest=f"{scale:.3g}")
    del got, ref
    torch.cuda.empty_cache()

    # K13 and K13-bwd against the twin (optax's recursion in plain PyTorch) on the train batch's logits, and with
    # two rows made special: one whose labels cannot fit its 3 frames (optax's finite log-epsilon score), one with
    # no frames and no labels (-0.0); then at N = 300 label columns, K13's wide path (3 warps a row, a named barrier
    # a frame), with the same two special rows; the losses within 1e-5 relative, the logits' gradient held to the
    # f64 twin
    b_train = on_card["train"]
    with torch.no_grad():
        logits_t = model(b_train["x"], b_train["x_sl"], b_train["y"], b_train["y_sl"])[2].logits
    z_special, ysl_special = b_train["x_sl"].clone(), b_train["y_sl"].clone()
    z_special[-2], z_special[-1], ysl_special[-1] = 3, 0, 0
    wide_z = torch.tensor([700, 680, 640, 3, 0], device=dev)
    wide_ysl = torch.tensor([230, 226, 213, 6, 0], device=dev)
    wide_y = torch.randint(1, logits_t.shape[2], (5, 300), generator=gen, device=dev)
    wide_y[torch.arange(300, device=dev)[None] >= wide_ysl[:, None]] = 0
    wide_logits = 2 * torch.randn(5, 700, logits_t.shape[2], generator=gen, device=dev)
    cases13 = {"train": (logits_t, b_train["x_sl"], b_train["y"], b_train["y_sl"]),
               "train_special_rows": (logits_t, z_special, b_train["y"], ysl_special),
               "wide_n300": (wide_logits, wide_z, wide_y, wide_ysl)}
    k13_err = k13b_err = 0.0
    for name, (logits_, z_, y_, ysl_) in cases13.items():
        row_w = torch.rand(logits_.shape[0], generator=gen, device=dev) + 0.5

        def run13(fn, dtype):
            lg = logits_.detach().to(dtype).requires_grad_(True)
            loss_ = fn(lg, z_, y_, ysl_)
            return loss_.detach(), torch.autograd.grad((loss_ * row_w.to(dtype)).sum(), lg)[0]

        cuda.reset_launch_counts()
        got, g_got = run13(ctc.ctc_loss, torch.float32)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        twin, g_twin = run13(ctc.ctc_loss_plain, torch.float32)
        ref, g_ref = run13(ctc.ctc_loss_plain, torch.float64)
        rel = ((got.double() - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
        g_err, g_twin_err = ((g.double() - g_ref).abs().max().item() for g in (g_got, g_twin))
        g_scale = g_ref.abs().max().item()
        special = name == "train" or (got[-2] > 9e4 and torch.signbit(got[-1]) and got[-1] == 0)
        expect((counts["ctc_loss"], counts["ctc_loss_bwd"]) == (1, 1) and rel <= 1e-5 and bool(special)
               and g_err <= 2 * g_twin_err + 1e-6 * g_scale and bool(torch.isfinite(g_got).all()),
               f"K13 {name}: launches {counts['ctc_loss']}/{counts['ctc_loss_bwd']}, losses rel {rel}, special rows "
               f"{got[-2:].tolist()}, gradient err {g_err} vs the f32 twin's {g_twin_err} (largest {g_scale})")
        k13_err = max(k13_err, (got.double() - ref).abs().max().item())
        k13b_err = max(k13b_err, g_err)
        phase("K13", case=name, logits=tuple(logits_.shape), labels=tuple(y_.shape), loss_rel_vs_f64=f"{rel:.3g}",
              twin_f32_rel_vs_f64=f"{((twin.double() - ref).abs() / ref.abs().clamp_min(1.0)).max().item():.3g}",
              grad_max_abs_err_vs_f64=f"{g_err:.3g}", twin_f32_grad_err_vs_f64=f"{g_twin_err:.3g}",
              last_rows=[f"{v:.6g}" for v in got[-2:].tolist()])
        del got, g_got, twin, g_twin, ref, g_ref
    del wide_logits
    record["ctc_loss"]["max_abs_err"] = k13_err
    record["ctc_loss_bwd"]["max_abs_err"] = k13b_err

    # 68. the train slice: flags of phoneme.txt:8 -> driver -> model on the card -> weights bridge -> asr_ctc.train,
    # 3 Adam steps (the clips, dropout from the train state's generator, so the twins' run draws the same masks)
    def run_train(plain_path_=False, batches=train_batches, args_=targs, model_=model, params_=params):
        weights.load_jax_params(model_, params_)
        log = StepLog(Tracker())
        with plain() if plain_path_ else contextlib.nullcontext():
            cuda.reset_launch_counts()
            t0 = time.time()
            asr_ctc.train(model_, args_, batches, log)
            torch.cuda.synchronize()
            return log.steps, cuda.launch_counts(), time.time() - t0

    steps_k, counts, seconds = run_train()
    steps_p, counts_p, seconds_p = run_train(plain_path_=True)
    expected = dict(bilstm_recurrence=3 * args.num_layers, bilstm_recurrence_bwd=3 * args.num_layers, ctc_loss=3,
                    ctc_loss_bwd=3)
    expect(counts == {**dict.fromkeys(counts, 0), **expected},
           f"probe train-step launches {counts}, expected {expected} (3/3/1/1 a step)")
    expect(not any(counts_p.values()), f"the plain probe train path launched kernels: {counts_p}")
    for k in expected:
        record[k]["launches"] = counts[k]
    losses, losses_p = [st["loss"] for st in steps_k], [st["loss"] for st in steps_p]
    loss_rel = [abs(a_ - b_) / abs(b_) for a_, b_ in zip(losses, losses_p)]
    expect(all(math.isfinite(v) for st in steps_k for v in st.values()), f"probe train metrics not finite: {steps_k}")
    # the same dropout masks and parameters at step 0; F.ctc_loss's backward sums with atomics in no fixed order
    expect(max(loss_rel) <= 1e-5, f"probe train losses {losses} vs plain {losses_p}")
    phase("asr-train-slice", steps=3, utterances_per_step=[len(b) for b in train_batches],
          audio_seconds_per_step=[f"{audio_seconds(b):.1f}" for b in train_batches],
          losses=[f"{v:.6f}" for v in losses], losses_plain=[f"{v:.6f}" for v in losses_p],
          loss_rel=[f"{v:.3g}" for v in loss_rel], wer=[f"{st['wer']:.4f}" for st in steps_k],
          cer=[f"{st['cer']:.4f}" for st in steps_k], launches_per_step={k: v // 3 for k, v in counts.items() if v},
          seconds=f"{seconds:.2f}", seconds_plain=f"{seconds_p:.2f}")

    # no host wait inside the driver's step spans (three steps, metrics read 8 steps late), one step clean under the
    # sync debug mode; the host's build_metrics on a step's metrics
    tx, _ = asr_ctc.common.build_tx_and_lr(targs)
    weights.load_jax_params(model, params)
    model.train()
    state = TrainState.create(model=model, tx=tx, generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(asr_ctc.loss_fn)
    step_batches = [upload(b) for b in train_batches]

    def run_step(b_):
        return train_step(state, b_, {})[1]

    checks = driver_step_checks(lambda: asr_ctc.train(model, targs, train_batches, Tracker()),
                                lambda: run_step(step_batches[0]))
    expect(checks["spans"] == 3 and not checks["waits"] and checks["sync_free"],
           f"probe train step: {checks['spans']} step spans, host waits inside them {sorted(set(checks['waits']))}, "
           f"sync debug mode passed {checks['sync_free']}")
    mets_host = {k: v.cpu().numpy() for k, v in run_step(step_batches[0]).items()}
    t0 = time.perf_counter()
    for _ in range(3):
        model.build_metrics(mets_host)
    build_metrics_ms = (time.perf_counter() - t0) * 1e3 / 3
    kernels_ = checks["kernels"]
    busy_ms = sum(device_us(e_) for e_ in kernels_) / 1e3 / 3

    # one step at phoneme.txt:7: stacked waveform frames (D = hop = 64), dropout 0
    wargs = argparse_copy(asr_ctc.build_args(ASR_WAVEFORM_FLAGS.split()), epochs=1)
    wbatch = examples(ASR_TRAIN_SECONDS, wargs.batch_len, wargs, asr_ctc.build_transforms(wargs, token_map))
    wmodel = asr_ctc.build_model(wargs, input_size=wargs.hop_length, token_map=token_map)
    wparams = weights.random_jax_params(wmodel, wargs.seed)
    wsteps, wcounts, _ = run_train(batches=[wbatch], args_=wargs, model_=wmodel, params_=wparams)
    wsteps_p, _, _ = run_train(plain_path_=True, batches=[wbatch], args_=wargs, model_=wmodel, params_=wparams)
    wrel = abs(wsteps[0]["loss"] - wsteps_p[0]["loss"]) / abs(wsteps_p[0]["loss"])
    expect((wcounts["bilstm_recurrence"], wcounts["bilstm_recurrence_bwd"], wcounts["ctc_loss"],
            wcounts["ctc_loss_bwd"]) == (3, 3, 1, 1) and wrel <= 1e-5,
           f"phoneme.txt:7 step: launches {wcounts}, loss {wsteps[0]['loss']} vs plain {wsteps_p[0]['loss']}")
    phase("asr-waveform-step", features=wbatch[0][0].shape[-1], frames=max(f.shape[0] for f, _ in wbatch),
          loss=f"{wsteps[0]['loss']:.6f}", loss_plain=f"{wsteps_p[0]['loss']:.6f}", loss_rel=f"{wrel:.3g}",
          launches={k: v for k, v in wcounts.items() if v})
    del wmodel

    # 69. the test pass over the eval batch through asr_ctc.evaluate: 3 K6 a forward; WER and CER against the twins';
    # an utterance decoded otherwise must hold a frame whose argmax differs where the twin's top two logits lie within
    # 1e-5 (or within twice the frame's logit error) of each other
    weights.load_jax_params(model, params)

    def run_eval(plain_path_=False):
        with plain() if plain_path_ else contextlib.nullcontext():
            cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = asr_ctc.evaluate(model, targs, [eval_batch], Tracker(), source="test")
            torch.cuda.synchronize()
            return result, cuda.launch_counts(), time.perf_counter() - t0

    res_k, counts_e, eval_s = run_eval()
    res_p, counts_ep, eval_s_p = run_eval(plain_path_=True)
    expect(counts_e == {**dict.fromkeys(counts_e, 0), "bilstm_recurrence": args.num_layers, "ctc_loss": 1},
           f"probe test pass launches {counts_e}, expected 3 K6 and 1 K13")
    expect(not any(counts_ep.values()), f"the plain probe test pass launched kernels: {counts_ep}")
    for k in ("bilstm_recurrence", "ctc_loss"):
        record[k]["launches"] += counts_e[k]
    b_eval = on_card["eval"]
    with torch.no_grad():
        logits_k = model(b_eval["x"], b_eval["x_sl"], b_eval["y"], b_eval["y_sl"])[2].logits
        with plain():
            logits_p = model(b_eval["x"], b_eval["x_sl"], b_eval["y"], b_eval["y_sl"])[2].logits
    differing = [i for i, (a_, b_) in enumerate(zip(res_k["hyps"], res_p["hyps"])) if a_ != b_]
    unexplained = []
    for i in differing:
        n = int(lengths["eval"][i])
        frames = (logits_k[i, :n].argmax(-1) != logits_p[i, :n].argmax(-1)).nonzero().flatten()
        top2 = logits_p[i, frames].topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1])
        err = (logits_k[i, frames] - logits_p[i, frames]).abs().max(-1).values
        if not bool((gap <= torch.clamp(2 * err, min=1e-5)).any()):
            unexplained.append(i)
    logit_err = (logits_k - logits_p).abs().max().item()
    expect(all(math.isfinite(res_k[k]) for k in ("loss", "wer", "cer")) and not unexplained
           and abs(res_k["loss"] - res_p["loss"]) <= 1e-5 * abs(res_p["loss"]),
           f"probe test pass {dict((k, res_k[k]) for k in ('loss', 'wer', 'cer'))} vs twins "
           f"{dict((k, res_p[k]) for k in ('loss', 'wer', 'cer'))}: utterances decoded otherwise {differing}, "
           f"unexplained {unexplained}")
    eval_audio_s = audio_seconds(eval_batch)
    phase("asr-test-pass", utterances=len(eval_batch), audio_seconds=f"{eval_audio_s:.1f}",
          frames=tuple(b_eval["x"].shape[:2]), loss=f"{res_k['loss']:.6f}", loss_plain=f"{res_p['loss']:.6f}",
          wer=f"{res_k['wer']:.6f}", wer_plain=f"{res_p['wer']:.6f}", cer=f"{res_k['cer']:.6f}",
          cer_plain=f"{res_p['cer']:.6f}", utterances_decoded_otherwise=len(differing),
          max_logit_err=f"{logit_err:.3g}", launches_per_forward={k: v for k, v in counts_e.items() if v},
          seconds=f"{eval_s:.3f}", seconds_plain=f"{eval_s_p:.3f}")
    del logits_k, logits_p

    # 70. times, CUDA events, a different input each call: K6 against its twin and torch.nn.LSTM(bidirectional) on
    # pack_padded_sequence (cuDNN, the yardstick; it also does the input projection, so the port's layer, the
    # projection GEMM and K6, stands beside it), at the train batch's layer 1 and the eval batch's (clusters in
    # waves); K6-bwd with the weight products against autograd of the twin and cuDNN's backward at the train batch;
    # K13 and K13-bwd; the train step and the test pass. A kernel's time is taken in turns with the library call's; its
    # twin, 30-500x slower, is timed once
    def once(fn, inp):
        return cuda_time_ms(fn, [inp], warmup=0)[0]

    def k6_timing(label, layer_calls, lengths, n_inputs=3, backward=True):
        xw, w_hh, b_hh, mask = layer_calls[1]
        B_, T_ = xw.shape[:2]
        D_ = 2 * H
        inputs = [torch.relu(torch.randn(B_, T_, D_, generator=gen, device=dev)) for _ in range(n_inputs)]
        layer = model.lstm
        w_ih = torch.cat([layer.fwd_1.w_ih_0, layer.bwd_1.w_ih_0], dim=1).detach()
        b_ih = torch.cat([layer.fwd_1.b_ih_0, layer.bwd_1.b_ih_0]).detach()
        xws = [x_ @ w_ih + b_ih for x_ in inputs]
        cudnn = torch.nn.LSTM(D_, H, batch_first=True, bidirectional=True).to(dev)
        with torch.no_grad():
            for d, suffix in enumerate(("", "_reverse")):
                getattr(cudnn, f"weight_ih_l0{suffix}").copy_(w_ih[:, d * 4 * H:(d + 1) * 4 * H].T)
                getattr(cudnn, f"weight_hh_l0{suffix}").copy_(w_hh[d].T)
                getattr(cudnn, f"bias_ih_l0{suffix}").copy_(b_ih[d * 4 * H:(d + 1) * 4 * H])
                getattr(cudnn, f"bias_hh_l0{suffix}").copy_(b_hh[d])
        packed = [torch.nn.utils.rnn.pack_padded_sequence(x_, lengths, batch_first=True, enforce_sorted=False)
                  for x_ in inputs]
        with torch.no_grad():
            ref_out, _ = torch.nn.utils.rnn.pad_packed_sequence(cudnn(packed[0])[0], batch_first=True, total_length=T_)
            ours = recurrent.bilstm_recurrence(xws[0], w_hh, b_hh, mask)
        cudnn_err = (ref_out - ours).abs().max().item()
        expect(cudnn_err <= 1e-4, f"the yardstick torch.nn.LSTM computes another function: max err {cudnn_err}")

        def k6(xw_):
            with torch.no_grad():
                recurrent.bilstm_recurrence(xw_, w_hh, b_hh, mask)

        def k6_plain(xw_):
            with torch.no_grad():
                recurrent.bilstm_recurrence_plain(xw_, w_hh, b_hh, mask)

        def library(pk):
            with torch.no_grad():
                cudnn(pk)

        t_lib = alternate(lambda p_: library(p_[0]), lambda p_: k6(p_[1]), list(zip(packed, xws)), warmup=1)
        t = dict(kernel=t_lib["kernel"], plain=once(k6_plain, xws[0]))
        layer_ms = sorted(cuda_time_ms(lambda x_: k6(x_ @ w_ih + b_ih), inputs, warmup=1))[len(inputs) // 2]
        covered = int(mask.sum().item())
        bound = roofline(**bilstm_work(B_, T_, H, covered), peak=F32_PEAK)
        phase("time-K6", card=card, batch=label, xw=f"({B_},{T_},{8 * H})", covered_row_steps=covered,
              kernel_ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
              cudnn_lstm_ms=f"{t_lib['plain']:.4f}", layer_ms=f"{layer_ms:.4f}",
              us_per_step=f"{t['kernel'] * 1e3 / T_:.3f}", bound_ms=f"{bound['bound_ms']:.4f}",
              bound_by=bound["bound_by"], cudnn_max_abs_err=f"{cudnn_err:.3g}")
        if not backward:
            return dict(t=t, t_lib=t_lib, bound=bound)

        def backward_only(graph):
            outputs, inputs_, grad_outputs = graph
            return torch.autograd.grad(outputs, inputs_, grad_outputs, retain_graph=True)

        def graph(fn, xw_):
            leaves = [xw_.detach().requires_grad_(True), w_hh.detach().requires_grad_(True),
                      b_hh.detach().requires_grad_(True)]
            out_ = fn(*leaves, mask)
            return (out_,), leaves, (torch.randn_like(out_),)

        graphs = [graph(recurrent.bilstm_recurrence, xw_) for xw_ in xws[:2]]
        tb = dict(kernel=sorted(cuda_time_ms(backward_only, graphs * 2, warmup=1))[2],
                  plain=once(backward_only, graph(recurrent.bilstm_recurrence_plain, xws[0])))

        def lib_graph(x_):
            leaves = [x_.detach().requires_grad_(True)] + list(cudnn.parameters())
            pk = torch.nn.utils.rnn.pack_padded_sequence(leaves[0], lengths, batch_first=True, enforce_sorted=False)
            out_ = cudnn(pk)[0].data
            return (out_,), leaves, (torch.randn_like(out_),)

        def layer_graph(x_):
            leaves = [t_.detach().requires_grad_(True) for t_ in (x_, w_ih, b_ih, w_hh, b_hh)]
            out_ = recurrent.bilstm_recurrence(leaves[0] @ leaves[1] + leaves[2], leaves[3], leaves[4], mask)
            return (out_,), leaves, (torch.randn_like(out_),)

        lib_graphs = [(lib_graph(x_), layer_graph(x_)) for x_ in inputs[:2]]
        tb_lib = alternate(lambda g_: backward_only(g_[0]), lambda g_: backward_only(g_[1]), lib_graphs, warmup=1)
        bound_b = roofline(**bilstm_work(B_, T_, H, covered, backward=True), peak=F32_PEAK)
        phase("time-K6-bwd", card=card, batch=label, xw=f"({B_},{T_},{8 * H})", kernel_ms=f"{tb['kernel']:.4f}",
              plain_ms=f"{tb['plain']:.4f}", cudnn_lstm_bwd_ms=f"{tb_lib['plain']:.4f}",
              layer_bwd_ms=f"{tb_lib['kernel']:.4f}", us_per_step=f"{tb['kernel'] * 1e3 / T_:.3f}",
              bound_ms=f"{bound_b['bound_ms']:.4f}", bound_by=bound_b["bound_by"],
              includes="kernel: K6-bwd + the dW_hh and db_hh GEMMs; cuDNN and layer: also dx, dW_ih, db_ih")
        del graphs, lib_graphs
        return dict(t=t, t_lib=t_lib, tb=tb, tb_lib=tb_lib, bound=bound, bound_b=bound_b)

    timing = k6_timing("train", calls["train"], lengths["train"])
    k6_timing("eval", calls["eval"], lengths["eval"], n_inputs=2, backward=False)  # the test pass runs no backward
    record["bilstm_recurrence"].update(ms=timing["t"]["kernel"], plain_ms=timing["t"]["plain"],
                                       library_ms=timing["t_lib"]["plain"], **timing["bound"])
    record["bilstm_recurrence_bwd"].update(ms=timing["tb"]["kernel"], plain_ms=timing["tb"]["plain"],
                                           library_ms=timing["tb_lib"]["plain"], **timing["bound_b"])

    # K13 and K13-bwd at the train batch against the twin and F.ctc_loss (the yardstick, given the host's lengths),
    # each in turns with it: the plain launch (the test pass's), save mode (alpha and beta: the train step's forward),
    # K13-bwd alone, and the train step's pair, save mode + K13-bwd, against F.ctc_loss's forward + backward
    y_t, z_t, ysl_t = (t.to(torch.int64).contiguous() for t in (b_train["y"], b_train["x_sl"], b_train["y_sl"]))
    z_host, ysl_host = tuple(lengths["train"].tolist()), tuple(int(v) for v in asr_ctc.make_batch(train_batches[0], targs)["y_sl"])
    lps = [torch.log_softmax(logits_t + 0.1 * torch.randn(logits_t.shape, generator=gen, device=dev), -1)
           for _ in range(3)]

    def k13(lp, save=False):
        with torch.no_grad():
            ctc._forward(lp, y_t, z_t, ysl_t, 0, save=save)

    def k13_plain(lp):
        with torch.no_grad():
            ctc.ctc_loss_plain(lp, z_t, y_t, ysl_t)

    def k13_library(lp):
        with torch.no_grad():
            F.ctc_loss(lp.transpose(0, 1), y_t, z_host, ysl_host, reduction="none")

    t13_lib = alternate(k13_library, k13, lps, warmup=1)
    t13 = dict(kernel=t13_lib["kernel"], plain=once(k13_plain, lps[0]))
    t13s_lib = alternate(k13_library, lambda lp: k13(lp, save=True), lps, warmup=1)

    def ctc_graph(fn, lp):
        leaf = lp.detach().requires_grad_(True)
        loss_ = fn(leaf)
        return (loss_,), [leaf], (torch.ones_like(loss_),)

    def backward13(graph):
        outputs, inputs_, grad_outputs = graph
        return torch.autograd.grad(outputs, inputs_, grad_outputs, retain_graph=True)

    def ours13(l_):
        return ctc.CTCLossFunction.apply(l_, y_t, z_t, ysl_t, 0)

    def library13(l_):
        return F.ctc_loss(l_.transpose(0, 1), y_t, z_host, ysl_host, reduction="none")

    graphs13 = [ctc_graph(ours13, lp) for lp in lps]
    lib13 = [(ctc_graph(library13, lp), g_) for lp, g_ in zip(lps, graphs13)]
    t13b_lib = alternate(lambda g_: backward13(g_[0]), lambda g_: backward13(g_[1]), lib13, warmup=1)
    t13b = dict(kernel=t13b_lib["kernel"], plain=once(backward13, ctc_graph(lambda l_: ctc.ctc_loss_plain(l_, z_t, y_t, ysl_t),
                                                                            lps[0])))
    t13_pair = alternate(lambda lp: backward13(ctc_graph(library13, lp)), lambda lp: backward13(ctc_graph(ours13, lp)),
                         lps, warmup=1)
    B13, T13, K13 = logits_t.shape
    N13 = y_t.shape[1]
    # the kernels alone, the host's time around a call left out (K13-bwd's 25 us launch sits in an autograd call
    # several times as long): the C entry points on buffers made beforehand, 20 launches between two events, queued
    # behind a ~25 ms spin of the card so that no launch waits on the host; one input; uncounted, like every launch
    # made to time a kernel
    lib = cuda.library()
    stream = cuda.stream_handle(lps[0])
    nll_buf, g_buf, d_buf = (torch.empty(B13, device=dev), torch.ones(B13, device=dev), torch.empty_like(lps[0]))
    alpha_buf, beta_buf = (torch.empty((B13, T13 + 1, 2 * N13 + 1), dtype=torch.float64, device=dev) for _ in range(2))

    def fwd13(save):
        saved = (alpha_buf.data_ptr(), beta_buf.data_ptr()) if save else (None, None)
        cuda.check(lib.blvm_ctc_loss(lps[0].data_ptr(), y_t.data_ptr(), z_t.data_ptr(), ysl_t.data_ptr(),
                                     nll_buf.data_ptr(), *saved, None, B13, T13, N13, K13, 0, ctc.LOG_EPSILON,
                                     stream), "ctc_loss")

    def bwd13():
        cuda.check(lib.blvm_ctc_loss_bwd(y_t.data_ptr(), z_t.data_ptr(), ysl_t.data_ptr(), alpha_buf.data_ptr(),
                                         beta_buf.data_ptr(), g_buf.data_ptr(), d_buf.data_ptr(), B13, T13, N13, K13,
                                         0, stream), "ctc_loss_bwd")

    def alone_ms(launch, reps=20):
        launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    alone13 = dict(kernel=alone_ms(lambda: fwd13(False)), save=alone_ms(lambda: fwd13(True)), bwd=alone_ms(bwd13),
                   pair=alone_ms(lambda: (fwd13(True), bwd13())))
    rows13 = dict(frames=z_host, labels=ysl_host)  # the bounds count each row's own lengths
    b13 = roofline(**ctc_work(T13, K13, N13, **rows13), peak=F64_PEAK)
    b13s = roofline(**ctc_work(T13, K13, N13, **rows13, save=True), peak=F64_PEAK)
    b13b = roofline(**ctc_work(T13, K13, N13, **rows13, backward=True), peak=F64_PEAK)
    record["ctc_loss"].update(ms=alone13["kernel"], plain_ms=t13["plain"], library_ms=t13_lib["plain"], **b13)
    record["ctc_loss_bwd"].update(ms=alone13["bwd"], plain_ms=t13b["plain"], library_ms=t13b_lib["plain"], **b13b)
    # against one call of the library, by events (F.ctc_loss waits on the host inside the call: that is its cost)
    beats = {k: bool(alone13[k] < t_["plain"]) for k, t_ in (("kernel", t13_lib), ("save", t13s_lib),
                                                             ("bwd", t13b_lib), ("pair", t13_pair))}
    phase("time-K13", card=card, logits=f"({B13},{T13},{K13})", labels=N13, live_labels=sum(ysl_host),
          kernel_ms=f"{t13['kernel']:.4f}", plain_ms=f"{t13['plain']:.4f}", library_ms=f"{t13_lib['plain']:.4f}", bound_ms=f"{b13['bound_ms']:.4f}",
          save_ms=f"{t13s_lib['kernel']:.4f}", save_library_ms=f"{t13s_lib['plain']:.4f}",
          save_bound_ms=f"{b13s['bound_ms']:.4f}", bwd_kernel_ms=f"{t13b['kernel']:.4f}",
          bwd_plain_ms=f"{t13b['plain']:.4f}", bwd_library_ms=f"{t13b_lib['plain']:.4f}",
          bwd_bound_ms=f"{b13b['bound_ms']:.4f}", pair_ms=f"{t13_pair['kernel']:.4f}",
          pair_library_ms=f"{t13_pair['plain']:.4f}", pair_bound_ms=f"{b13s['bound_ms'] + b13b['bound_ms']:.4f}",
          bound_by=b13["bound_by"], timed="CUDA events around each call, in turns with F.ctc_loss's",
          library="F.ctc_loss with the host's lengths (its CUDA path synchronizes the stream)")
    phase("time-K13-alone", card=card, **{f"{k}_ms": f"{v:.4f}" for k, v in alone13.items()},
          us_per_frame=f"{alone13['kernel'] * 1e3 / T13:.3f}", beats_library=beats,
          timed="CUDA events around 20 launches of the C entry point, queued behind a spin")

    # where a frame's time goes: SM cycles by stage of the first row's chain (csrc/ctc.cu, Stage), over the three
    # inputs, for K13 plain and in save mode, whose traced losses must agree with an untraced launch's
    frames0 = int(z_t[0]) * len(lps)
    for design, save in (("warp", False), ("warp_save", True)):
        trace = torch.zeros(ctc.TRACE_SIZE, dtype=torch.int64, device=dev)
        with torch.no_grad():
            losses = [ctc._forward(lp, y_t, z_t, ysl_t, 0, save=save, trace=trace)[0] for lp in lps]
            ref_losses = [ctc._forward(lp, y_t, z_t, ysl_t, 0, save=False)[0] for lp in lps]
        torch.cuda.synchronize()
        agree = max(((a - r).abs() / r.abs().clamp_min(1.0)).max().item() for a, r in zip(losses, ref_losses))
        expect(agree <= 1e-5, f"K13-trace {design}: losses {agree} from K13's")
        cycles = trace.cpu().double() / frames0
        ns = ctc.read_trace(trace) / frames0
        phase("K13-trace", card=card, design=design, frames=frames0, cycles_per_frame=f"{cycles[-2].item():.1f}",
              ns_per_frame=f"{cycles[-1].item():.1f}", losses_rel_vs_k13=f"{agree:.3g}",
              **{f"{st}_cycles": f"{c:.1f}" for st, c in zip(ctc.TRACE_STAGES, cycles[:len(ctc.TRACE_STAGES)].tolist())},
              **{f"{st}_ns": f"{v:.1f}" for st, v in zip(ctc.TRACE_STAGES, ns.tolist())})
    del graphs13, lib13, lps, logits_t
    del calls
    torch.cuda.empty_cache()

    weights.load_jax_params(model, params)
    model.train()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_time_ms(run_step, step_batches)
    ts = sorted(step_ms)[1]
    torch.cuda.synchronize()
    enqueue = []
    for b_ in step_batches:
        t0 = time.perf_counter()
        run_step(b_)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    audio_s = sum(audio_seconds(b) for b in train_batches) / len(train_batches)
    phase("time-asr-train-step", card=card, utterances=len(train_batches[0]), audio_seconds=f"{audio_s:.1f}",
          frames=tuple(step_batches[0]["x"].shape[:2]), kernel_ms=f"{ts:.3f}", kernel_ms_all=[f"{v:.3f}" for v in step_ms],
          plain_wall_ms=f"{seconds_p / 3 * 1e3:.1f}", host_enqueue_ms=f"{sorted(enqueue)[1]:.3f}",
          audio_seconds_per_s=f"{audio_s / ts * 1e3:.1f}", peak_memory_GB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    phase("profile-asr-train-step", card=card, device_ms_per_step=f"{busy_ms:.3f}" if busy_ms else "not measured",
          step_ms=f"{ts:.3f}", idle_share=f"{1 - busy_ms / ts:.3f}" if busy_ms else "not measured",
          wall_ms_per_step_under_profiler=f"{checks['wall_ms'] / 3:.3f}",
          kernel_launches_per_step=sum(e_.count for e_ in kernels_) // 3 if busy_ms else "not measured",
          host_enqueue_ms=f"{sorted(enqueue)[1]:.3f}",
          build_metrics_ms_per_step=f"{build_metrics_ms:.3f}", step_spans=checks["spans"],
          host_waits_in_steps=len(checks["waits"]), sync_debug_mode_step="passed" if checks["sync_free"] else "raised")
    for e_ in sorted(kernels_, key=device_us, reverse=True)[:12]:
        print(f"  {device_us(e_) / 1e3 / 3:9.3f} ms/step {e_.count // 3:5d} calls/step  {e_.key[:90]}", flush=True)

    # the test pass: evaluate's wall time (the forward, the metrics' copies, the decode and error rates) and a
    # torch.profiler split of its device time
    model.eval()
    evals = sorted(run_eval()[2] for _ in range(3))
    eval_checks = driver_step_checks(lambda: asr_ctc.evaluate(model, targs, [eval_batch], Tracker()), lambda: None)
    eval_busy = sum(device_us(e_) for e_ in eval_checks["kernels"]) / 1e3
    phase("time-asr-test-pass", card=card, utterances=len(eval_batch), audio_seconds=f"{eval_audio_s:.1f}",
          wall_ms=f"{evals[1] * 1e3:.3f}", audio_seconds_per_s=f"{eval_audio_s / evals[1]:.1f}",
          device_ms=f"{eval_busy:.3f}" if eval_busy else "not measured",
          idle_share=f"{1 - eval_busy / eval_checks['wall_ms']:.3f}" if eval_busy else "not measured",
          kernel_launches=sum(e_.count for e_ in eval_checks["kernels"]) if eval_busy else "not measured",
          host_waits_in_steps=len(eval_checks["waits"]))
    for e_ in sorted(eval_checks["kernels"], key=device_us, reverse=True)[:6]:
        print(f"  {device_us(e_) / 1e3:9.3f} ms {e_.count:5d} calls  {e_.key[:90]}", flush=True)
    del state, model, step_batches, on_card
    torch.cuda.empty_cache()
    require(not failures, f"probe phases failed: {failures}")


def argparse_copy(args, **changes):
    import argparse

    return argparse.Namespace(**{**vars(args), **changes})


def plain_path(modules, likelihoods, distributions, variational, recurrent):
    """``plain`` for ``with plain():``, inside which every kernel wrapper of the paths is
    swapped for its plain twin (autograd of the twins gives the backward)."""
    def dmol(y, logit_probs, locs, log_scales, num_bins):
        return likelihoods.discretized_logistic_mixture_ll(y, logit_probs, locs, log_scales, num_bins=num_bins)

    def sample_and_mode(generator, logit_probs, locs, log_scales, uniforms=None):
        with torch.no_grad():
            return (variational.rsample_discretized_logistic_mixture(generator, logit_probs, locs, log_scales,
                                                                     uniforms=uniforms),
                    variational.dmol_mode(logit_probs, locs))

    from blvm_tpu_torch.ops import ctc, depthwise, rssm
    from blvm_tpu_torch.ops import srnn as srnn_ops
    from blvm_tpu_torch.ops import vrnn as vrnn_ops
    from blvm_tpu_torch.ops import wavenet_stack as stack_ops

    def plain():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(rssm, "rssm_chain", rssm.rssm_chain_plain))
        stack.enter_context(mock.patch.object(depthwise, "depthwise_norm", depthwise.depthwise_norm_plain))
        stack.enter_context(mock.patch.object(vrnn_ops, "vrnn_cell", vrnn_ops.vrnn_cell_plain))
        stack.enter_context(mock.patch.object(srnn_ops, "srnn_chain", srnn_ops.srnn_chain_plain))
        stack.enter_context(mock.patch.object(recurrent, "gru_recurrence", recurrent.gru_recurrence_plain))
        stack.enter_context(mock.patch.object(modules, "residual_glu", modules.residual_glu_plain))
        stack.enter_context(mock.patch.object(stack_ops, "wavenet_stack", stack_ops.wavenet_stack_plain))
        stack.enter_context(mock.patch.object(likelihoods, "dmol_log_prob", dmol))
        stack.enter_context(mock.patch.object(distributions, "dmol_sample_and_mode", sample_and_mode))
        stack.enter_context(mock.patch.object(recurrent, "lstm_recurrence", recurrent.lstm_recurrence_plain))
        stack.enter_context(mock.patch.object(recurrent, "bilstm_recurrence", recurrent.bilstm_recurrence_plain))
        stack.enter_context(mock.patch.object(ctc, "ctc_loss", ctc.ctc_loss_plain))
        return stack

    return plain


if __name__ == "__main__":
    sys.exit(main())
