// K11: the depthwise chain of a CW-VAE coder block, f32, on sm_90a.
//
// Replaces the chain inside blvm_tpu/models/clockwork_vae/conv_coders.py BlockSeparable.__call__ (:121-134) and
// _DepthwiseSeparable.__call__ (:70-88) between the block's two 1x1 products, with the depthwise convolutions of
// blvm_tpu/modules/convolutions.py (:88-165). For a batch row b and a channel c of the expanded block input
// u = x W1 + b1 (B, N_in, C), the 1x1 expansion done by cuBLAS before the launch:
//   r = relu(u);                    g = GroupNorm_c(r; scale1, bias1)      (statistics over all N_in rows of (b, c))
//   v[o] = sum_j w[j][c] g[in(o, j)] + db[c]  (the depthwise conv: strided and dilated, or transposed)
//   y = relu(v);                    z = GroupNorm_c(y; scale2, bias2)      (statistics over all N_out rows)
// and z (B, N_out, C) goes to the block's pointwise 1x1 (cuBLAS, after the launch). GroupNorm is flax's with one
// group a channel and epsilon 1e-5: mean and mean square over the rows (the padding rows included), var =
// max(E[x^2] - E[x]^2, 0), then (x - mean) * (rsqrt(var + eps) * scale) + bias. The encoder's conv is VALID,
// in(o, j) = o s + j d, N_out = (N_in - d (k - 1) - 1) / s + 1; the decoder's is torch's ConvTranspose1d, N_out =
// (N_in - 1) s + d (k - 1) + 1, where output row o takes input row i = (o - j d) / s wherever that is a whole row
// in range: the zero stuffing and the full padding of the JAX form are zeros of the normalized g, so no stuffed
// tensor is made and a tap that falls between input rows adds nothing.
//
// What bounds it. Bytes: at the test pass's shape (B = 5, C = 768, 72k samples) the encoder's first block reads
// ~1.1 GB of u and the decoder's last writes ~1.1 GB of z; the chain's arithmetic is ~20 operations an element.
// Both GroupNorms need a whole channel's statistics before they can normalize, so u is read twice (its
// statistics, then the conv), and y's statistics come before z: the encoder stores y (a quarter of u) and
// normalizes it in place, the decoder reads u a third time rather than store y (four times u). Every pass is a
// coalesced sweep (a warp reads 32 neighbouring channels of one row) with a few blocks an SM.
//
// Five launches on the caller's stream, no atomics, every sum in a fixed order:
//   1. stats:    a block sums relu(u) and its square over `stats_rows` rows of one batch row, every channel, in
//                double, into partials (B, tiles, 2, C)
//   2. finalize: per (b, c) the partials summed in tile order: the mean and the multiplier scale / sqrt(var + eps)
//                (as two floats)
//   3. conv:     a block computes `conv_rows` output rows of one batch row, every channel: g normalized on load, the
//                taps, + db, relu; the partial sums of y (in double), and y itself for the encoder
//   4. finalize: the same for y
//   5. apply:    the encoder's z = (y - mean) mul + bias2 in place over y; the decoder's y recomputed from u and
//                normalized (its y is 4x its u at stride 4, so reading u again moves fewer bytes than storing y)
// The wrapper sizes the row tiles so that a pass has a few blocks an SM even at a block's shortest lengths. The
// statistics are summed in double, so the kernel's GroupNorm is closer to an exact one than a float32 twin's (whose
// sums are float32); where a channel's variance is a small difference of large sums (a handful of rows, or a mean
// large against the spread), the two differ by the twin's error.
//
// Save mode (a train step's forward): the finalize passes also write each GroupNorm's 1 / sqrt(var + eps) and the
// slope of its clamped variance beside the mean and multiplier, for K11-bwd (depthwise_norm_bwd.cu); z is the same
// bits as without it.

#include "depthwise_common.cuh"

namespace blvm {
namespace depthwise {

__global__ void __launch_bounds__(NT) stats_relu_kernel(const float* __restrict__ u, double* __restrict__ part, int N,
                                                        int C, int rows, int tiles) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = tile * rows, r1 = min(N, r0 + rows);
  const float* ub = u + (int64_t)b * N * C;
  double* pb = part + ((int64_t)b * tiles + tile) * 2 * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    double s = 0.0, s2 = 0.0;
    int r = r0;
    for (; r + 8 <= r1; r += 8) {  // eight independent loads in flight a thread
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(__ldg(ub + (int64_t)(r + j) * C + c), 0.0f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += v[j];
        s2 = fma((double)v[j], (double)v[j], s2);
      }
    }
    for (; r < r1; ++r) {
      const float v = fmaxf(__ldg(ub + (int64_t)r * C + c), 0.0f);
      s += v;
      s2 = fma((double)v, (double)v, s2);
    }
    pb[c] = s;
    pb[C + c] = s2;
  }
}

// stats (B, 2, C): the mean and scale / sqrt(var + eps) of each (b, c) over `count` rows; in save mode also aux
// (B, 2, C): 1 / sqrt(var + eps) and the slope of var = max(E[x^2] - E[x]^2, 0) at its argument (1, 0.5 at 0 as
// jnp.maximum's gradient splits a tie, 0), what K11-bwd needs of each GroupNorm
__global__ void __launch_bounds__(NT) finalize_kernel(const double* __restrict__ part, const float* __restrict__ scale,
                                                      float* __restrict__ stats, float* __restrict__ aux, int tiles,
                                                      int count, int C, float eps) {
  __shared__ double sh[2][NT];
  const int b = blockIdx.y, q = threadIdx.x / FIN_CH, c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  double s = 0.0, s2 = 0.0;
  if (c < C) {
    for (int t = q; t < tiles; t += NT / FIN_CH) {
      const double* p = part + ((int64_t)b * tiles + t) * 2 * C;
      s += p[c];
      s2 += p[C + c];
    }
  }
  sh[0][threadIdx.x] = s;
  sh[1][threadIdx.x] = s2;
  __syncthreads();
  if (q == 0 && c < C) {
    for (int j = 1; j < NT / FIN_CH; ++j) {  // the streams in order
      s += sh[0][threadIdx.x + j * FIN_CH];
      s2 += sh[1][threadIdx.x + j * FIN_CH];
    }
    const double mean = s / count, spread = s2 / count - mean * mean, var = fmax(spread, 0.0);
    stats[(int64_t)b * 2 * C + c] = (float)mean;
    stats[(int64_t)b * 2 * C + C + c] = (float)((double)scale[c] / sqrt(var + (double)eps));
    if (aux) {
      aux[(int64_t)b * 2 * C + c] = (float)(1.0 / sqrt(var + (double)eps));
      aux[(int64_t)b * 2 * C + C + c] = spread > 0.0 ? 1.0f : spread == 0.0 ? 0.5f : 0.0f;
    }
  }
}

template <bool TRANSPOSED>
__global__ void __launch_bounds__(NT) conv_kernel(const float* __restrict__ u, const float* __restrict__ stats1,
                                                  const float* __restrict__ bias1, const float* __restrict__ w,
                                                  const float* __restrict__ db, float* __restrict__ y,
                                                  double* __restrict__ part, int N_in, int N_out, int C, int k, int s,
                                                  int d, int rows, int tiles) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int o0 = tile * rows, o1 = min(N_out, o0 + rows);
  const float* ub = u + (int64_t)b * N_in * C;
  float* yb = y ? y + (int64_t)b * N_out * C : nullptr;
  double* pb = part + ((int64_t)b * tiles + tile) * 2 * C;
  const Taps tp = TRANSPOSED ? make_taps(k, s, d) : Taps{};
  for (int c = threadIdx.x; c < C; c += NT) {
    const Channel ch = load_channel(stats1, bias1, w, db, b, c, C, k);
    double sum = 0.0, sum2 = 0.0;
    int o_div = o0 / s, r = o0 - o_div * s;
    for (int o = o0; o < o1; ++o) {
      const float yv = conv_at<TRANSPOSED>(ub, ch, tp, o, o_div, r, c, C, N_in, k, s, d);
      if (yb) yb[(int64_t)o * C + c] = yv;
      sum += yv;
      sum2 = fma((double)yv, (double)yv, sum2);
      if (++r == s) {
        r = 0;
        ++o_div;
      }
    }
    pb[c] = sum;
    pb[C + c] = sum2;
  }
}

// the encoder's z = (y - mean) mul + bias2 in place, four channels a thread (C a multiple of 4)
__global__ void __launch_bounds__(NT) apply_kernel(float* __restrict__ y, const float* __restrict__ stats2,
                                                   const float* __restrict__ bias2, int N_out, int C, int B) {
  const int C4 = C / 4;
  const int64_t n4 = (int64_t)B * N_out * C4;
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int64_t idx = (int64_t)blockIdx.x * NT + threadIdx.x; idx < n4; idx += (int64_t)gridDim.x * NT) {
    const int c = (int)(idx % C4) * 4;
    const int b = (int)(idx / ((int64_t)N_out * C4));
    const float* st = stats2 + (int64_t)b * 2 * C;
    float4 v = y4[idx];
    v.x = fmaf(v.x - st[c], st[C + c], bias2[c]);
    v.y = fmaf(v.y - st[c + 1], st[C + c + 1], bias2[c + 1]);
    v.z = fmaf(v.z - st[c + 2], st[C + c + 2], bias2[c + 2]);
    v.w = fmaf(v.w - st[c + 3], st[C + c + 3], bias2[c + 3]);
    y4[idx] = v;
  }
}

// the decoder's z: y recomputed from u, then (y - mean) mul + bias2
__global__ void __launch_bounds__(NT) conv_apply_kernel(const float* __restrict__ u, const float* __restrict__ stats1,
                                                        const float* __restrict__ bias1, const float* __restrict__ w,
                                                        const float* __restrict__ db, const float* __restrict__ stats2,
                                                        const float* __restrict__ bias2, float* __restrict__ z,
                                                        int N_in, int N_out, int C, int k, int s, int d, int rows) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int o0 = tile * rows, o1 = min(N_out, o0 + rows);
  const float* ub = u + (int64_t)b * N_in * C;
  float* zb = z + (int64_t)b * N_out * C;
  const Taps tp = make_taps(k, s, d);
  for (int c = threadIdx.x; c < C; c += NT) {
    const Channel ch = load_channel(stats1, bias1, w, db, b, c, C, k);
    const float mean2 = stats2[(int64_t)b * 2 * C + c], mul2 = stats2[(int64_t)b * 2 * C + C + c], beta2 = bias2[c];
    int o_div = o0 / s, r = o0 - o_div * s;
    for (int o = o0; o < o1; ++o) {
      zb[(int64_t)o * C + c] = fmaf(conv_at<true>(ub, ch, tp, o, o_div, r, c, C, N_in, k, s, d) - mean2, mul2, beta2);
      if (++r == s) {
        r = 0;
        ++o_div;
      }
    }
  }
}

}  // namespace depthwise
}  // namespace blvm

// K11. u (B, N_in, C): the expanded block input before its relu; scale1, bias1, db, scale2, bias2 (C,); w (k, C):
// the depthwise kernel (the JAX (k, 1, C) with its middle axis dropped); out (B, N_out, C): z; part: scratch of
// part_doubles doubles, at least B * max(ceil(N_in / stats_rows), ceil(N_out / conv_rows)) * 2 * C; stats: 4 B C
// floats (GroupNorm 1's mean and multiplier (B, 2, C), then GroupNorm 2's), or with save 8 B C floats, which then get
// each GroupNorm's 1 / sqrt(var + eps) and variance slope (B, 2, C) (finalize_kernel) for K11-bwd. transposed: 0
// for the encoder's strided conv, 1 for the decoder's transposed one. stats_rows and conv_rows: the rows a block of
// the statistics and of the conv passes takes. Returns a cudaError_t:
// cudaErrorInvalidValue for a shape it does not take (k > 8, C not a multiple of 4, an output length that the
// geometry does not give, or too little scratch).
extern "C" int blvm_depthwise_norm(const void* u, const void* scale1, const void* bias1, const void* w, const void* db,
                                   const void* scale2, const void* bias2, void* out, void* part, void* stats,
                                   int64_t part_doubles, int B, int N_in, int N_out, int C, int k, int stride,
                                   int dilation, int transposed, int stats_rows, int conv_rows, int save,
                                   void* stream) {
  using namespace blvm::depthwise;
  if (B < 1 || B > 65535 || N_in < 1 || C < 4 || C % 4 != 0 || k < 1 || k > MAXK || stride < 1 || dilation < 1 ||
      stats_rows < 1 || conv_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t span = (int64_t)dilation * (k - 1);
  const int64_t expect = transposed ? (int64_t)(N_in - 1) * stride + span + 1 : (N_in - span - 1) / stride + 1;
  if (N_out < 1 || N_out != expect || (!transposed && N_in <= span)) return (int)cudaErrorInvalidValue;
  const int tiles_in = (N_in + stats_rows - 1) / stats_rows, tiles_out = (N_out + conv_rows - 1) / conv_rows;
  if (part_doubles < (int64_t)B * (tiles_in > tiles_out ? tiles_in : tiles_out) * 2 * C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *uf = static_cast<const float*>(u), *wf = static_cast<const float*>(w);
  const float *b1 = static_cast<const float*>(bias1), *dbf = static_cast<const float*>(db);
  double* pf = static_cast<double*>(part);
  float *sf = static_cast<float*>(stats), *of = static_cast<float*>(out);
  float* stats2 = sf + (int64_t)2 * B * C;
  float* aux1 = save ? sf + (int64_t)4 * B * C : nullptr;
  float* aux2 = save ? sf + (int64_t)6 * B * C : nullptr;
  const dim3 fin_grid((C + FIN_CH - 1) / FIN_CH, B);
  stats_relu_kernel<<<dim3(tiles_in, B), NT, 0, st>>>(uf, pf, N_in, C, stats_rows, tiles_in);
  finalize_kernel<<<fin_grid, NT, 0, st>>>(pf, static_cast<const float*>(scale1), sf, aux1, tiles_in, N_in, C, 1e-5f);
  const dim3 conv_grid(tiles_out, B);
  if (transposed)
    conv_kernel<true><<<conv_grid, NT, 0, st>>>(uf, sf, b1, wf, dbf, nullptr, pf, N_in, N_out, C, k, stride, dilation,
                                                conv_rows, tiles_out);
  else
    conv_kernel<false><<<conv_grid, NT, 0, st>>>(uf, sf, b1, wf, dbf, of, pf, N_in, N_out, C, k, stride, dilation,
                                                 conv_rows, tiles_out);
  finalize_kernel<<<fin_grid, NT, 0, st>>>(pf, static_cast<const float*>(scale2), stats2, aux2, tiles_out, N_out, C,
                                           1e-5f);
  if (transposed) {
    conv_apply_kernel<<<conv_grid, NT, 0, st>>>(uf, sf, b1, wf, dbf, stats2, static_cast<const float*>(bias2), of, N_in,
                                                N_out, C, k, stride, dilation, conv_rows);
  } else {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int64_t n4 = (int64_t)B * N_out * (C / 4), most = (int64_t)sms * 16;
    const int apply_blocks = (int)((n4 + NT - 1) / NT < most ? (n4 + NT - 1) / NT : most);
    apply_kernel<<<apply_blocks, NT, 0, st>>>(of, stats2, static_cast<const float*>(bias2), N_out, C, B);
  }
  return (int)cudaGetLastError();
}
