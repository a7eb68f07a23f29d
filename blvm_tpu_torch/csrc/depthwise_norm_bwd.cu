// K11-bwd: the backward of a CW-VAE coder block's depthwise chain (K11, depthwise_norm.cu), f32, on sm_90a.
//
// Replaces the autodiff backward that the JAX train step computes of the chain inside
// blvm_tpu/models/clockwork_vae/conv_coders.py BlockSeparable.__call__ (:121-134) and _DepthwiseSeparable.__call__
// (:70-88), with the depthwise convolutions of blvm_tpu/modules/convolutions.py (:88-165). For a batch row b and a
// channel c, K11 computed from u = x W1 + b1 (B, N_in, C):
//   r = relu(u);   g = (r - m1) mul1 + bias1;   v[o] = sum_j w[j] g[in(o, j)] + db;   y = relu(v);
//   z = (y - m2) mul2 + bias2
// with each GroupNorm's statistics over all rows of (b, c) and flax's fast variance var = max(E[x^2] - m^2, 0),
// mul = scale / sqrt(var + eps). Given dz (B, N_out, C), the gradient the pointwise 1x1's backward gives (cuBLAS),
// this computes du and the gradients of scale1, bias1, the depthwise kernel, its bias, scale2 and bias2, each
// GroupNorm's backward as JAX's autodiff of flax's GroupNorm differentiates it: with Sa = sum dz and
// Sb = sum dz (x - m) over the rows of (b, c), and the variance's slope s_v (1; 0.5 where E[x^2] - m^2 is exactly
// 0; 0 below),
//   d bias = sum_b Sa;  d scale = sum_b Sb / sqrt(var + eps);
//   dvar = s_v (-0.5) Sb scale / (var + eps)^1.5;  dm = -mul Sa - 2 m dvar;  dx = dz mul + dm / N + 2 x dvar / N.
// The relus' gradients are 0 at 0, as jax.nn.relu's. g and y are recomputed from u and K11's saved statistics
// (depthwise_common.cuh), never stored: the same bits as the forward's.
//
// Passes, each a coalesced sweep of one batch row's rows (a warp reads 32 neighbouring channels of one row), on the
// caller's stream, counted as one launch:
//   1. reduce2:   per (b, c) and output-row tile, sum dz and dz y in double (y recomputed)
//   2. finalize:  per (b, c) the tiles summed in order: GroupNorm 2's dx coefficients (dm / N, 2 dvar / N) and, summed
//                 over b in order, d scale2 and d bias2
//   3. dv:        dv = (dz mul2 + dm / N + 2 y dvar / N) [v > 0], stored (B, N_out, C); per tile the partial sums, in
//                 double, of d db = sum dv, d w[j] = sum dv g[in(o, j)], and GroupNorm 1's sum dg = sum_o dv[o] sum_j
//                 w[j] and sum dg relu(u) = sum_o dv[o] sum_j w[j] relu(u[in(o, j)]) over the taps that read a row (each
//                 (row, tap) pair of the conv once, as dg's own sums would take it), so no pass has to store dg
//   4. finalize:  the same for GroupNorm 1 (d scale1, d bias1)
//   5. sum:       d w and d db, the partials of pass 3 summed over (b, tile) in order
//   6. du:        the depthwise conv's input gradient as a gather, never a scatter (no atomics): the encoder's
//                 dg[i] = sum_j w[j] dv[(i - j d) / s] where that is a whole row in range, the decoder's dg[i] = sum_j
//                 w[j] dv[i s + j d]; then du = (dg mul1 + dm1 / N_in + 2 relu(u) dvar1 / N_in) [u > 0], written once
// Every reduction over time or batch goes through per-tile partials in double, finalized in a fixed order: the
// parameter gradients sum over B N ~ 250k-330k rows, where float partials would drift.
//
// What bounds it. Bytes: u is read three times (passes 1, 3 and 6), dz twice, dv written and read once, du written
// once: at the train step's first encoder block (B = 5, N_in ~ 49750, C = 768) ~3.9 GB, ~1.2 ms at 3.35 TB/s; the
// compulsory bytes (u and dz read, du written once) are under half of that. A fused design that keeps a tile's dv on
// chip for the gather is later work.

#include "depthwise_common.cuh"

namespace blvm {
namespace depthwise {

// per (b, tile): sum dz and sum dz y over the tile's output rows, every channel
template <bool TRANSPOSED>
__global__ void __launch_bounds__(NT) bwd_reduce2_kernel(const float* __restrict__ dz, const float* __restrict__ u,
                                                         const float* __restrict__ stats1,
                                                         const float* __restrict__ bias1,
                                                         const float* __restrict__ w, const float* __restrict__ db,
                                                         double* __restrict__ part, int N_in, int N_out, int C, int k,
                                                         int s, int d, int rows, int tiles) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int o0 = tile * rows, o1 = min(N_out, o0 + rows);
  const float* ub = u + (int64_t)b * N_in * C;
  const float* dzb = dz + (int64_t)b * N_out * C;
  double* pb = part + ((int64_t)b * tiles + tile) * 2 * C;
  const Taps tp = TRANSPOSED ? make_taps(k, s, d) : Taps{};
  for (int c = threadIdx.x; c < C; c += NT) {
    const Channel ch = load_channel(stats1, bias1, w, db, b, c, C, k);
    double sa = 0.0, sb = 0.0;
    int o_div = o0 / s, r = o0 - o_div * s;
    for (int o = o0; o < o1; ++o) {
      const float y = conv_at<TRANSPOSED>(ub, ch, tp, o, o_div, r, c, C, N_in, k, s, d);
      const float g = __ldg(dzb + (int64_t)o * C + c);
      sa += g;
      sb = fma((double)g, (double)y, sb);
      if (++r == s) {
        r = 0;
        ++o_div;
      }
    }
    pb[c] = sa;
    pb[C + c] = sb;
  }
}

// A GroupNorm's backward coefficients from its tiles' (sum dy, sum dy x): per (b, c) coef (B, 2, C) = (dm / N,
// 2 dvar / N), and d scale, d bias (C,) summed over b in order
__global__ void __launch_bounds__(NT) grad_finalize_kernel(const double* __restrict__ part,
                                                           const float* __restrict__ stats,
                                                           const float* __restrict__ aux,
                                                           const float* __restrict__ scale, float* __restrict__ coef,
                                                           float* __restrict__ dscale, float* __restrict__ dbias, int B,
                                                           int tiles, int count, int C) {
  __shared__ double sh[2][NT];
  const int q = threadIdx.x / FIN_CH, c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  double d_scale = 0.0, d_bias = 0.0;
  for (int b = 0; b < B; ++b) {
    double sa = 0.0, sb = 0.0;
    if (c < C) {
      for (int t = q; t < tiles; t += NT / FIN_CH) {
        const double* p = part + ((int64_t)b * tiles + t) * 2 * C;
        sa += p[c];
        sb += p[C + c];
      }
    }
    sh[0][threadIdx.x] = sa;
    sh[1][threadIdx.x] = sb;
    __syncthreads();
    if (q == 0 && c < C) {
      for (int j = 1; j < NT / FIN_CH; ++j) {  // the streams in order
        sa += sh[0][threadIdx.x + j * FIN_CH];
        sb += sh[1][threadIdx.x + j * FIN_CH];
      }
      const int64_t o = (int64_t)b * 2 * C + c;
      const double mean = stats[o], mul = stats[o + C], rstd = aux[o], slope = aux[o + C];
      const double centered = sb - mean * sa;  // sum dy (x - mean)
      const double dvar = slope * (centered * (double)scale[c] * -0.5 * rstd * rstd * rstd);
      const double dmean = -mul * sa - 2.0 * mean * dvar;
      coef[o] = (float)(dmean / count);
      coef[o + C] = (float)(2.0 * dvar / count);
      d_scale += centered * rstd;
      d_bias += sa;
    }
    __syncthreads();
  }
  if (q == 0 && c < C) {
    dscale[c] = (float)d_scale;
    dbias[c] = (float)d_bias;
  }
}

// dv = GroupNorm 2's backward of dz through the relu, stored; per (b, tile) the partial sums of d w[j] and d db
// (part_w) and of GroupNorm 1's sum dg and sum dg relu(u) (part)
template <bool TRANSPOSED>
__global__ void __launch_bounds__(NT) bwd_dv_kernel(const float* __restrict__ dz, const float* __restrict__ u,
                                                    const float* __restrict__ stats1, const float* __restrict__ bias1,
                                                    const float* __restrict__ w, const float* __restrict__ db,
                                                    const float* __restrict__ stats2, const float* __restrict__ coef2,
                                                    float* __restrict__ dv, double* __restrict__ part_w,
                                                    double* __restrict__ part, int N_in, int N_out, int C, int k,
                                                    int s, int d, int rows, int tiles) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int o0 = tile * rows, o1 = min(N_out, o0 + rows);
  const float* ub = u + (int64_t)b * N_in * C;
  const float* dzb = dz + (int64_t)b * N_out * C;
  float* dvb = dv + (int64_t)b * N_out * C;
  double* pw = part_w + ((int64_t)b * tiles + tile) * (k + 1) * C;
  double* pb = part + ((int64_t)b * tiles + tile) * 2 * C;
  const Taps tp = TRANSPOSED ? make_taps(k, s, d) : Taps{};
  for (int c = threadIdx.x; c < C; c += NT) {
    const Channel ch = load_channel(stats1, bias1, w, db, b, c, C, k);
    const int64_t sc = (int64_t)b * 2 * C + c;
    const float mul2 = stats2[sc + C], cm = coef2[sc], cx = coef2[sc + C];
    double dw[MAXK], dbias = 0.0, sa = 0.0, sb = 0.0;
#pragma unroll
    for (int j = 0; j < MAXK; ++j) dw[j] = 0.0;
    int o_div = o0 / s, r = o0 - o_div * s;
    for (int o = o0; o < o1; ++o) {
      float g[MAXK], w_sum, wr_sum;
      const float y = conv_taps<TRANSPOSED>(ub, ch, tp, o, o_div, r, c, C, N_in, k, s, d, g, w_sum, wr_sum);
      const float dy = fmaf(__ldg(dzb + (int64_t)o * C + c), mul2, fmaf(cx, y, cm));
      const float dvv = y > 0.0f ? dy : 0.0f;
      dvb[(int64_t)o * C + c] = dvv;
      dbias += dvv;
      sa = fma((double)dvv, (double)w_sum, sa);
      sb = fma((double)dvv, (double)wr_sum, sb);
#pragma unroll
      for (int j = 0; j < MAXK; ++j) dw[j] = fma((double)dvv, (double)g[j], dw[j]);
      if (++r == s) {
        r = 0;
        ++o_div;
      }
    }
#pragma unroll
    for (int j = 0; j < MAXK; ++j)
      if (j < k) pw[(int64_t)j * C + c] = dw[j];
    pw[(int64_t)k * C + c] = dbias;
    pb[c] = sa;
    pb[C + c] = sb;
  }
}

// du: dg, the depthwise conv's input gradient gathered from dv, through GroupNorm 1's backward and the relu
template <bool TRANSPOSED>
__global__ void __launch_bounds__(NT) bwd_du_kernel(const float* __restrict__ dv, const float* __restrict__ u,
                                                    const float* __restrict__ w, const float* __restrict__ stats1,
                                                    const float* __restrict__ coef1, float* __restrict__ du, int N_in,
                                                    int N_out, int C, int k, int s, int d, int rows) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int i0 = tile * rows, i1 = min(N_in, i0 + rows);
  const float* ub = u + (int64_t)b * N_in * C;
  const float* dvb = dv + (int64_t)b * N_out * C;
  float* dub = du + (int64_t)b * N_in * C;
  const Taps te = make_taps(k, s, d);  // the encoder's tap j, j d = div s + mod, reads dv[i_div - div] where i_r = mod
  for (int c = threadIdx.x; c < C; c += NT) {
    float wj[MAXK];
#pragma unroll
    for (int j = 0; j < MAXK; ++j) wj[j] = j < k ? __ldg(w + (int64_t)j * C + c) : 0.0f;
    const int64_t sc = (int64_t)b * 2 * C + c;
    const float mul1 = stats1[sc + C], cm = coef1[sc], cx = coef1[sc + C];
    int i_div = i0 / s, i_r = i0 - i_div * s;
    for (int i = i0; i < i1; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXK; ++j) {
        if (j >= k) break;
        int o;
        if (TRANSPOSED) {
          o = i * s + j * d;
        } else {
          o = i_div - te.div[j];
          if (i_r != te.mod[j] || o < 0 || o >= N_out) continue;
        }
        acc = fmaf(wj[j], __ldg(dvb + (int64_t)o * C + c), acc);
      }
      const float uv = __ldg(ub + (int64_t)i * C + c);
      dub[(int64_t)i * C + c] = uv > 0.0f ? fmaf(acc, mul1, fmaf(cx, uv, cm)) : 0.0f;
      if (++i_r == s) {
        i_r = 0;
        ++i_div;
      }
    }
  }
}

// out (F, C): part_w (B, tiles, F, C) summed over (b, tile) in order, NT / FIN_CH streams then the streams in order
__global__ void __launch_bounds__(NT) sum_partials_kernel(const double* __restrict__ part_w, float* __restrict__ out,
                                                          int n, int F, int C) {
  __shared__ double sh[NT];
  const int f = blockIdx.y, q = threadIdx.x / FIN_CH, c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  double s = 0.0;
  if (c < C)
    for (int idx = q; idx < n; idx += NT / FIN_CH) s += part_w[((int64_t)idx * F + f) * C + c];
  sh[threadIdx.x] = s;
  __syncthreads();
  if (q == 0 && c < C) {
    for (int j = 1; j < NT / FIN_CH; ++j) s += sh[threadIdx.x + j * FIN_CH];
    out[(int64_t)f * C + c] = (float)s;
  }
}

}  // namespace depthwise
}  // namespace blvm

// K11-bwd. dz (B, N_out, C): the gradient of K11's output; u (B, N_in, C), scale1, bias1, w (k, C), db, scale2 as K11
// took them; stats: K11's save-mode statistics, 8 B C floats (blvm_depthwise_norm). du (B, N_in, C): the gradient of
// u; dv: scratch of B N_out C floats; dparams (k + 5, C): the gradients of scale1, bias1, the k taps of w, db, scale2,
// bias2, one row each; coef: scratch of 4 B C floats; part: part_doubles doubles, at least B * ceil(N_out /
// out_rows) * 2 * C; part_w: part_w_doubles doubles, at least B * ceil(N_out / out_rows) * (k + 1) * C. in_rows and out_rows: the rows a block of the input-row and the output-row passes takes. Returns a
// cudaError_t: cudaErrorInvalidValue for a shape it does not take (K11's) or too little scratch.
extern "C" int blvm_depthwise_norm_bwd(const void* dz, const void* u, const void* scale1, const void* bias1,
                                       const void* w, const void* db, const void* scale2, const void* stats, void* du,
                                       void* dv, void* dparams, void* coef, void* part, void* part_w,
                                       int64_t part_doubles, int64_t part_w_doubles, int B, int N_in, int N_out, int C,
                                       int k, int stride, int dilation, int transposed, int in_rows, int out_rows,
                                       void* stream) {
  using namespace blvm::depthwise;
  if (B < 1 || B > 65535 || N_in < 1 || C < 4 || C % 4 != 0 || k < 1 || k > MAXK || stride < 1 || dilation < 1 ||
      in_rows < 1 || out_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t span = (int64_t)dilation * (k - 1);
  const int64_t expect = transposed ? (int64_t)(N_in - 1) * stride + span + 1 : (N_in - span - 1) / stride + 1;
  if (N_out < 1 || N_out != expect || (!transposed && N_in <= span)) return (int)cudaErrorInvalidValue;
  const int tiles_in = (N_in + in_rows - 1) / in_rows, tiles_out = (N_out + out_rows - 1) / out_rows;
  if (part_doubles < (int64_t)B * tiles_out * 2 * C ||
      part_w_doubles < (int64_t)B * tiles_out * (k + 1) * C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *dzf = static_cast<const float*>(dz), *uf = static_cast<const float*>(u);
  const float *wf = static_cast<const float*>(w), *dbf = static_cast<const float*>(db);
  const float *b1 = static_cast<const float*>(bias1), *sf = static_cast<const float*>(stats);
  const float *stats2 = sf + (int64_t)2 * B * C, *aux1 = sf + (int64_t)4 * B * C, *aux2 = sf + (int64_t)6 * B * C;
  float *duf = static_cast<float*>(du), *dvf = static_cast<float*>(dv), *dp = static_cast<float*>(dparams);
  float *coef2 = static_cast<float*>(coef), *coef1 = coef2 + (int64_t)2 * B * C;
  double *pf = static_cast<double*>(part), *pwf = static_cast<double*>(part_w);
  const dim3 out_grid(tiles_out, B), in_grid(tiles_in, B), fin_grid((C + FIN_CH - 1) / FIN_CH);

  if (transposed)
    bwd_reduce2_kernel<true><<<out_grid, NT, 0, st>>>(dzf, uf, sf, b1, wf, dbf, pf, N_in, N_out, C, k, stride, dilation,
                                                      out_rows, tiles_out);
  else
    bwd_reduce2_kernel<false><<<out_grid, NT, 0, st>>>(dzf, uf, sf, b1, wf, dbf, pf, N_in, N_out, C, k, stride,
                                                       dilation, out_rows, tiles_out);
  grad_finalize_kernel<<<fin_grid, NT, 0, st>>>(pf, stats2, aux2, static_cast<const float*>(scale2), coef2,
                                                dp + (int64_t)(k + 3) * C, dp + (int64_t)(k + 4) * C, B, tiles_out,
                                                N_out, C);
  if (transposed)
    bwd_dv_kernel<true><<<out_grid, NT, 0, st>>>(dzf, uf, sf, b1, wf, dbf, stats2, coef2, dvf, pwf, pf, N_in, N_out, C,
                                                 k, stride, dilation, out_rows, tiles_out);
  else
    bwd_dv_kernel<false><<<out_grid, NT, 0, st>>>(dzf, uf, sf, b1, wf, dbf, stats2, coef2, dvf, pwf, pf, N_in, N_out,
                                                  C, k, stride, dilation, out_rows, tiles_out);
  grad_finalize_kernel<<<fin_grid, NT, 0, st>>>(pf, sf, aux1, static_cast<const float*>(scale1), coef1, dp, dp + C, B,
                                                tiles_out, N_in, C);
  sum_partials_kernel<<<dim3((C + FIN_CH - 1) / FIN_CH, k + 1), NT, 0, st>>>(pwf, dp + (int64_t)2 * C, B * tiles_out,
                                                                            k + 1, C);
  if (transposed)
    bwd_du_kernel<true><<<in_grid, NT, 0, st>>>(dvf, uf, wf, sf, coef1, duf, N_in, N_out, C, k, stride, dilation,
                                                in_rows);
  else
    bwd_du_kernel<false><<<in_grid, NT, 0, st>>>(dvf, uf, wf, sf, coef1, duf, N_in, N_out, C, k, stride, dilation,
                                                 in_rows);
  return (int)cudaGetLastError();
}
