// What K11 (depthwise_norm.cu) and K11-bwd (depthwise_norm_bwd.cu) share: the block shape, one channel's
// statistics and taps, and the depthwise conv of one output row with g normalized on load, so the backward
// recomputes exactly the y (and g) that the forward computed.
#pragma once

#include "common.cuh"

namespace blvm {
namespace depthwise {

constexpr int NT = 256;     // threads a block of the row passes
constexpr int FIN_CH = 64;  // channels a finalize block takes (NT / FIN_CH tile streams each)
constexpr int MAXK = 8;     // taps a channel keeps in registers (the coders' k is 5)

// What one channel of one batch row needs to compute its conv outputs: g's statistics and the taps
struct Channel {
  float mean, mul, beta, bias;
  float w[MAXK];
};

static __device__ __forceinline__ Channel load_channel(const float* stats1, const float* bias1, const float* w,
                                                       const float* db, int b, int c, int C, int k) {
  Channel ch;
  ch.mean = stats1[(int64_t)b * 2 * C + c];
  ch.mul = stats1[(int64_t)b * 2 * C + C + c];
  ch.beta = bias1[c];
  ch.bias = db[c];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) ch.w[j] = j < k ? __ldg(w + (int64_t)j * C + c) : 0.0f;
  return ch;
}

// Each tap's j d as q s + m (0 <= m < s): with o = o_div s + r, the transposed conv's tap j reads input row
// o_div - q exactly when r == m, so no division runs inside the loops
struct Taps {
  int mod[MAXK], div[MAXK];
};

static __device__ __forceinline__ Taps make_taps(int k, int s, int d) {
  Taps tp;
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    tp.div[j] = j < k ? j * d / s : 0;
    tp.mod[j] = j < k ? j * d - tp.div[j] * s : -1;
  }
  return tp;
}

// y = relu(sum_j w[j] g[in(o, j)] + db) of output row o = o_div s + r, g normalized on load: VALID in(o, j) = o s + j d;
// transposed, o = i s + j d for a whole input row i in range (a tap between input rows adds nothing)
template <bool TRANSPOSED>
static __device__ __forceinline__ float conv_at(const float* ub, const Channel& ch, const Taps& tp, int o, int o_div,
                                                int r, int c, int C, int N_in, int k, int s, int d) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j >= k) break;
    int i;
    if (TRANSPOSED) {
      i = o_div - tp.div[j];
      if (r != tp.mod[j] || i < 0 || i >= N_in) continue;
    } else {
      i = o * s + j * d;
    }
    const float g = fmaf(fmaxf(__ldg(ub + (int64_t)i * C + c), 0.0f) - ch.mean, ch.mul, ch.beta);
    acc = fmaf(g, ch.w[j], acc);
  }
  return fmaxf(acc + ch.bias, 0.0f);
}

// conv_at, also handing back each tap's g, and the sums over the taps that read an input row of w[j] and of
// w[j] relu(u) (the row's share of GroupNorm 1's backward sums); a tap that reads no row has g = 0
template <bool TRANSPOSED>
static __device__ __forceinline__ float conv_taps(const float* ub, const Channel& ch, const Taps& tp, int o, int o_div,
                                                  int r, int c, int C, int N_in, int k, int s, int d, float* g,
                                                  float& w_sum, float& wr_sum) {
  float acc = 0.0f;
  w_sum = 0.0f;
  wr_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    g[j] = 0.0f;
    if (j >= k) continue;
    int i;
    if (TRANSPOSED) {
      i = o_div - tp.div[j];
      if (r != tp.mod[j] || i < 0 || i >= N_in) continue;
    } else {
      i = o * s + j * d;
    }
    const float rv = fmaxf(__ldg(ub + (int64_t)i * C + c), 0.0f);
    g[j] = fmaf(rv - ch.mean, ch.mul, ch.beta);
    acc = fmaf(g[j], ch.w[j], acc);
    w_sum += ch.w[j];
    wr_sum = fmaf(ch.w[j], rv, wr_sum);
  }
  return fmaxf(acc + ch.bias, 0.0f);
}

}  // namespace depthwise
}  // namespace blvm
