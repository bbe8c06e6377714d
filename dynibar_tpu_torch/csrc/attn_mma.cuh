// The ray transformer's attention on tensor cores, forward and backward,
// for the ray-side backwards (K5a, K4a and K4s's ray phase:
// ray_bwd_sm90.cuh): one function, so every kernel that holds its gradients
// against another's rounds the attention at the same points, those of
// the JAX bodies (dynibar_tpu/ops/pallas_agg_bwd.py: bf16 q, k, v, d_o,
// probabilities and logit cotangents; f32 logits, softmax and sums).
#pragma once

#include "agg_bwd_common.cuh"

namespace agg {

// One warp per (head, 16-row tile): logits against every row of the other
// side by mma.sync m16n8k16 (the 32 head channels are two 16-deep steps),
// the softmax in f32 on the accumulators, and the products with P or dS
// from the accumulators (two 8-column tiles make one A fragment) times
// rows read transposed by ldmatrix.  Row statistics: the max of the
// scaled logits and the sum of the exponentials.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[nt] = X[r0 + 0..15][h32 + 0..31] . Y[8 nt + 0..7][h32 + 0..31]^T for
// the nt < 2 npair 8-row tiles of Y (ldmatrix, bf16 in shared memory).
__device__ __forceinline__ void attn_logits(float (&acc)[16][4], const bf16* X,
                                            int ldx, const bf16* Y, int ldy,
                                            int r0, int h, int npair) {
  const int lane = threadIdx.x & 31;
  uint32_t a[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldsm_x4(a[ks], smem_u32(X + (size_t)(r0 + (lane & 15)) * ldx + h * 32 +
                            ks * 16 + (lane >> 4) * 8));
#pragma unroll
  for (int np = 0; np < 8; ++np) {
    if (np >= npair) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[2 * np][e] = acc[2 * np + 1][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(Y + (size_t)(16 * np + (lane & 7) +
                                       ((lane >> 4) << 3)) * ldy +
                          h * 32 + ks * 16 + ((lane >> 3) & 1) * 8));
      mma16816(acc[2 * np], a[ks], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// out[nt] (8 channels each, h32 + 8 nt) = M[16 x 16 npair] (accumulator
// layout, rounded to bf16 as the JAX bodies round their probabilities and
// logit cotangents) . Z[0..16 npair - 1][h32 + 0..31].
__device__ __forceinline__ void attn_apply(float (&out)[4][4],
                                           const float (&m)[16][4],
                                           const bf16* Z, int ldz, int h,
                                           int npair) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    if (ks >= npair) break;
    const uint32_t a[4] = {pack_bf16(m[2 * ks][0], m[2 * ks][1]),
                           pack_bf16(m[2 * ks][2], m[2 * ks][3]),
                           pack_bf16(m[2 * ks + 1][0], m[2 * ks + 1][1]),
                           pack_bf16(m[2 * ks + 1][2], m[2 * ks + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(Z + (size_t)(16 * ks + (lane & 7) +
                                         (((lane >> 3) & 1) << 3)) * ldz +
                            h * 32 + 16 * dp + (lane >> 4) * 8));
      mma16816(out[2 * dp], a, b[0], b[1]);
      mma16816(out[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Rows r and r + 8 of a 16-row tile: out (scaled by s0 / s1 per row) into
// D[row][h32 + ..] as bf16, zero where the row is past `valid`.
__device__ __forceinline__ void attn_store(bf16* D, int ldd, int r0, int h,
                                           const float (&out)[4][4], float s0,
                                           float s1, int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    const float sc = row < valid ? (half ? s1 : s0) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<uint32_t*>(D + (size_t)row * ldd + h * 32 + 8 * nt +
                                   2 * t) =
          pack_bf16(out[nt][2 * half] * sc, out[nt][2 * half + 1] * sc);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The forward: O = softmax(Q K^T / sqrt(32)) V per head over the ray's S
// samples; a query with at most one valid view attends uniformly
// (reference mlp_network.py:23-24); rows past S are zero.  Statistics
// into st_m / st_l ([4][SMAX]) when given.
__device__ __noinline__ void attn_fwd_mma(const bf16* Q, const bf16* K,
                                          const bf16* Vv, bf16* O,
                                          const float* snv, int S, int Sp,
                                          float* st_m, float* st_l) {
  const float scale = 0.17677669529663687f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, npair = Sp >> 4;
  for (int u = warp; u < 4 * npair; u += NW) {
    const int h = u & 3, r0 = (u >> 2) * 16;
    float s[16][4];
    attn_logits(s, Q, 128, K, 128, r0, h, npair);
    float mx[2], sum[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      const bool uni = row >= S || snv[row] <= 1.f;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt >= 2 * npair) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * t + e;
          float& x = s[nt][2 * half + e];
          x = j >= S ? -INFINITY : (uni ? 0.f : x * scale);
          m = fmaxf(m, x);
        }
      }
      mx[half] = quad_max(m);
      float l = 0.f;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt >= 2 * npair) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * half + e];
          x = expf(x - mx[half]);
          l += x;
        }
      }
      sum[half] = quad_sum(l);
    }
    float out[4][4];
    attn_apply(out, s, Vv, 128, h, npair);
    attn_store(O, LDG, r0, h, out, 1.f / sum[0], 1.f / sum[1], S);
    if (st_m && t == 0)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row < S) {
          st_m[h * SMAX + row] = mx[half];
          st_l[h * SMAX + row] = sum[half];
        }
      }
  }
}

// The backward from d_o (DO) and the statistics of attn_fwd_mma: d_q into
// DQ (zero for uniform queries, whose logit cotangents are dropped,
// pallas_agg_bwd.py:28-31), then d_k and d_v over K and Vv in place; st_d
// gets D = sum_j p dp per query.  Two passes with the logits recomputed:
// by query tiles (d_q), then by key tiles (d_k, d_v).
__device__ __noinline__ void attn_bwd_mma(const bf16* Q, bf16* K, bf16* Vv,
                                          const bf16* DO, bf16* DQ,
                                          const float* snv, int S, int Sp,
                                          const float* st_m,
                                          const float* st_l, float* st_d) {
  const float scale = 0.17677669529663687f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, npair = Sp >> 4;
  const float uni_p = 1.f / (float)S;
  for (int u = warp; u < 4 * npair; u += NW) {      // d_q by query tiles
    const int h = u & 3, r0 = (u >> 2) * 16;
    float p[16][4], dp[16][4];
    attn_logits(p, Q, 128, K, 128, r0, h, npair);
    attn_logits(dp, DO, LDG, Vv, 128, r0, h, npair);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      const bool grad = row < S && snv[row] > 1.f;
      const float m = grad ? st_m[h * SMAX + row] : 0.f;
      const float il = grad ? 1.f / st_l[h * SMAX + row] : 0.f;
      float dsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt >= 2 * npair) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * t + e;
          float& x = p[nt][2 * half + e];
          x = grad && j < S ? expf(x * scale - m) * il : 0.f;
          dsum += x * dp[nt][2 * half + e];
        }
      }
      const float D = quad_sum(dsum);
      if (grad && t == 0) st_d[h * SMAX + row] = D;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt >= 2 * npair) break;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p[nt][2 * half + e] *= (dp[nt][2 * half + e] - D) * scale;
      }
    }
    float out[4][4];
    attn_apply(out, p, K, 128, h, npair);
    attn_store(DQ, LDG, r0, h, out, 1.f, 1.f, S);
  }
  __syncthreads();
  for (int u = warp; u < 4 * npair; u += NW) {      // d_k, d_v by key tiles
    const int h = u & 3, r0 = (u >> 2) * 16;
    float p[16][4], ds[16][4];
    attn_logits(p, K, 128, Q, 128, r0, h, npair);
    attn_logits(ds, Vv, 128, DO, LDG, r0, h, npair);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (nt >= 2 * npair) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * nt + 2 * t + e;            // the query
        const bool valid = i < S, grad = valid && snv[i] > 1.f;
        const float m = grad ? st_m[h * SMAX + i] : 0.f;
        const float il = grad ? 1.f / st_l[h * SMAX + i] : 0.f;
        const float D = grad ? st_d[h * SMAX + i] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& x = p[nt][2 * half + e];
          x = grad ? expf(x * scale - m) * il : (valid ? uni_p : 0.f);
          float& y = ds[nt][2 * half + e];
          y = grad ? x * (y - D) * scale : 0.f;
        }
      }
    }
    float out[4][4];
    attn_apply(out, p, DO, LDG, h, npair);
    attn_store(Vv, 128, r0, h, out, 1.f, 1.f, S);
    attn_apply(out, ds, Q, 128, h, npair);
    attn_store(K, 128, r0, h, out, 1.f, 1.f, S);
  }
  __syncthreads();
}

}  // namespace agg
