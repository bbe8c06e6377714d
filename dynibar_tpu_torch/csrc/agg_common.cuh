// Shared device code of the fused aggregators K2 (static_agg.cu) and K3
// (dynamic_agg.cu) and their backwards: the tensor-core dense layers and
// the per-point trunk block (the launches: agg_fwd.cuh).
//
// Math from dynibar_tpu/ops/pallas_agg.py (_vis_pooling, _attention and the
// two kernel bodies); layout from the GPU.  Matmul operands are bf16 with
// f32 accumulation (mma.sync m16n8k16 tensor-core instructions);
// reductions, softmaxes and the layer norm run in f32, as
// pallas_agg.py:27-30 states for the TPU kernels.  Weights come packed by
// ops/agg.py: each layer zero-padded to [ceil16(out), ceil16(in)] bf16,
// biases f32, one slot table (Net); the forwards, the trunk backwards and
// K5d read them fragment-major (pack_frag; the backwards' transposed
// products pack_frag_t) through `dense_deep`.
//
// Each aggregator is two launches on the caller's stream:
//   1. trunk_kernel, 64 points per block, all views of those points:
//      per-view input features and pooling weights, mean/var pooling, the
//      base/vis/vis2 trunk view by view, the visibility re-pooling and
//      geometry_fc.  The per-view trunk output x [V, P, 128] bf16 and
//      vis/mask [V, P] go to a global workspace the wrapper allocates: for
//      one fine-stage ray (V=11, S=128) x alone is 360 KB, more than a
//      block's shared memory, and it is re-read by the static RGB head.
//   2. ray_kernel, one ray per block: q/k/v projections, per-ray softmax
//      attention over the ray's own S samples (no N x N block-diagonal
//      mask), the residual layer norm, then the sigma and RGB heads in
//      64-row chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase_clock.cuh"

namespace agg {

using bf16 = __nv_bfloat16;

// layer slots; ops/agg.py fills the same ids
enum Layer {
  RAYDIR0, RAYDIR1, BASE0, BASE1, VIS0, VIS1, VIS20, VIS21, GEO0, GEO1,
  WQ, WK, WV, WFC, LN, OG0, OG1, RGB0, RGB1, RGB2, REFPTS0, REFPTS1,
  AA_S,          // bias slot only: the static anti-alias scalar s
  NLAYERS
};

struct Lin { int w, b, k, n; };     // weight/bias offsets, padded in/out
struct Net { Lin l[NLAYERS]; };

constexpr int NT = 256;             // threads per block
constexpr int NW = NT / 32;
constexpr int PT = 64;              // points per trunk block (2 per SM)
// views: the mono model's 14 static views (2 x num_source_views); the
// per-view [V][PT] f32 arrays are sized by the launch's V, so FF shapes
// keep their footprint
constexpr int VMAX = 14;
constexpr int SMAX = 128;
constexpr int CMAX = 40;            // 3 + feature channels
constexpr int LDA = 280;            // bf16 row strides (multiples of 8)
constexpr int LDH = 264;
constexpr int LDG = 136;
constexpr int LD64 = 72;

__device__ __forceinline__ bf16 f2b(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }
// ELU and sigmoid on the fast exp: exp(x) - 1 as the TPU kernels compute
// it (pallas_agg.py:72-79); the error is far below the bf16 rounding the
// results go through.
__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : __expf(x) - 1.f;
}
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// Periodic embedding column `col` of x[0..nch): [x, cos(2^f x), sin(2^f x)]
// with frequency-major, channel-minor blocks (core/posenc.periodic_embed).
__device__ __forceinline__ float pe_geo(const float* x, int nch, int nfreq,
                                        int col) {
  if (col < nch) return x[col];
  int j = col - nch;
  const bool is_sin = j >= nfreq * nch;
  if (is_sin) j -= nfreq * nch;
  const float a = (float)(1 << (j / nch)) * x[j % nch];
  return is_sin ? sinf(a) : cosf(a);
}

// ldmatrix / mma.sync helpers (bf16 m16n8k16, f32 accumulate).  Fragment
// layouts are the PTX ISA's: with g = lane / 4 and t = lane % 4, A holds
// rows g and g+8 at columns 2t, 2t+1 (+8); B holds k = 2t, 2t+1 (+8) of
// column g; C holds rows g and g+8 at columns 2t and 2t+1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The dense layer of the forwards (trunk_block, which K4s's trunk phase
// runs too, and the ray launch), of the trunk backwards (trunk_bwd.cuh, the
// transposes on pack_frag_t) and of K5d (static_agg_bwd3.cu), on the
// fragment-major pack (ops/agg.py pack_frag: a lane's B-fragment words of
// one 16x16 weight tile are one 16-byte load, the warp's 512 bytes
// contiguous).  Two trunk blocks per SM leave the L1 too little room to
// keep the weights, so every weight fragment is an L2 round trip, and one
// step of prefetch left each k-step waiting on it.  Here a ring of kBD
// fragments in registers keeps the loads kBD k-steps ahead of their MMAs;
// A (ldmatrix from shared memory) is read at its step.  Fragment layouts
// are the PTX ISA's (see mma16816); each output column's products are
// added in k order.
constexpr int kBD = 8;

// Where the fragment-major pack keeps W[n][k] of layer L: tile (n/16,
// k/16), lane 4 (n % 8) + (k % 8) / 2, pair 2 (n % 16 / 8) + (k % 16 / 8),
// element k % 2.
__device__ __forceinline__ int frag_index(const Lin& L, int n, int k) {
  return L.w + ((((n >> 4) * (L.k >> 4) + (k >> 4)) * 32 + (n & 7) * 4 +
                 ((k & 7) >> 1)) * 4 + ((n >> 3) & 1) * 2 + ((k >> 3) & 1)) *
                   2 + (k & 1);
}

template <int NRT, typename EP>
__device__ __forceinline__ void dense_unit_deep(const bf16* X, int ldx,
                                                const bf16* W, const float* B,
                                                const Lin& L, int nt, int rt0,
                                                EP& ep, int k0, int nk,
                                                bool bias) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4* wf = reinterpret_cast<const uint4*>(
                        W + L.w + (size_t)nt * 16 * L.k) +
                    (k0 >> 4) * 32 + lane;
  const uint32_t xs = (uint32_t)__cvta_generic_to_shared(
      X + (size_t)(rt0 * 16 + (lane & 15)) * ldx + (lane >> 4) * 8);
  const uint32_t tile = 16 * ldx * 2;       // bytes between row tiles
  float acc[NRT][2][4];
#pragma unroll
  for (int i = 0; i < NRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
  uint4 b[kBD];
#pragma unroll
  for (int d = 0; d < kBD; ++d)
    if (d < nk) b[d] = __ldg(wf + 32 * d);
  for (int k0 = 0; k0 < nk; k0 += kBD) {
#pragma unroll
    for (int d = 0; d < kBD; ++d) {
      const int kk = k0 + d;
      if (kk < nk) {
        uint32_t a[NRT][4];
#pragma unroll
        for (int i = 0; i < NRT; ++i) ldsm_x4(a[i], xs + i * tile + 32 * kk);
#pragma unroll
        for (int i = 0; i < NRT; ++i) {
          mma16816(acc[i][0], a[i], b[d].x, b[d].y);
          mma16816(acc[i][1], a[i], b[d].z, b[d].w);
        }
        if (kk + kBD < nk) b[d] = __ldg(wf + 32 * (kk + kBD));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NRT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = nt * 16 + h * 8 + 2 * t, r = (rt0 + i) * 16 + g;
      const float bias0 = bias ? B[L.b + c] : 0.f;
      const float bias1 = bias ? B[L.b + c + 1] : 0.f;
      ep(r, c, acc[i][h][0] + bias0);
      ep(r, c + 1, acc[i][h][1] + bias1);
      ep(r + 8, c, acc[i][h][2] + bias0);
      ep(r + 8, c + 1, acc[i][h][3] + bias1);
    }
  }
}

// Y = X @ W^T + b over `rows` rows (a multiple of 16) of X [rows, L.k]
// (bf16 in shared memory, row stride ldx, 16-byte aligned rows), W
// [L.n, L.k] bf16 fragment-major in global memory, calling ep(row, col,
// value) for every (padded) output column straight from the accumulator
// registers, in units of dense_unit_deep: a warp owns one 16-column tile
// and as many row tiles (4, 2 or 1) as keeps the fewest rounds of units
// over the warps, the most units among those (a unit's k-loop is a chain
// of L2 waits, so a layer takes about rounds x k-steps of them:
// ray_dir_fc's 48-column second layer runs six units of two row tiles in
// one round, not twelve of one in two).  Optionally over the weight
// columns [k0, k0 + kn) only (X's columns 0..kn) and without the bias.
// NTH: the block's threads (the trunk backwards run 512).  Ends without a
// block barrier.
template <int NTH = NT, typename EP>
__device__ void dense_deep(const bf16* X, int ldx, int rows, const bf16* W,
                           const float* B, const Lin L, EP ep, int k0 = 0,
                           int kn = -1, bool bias = true) {
  constexpr int NWB = NTH / 32;
  const int nk = (kn < 0 ? L.k - k0 : kn) >> 4;
  const int warp = threadIdx.x >> 5;
  const int ntile = L.n >> 4, rtiles = rows >> 4;
  auto rounds = [&](int r) {
    return (ntile * ((rtiles + r - 1) / r) + NWB - 1) / NWB;
  };
  int rpu = 4;
  if (rounds(2) <= rounds(rpu)) rpu = 2;
  if (rounds(1) <= rounds(rpu)) rpu = 1;
  const int units = ntile * ((rtiles + rpu - 1) / rpu);
  for (int u = warp; u < units; u += NWB) {
    const int nt = u % ntile, rt0 = (u / ntile) * rpu;
    switch (min(rpu, rtiles - rt0)) {
      case 4:
        dense_unit_deep<4>(X, ldx, W, B, L, nt, rt0, ep, k0, nk, bias);
        break;
      case 3:
        dense_unit_deep<3>(X, ldx, W, B, L, nt, rt0, ep, k0, nk, bias);
        break;
      case 2:
        dense_unit_deep<2>(X, ldx, W, B, L, nt, rt0, ep, k0, nk, bias);
        break;
      default:
        dense_unit_deep<1>(X, ldx, W, B, L, nt, rt0, ep, k0, nk, bias);
    }
  }
}


// One output column `col` of layer L (fragment-major pack) with its bias,
// for the trunk's layers whose other output columns are padding or
// computed apart (vis_fc's visibility logit, vis_fc2): a warp per four
// rows at a time, each lane the k pairs 2 lane + 64 m, summed in f32
// across the warp (the four rows' shuffle chains interleaved); ep(row,
// value) on lane 0.  A 16-column MMA layer would pay a whole k-loop of L2
// waits for one column.  L.k <= 256.  Ends without a block barrier.
template <typename EP>
__device__ void dot_rows(const bf16* X, int ldx, int rows, const bf16* W,
                         const float* B, const Lin& L, int col, EP ep) {
  constexpr int kRows = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2 w[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = 64 * m + 2 * lane;
    w[m] = k < L.k ? __bfloat1622float2(
                         *reinterpret_cast<const __nv_bfloat162*>(
                             W + frag_index(L, col, k)))
                   : make_float2(0.f, 0.f);
  }
  const float bias = B[L.b + col];
  for (int r0 = warp * kRows; r0 < rows; r0 += NW * kRows) {
    float sum[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      sum[j] = 0.f;
      const int r = min(r0 + j, rows - 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int k = 64 * m + 2 * lane;
        if (k < L.k) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(X + (size_t)r * ldx +
                                                       k));
          sum[j] += x.x * w[m].x + x.y * w[m].y;
        }
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < rows) ep(r0 + j, sum[j] + bias);
  }
}

inline Net load_net(const int* meta) {
  Net net;
  for (int i = 0; i < NLAYERS; ++i)
    net.l[i] = Lin{meta[4 * i], meta[4 * i + 1], meta[4 * i + 2],
                   meta[4 * i + 3]};
  return net;
}

// Where a point's rows sit in a workspace: the two-launch routes keep every
// point's ([V, P, .] from point 0), the single-kernel backward K4s one ray's
// points in a per-block scratch ([V, S, .] from the ray's first point).
struct WsMap {
  int P, p0;
  __device__ __forceinline__ size_t vp(int v, size_t p) const {
    return (size_t)v * P + (p - p0);
  }
  __device__ __forceinline__ size_t pt(size_t p) const { return p - p0; }
};

struct TrunkArgs {
  const bf16* W;         // fragment-major (ops/agg.py pack_frag)
  const float* B;
  Net net;
  const bf16* rgbfeat;   // [P, V, C]
  const float* mask;     // [P, V]
  int P, S, V, C;
  // static aggregator
  const float* pts;      // [P, 3]
  const float* reffeat;  // [R, C]  ref_feature_fc(ref Plücker PE)
  const float* raydiff;  // [P, V, 4]
  const float* srcpl;    // [P, V, 6]
  int anti_alias, mask_rgb;
  bf16* ws_rf;           // [V, P, 2C]
  // dynamic aggregator
  const float* dirfeat;  // [P, C]  ray_dir_fc(time PE)
  // outputs
  bf16* ws_x;            // [V, P, 128]
  float* ws_vis;         // [V, P]
  float* ws_m;           // [V, P] effective mask
  float* ws_gf;          // [P, 128] geometry_fc output
  float* ws_nv;          // [P] number of valid views
};

// 104,704 + 768 V bytes at PT = 64 (113,152 at V = 11, 115,456 at 14):
// two blocks fit an SM's 233,472 bytes up to V = 14 with the 1 KB each
// block reserves
constexpr size_t trunk_smem(int V) {
  return (size_t)PT * (LDA + LDH + 2 * LDG) * 2 + 3 * (size_t)V * PT * 4 +
         PT * 4;
}
static_assert(2 * (trunk_smem(VMAX) + 1024) <= 233472,
              "two forward trunk blocks per SM at VMAX views");

// x and its sin/cos(2^f x) for f < 5 into an encoded row laid out as
// core/posenc.periodic_embed: [raw (n), cos (5n), sin (5n)], channel ch.
__device__ __forceinline__ void pe5(bf16* row, int n, int ch, float x) {
  row[ch] = f2b(x);
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    float sn, cs;
    sincosf((float)(1 << f) * x, &sn, &cs);
    row[n + f * n + ch] = f2b(cs);
    row[6 * n + f * n + ch] = f2b(sn);
  }
}

// One 64-point block of the trunk from point p0; workspace rows by `ws`.
template <bool STATIC>
__device__ __forceinline__ void trunk_block(const TrunkArgs& a, int p0,
                                            const WsMap ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = (bf16*)smem;                        // [PT][LDA] layer inputs
  bf16* buf1 = buf0 + PT * LDA;                    // [PT][LDH] hidden
  bf16* buf2 = buf1 + PT * LDH;                    // [PT][LDG] x*w, x*vis
  bf16* xb = buf2 + PT * LDG;                      // [PT][LDG] trunk x
  const Net& net = a.net;
  const int tid = threadIdx.x;
  const int P = a.P, V = a.V, C = a.C, CR = STATIC ? 2 * a.C : a.C;
  float* sm_m = (float*)(xb + PT * LDG);           // [V][PT] masks
  float* sm_w = sm_m + V * PT;                     // pooling weights
  float* sm_vis = sm_w + V * PT;                   // visibility (trunk)
  float* sm_e = sm_vis;                            // AA scores (pooling 1)
  float* sm_row = sm_vis + V * PT;                 // [PT]
  PhaseClock clk;

  // ---- per-view input features rf, masks and anti-alias scores ----
  if (STATIC) {
    const int kin = net.l[RAYDIR0].k;
    const float s_abs = a.anti_alias ? fabsf(a.B[net.l[AA_S].b]) : 0.f;
    // ray_dir_fc input [pts PE (33) | src Plücker PE (66) | ray_diff (4)]:
    // the point encoding is the same for every view
    for (int e = tid; e < PT * 3; e += NT) {
      const int r = e / 3, ch = e % 3, p = p0 + r;
      pe5(buf0 + r * LDA, 3, ch, p < P ? a.pts[3 * (size_t)p + ch] : 0.f);
    }
    for (int v = 0; v < V; ++v) {
      for (int e = tid; e < PT * 6; e += NT) {
        const int r = e / 6, ch = e % 6, p = p0 + r;
        pe5(buf0 + r * LDA + 33, 6, ch,
            p < P ? a.srcpl[((size_t)p * V + v) * 6 + ch] : 0.f);
      }
      for (int e = tid; e < PT * (kin - 99); e += NT) {
        const int r = e / (kin - 99), j = e % (kin - 99), p = p0 + r;
        buf0[r * LDA + 99 + j] =
            f2b(j < 4 && p < P ? a.raydiff[((size_t)p * V + v) * 4 + j] : 0.f);
      }
      for (int r = tid; r < PT; r += NT) {
        const int p = p0 + r;
        float m = 0.f, ex = 0.f;
        if (p < P) {
          const size_t pv = (size_t)p * V + v;
          m = a.mask[pv];
          if (a.mask_rgb) {
            const bf16* rgb = a.rgbfeat + pv * C;
            const float sum = b2f(rgb[0]) + b2f(rgb[1]) + b2f(rgb[2]);
            m = sum > 1e-3f ? m : 0.f;
          }
          ex = expf(s_abs * (a.raydiff[4 * pv + 3] - 1.f));
        }
        sm_m[v * PT + r] = m;
        sm_e[v * PT + r] = ex;
      }
#pragma unroll 4
      for (int e = tid; e < PT * C; e += NT) {
        const int r = e / C, c = e % C, p = p0 + r;
        if (p < P)
          a.ws_rf[ws.vp(v, p) * CR + c] =
              a.rgbfeat[((size_t)p * V + v) * C + c];
      }
      __syncthreads();
      clk(FT_IN);
      dense_deep(buf0, LDA, PT, a.W, a.B, net.l[RAYDIR0],
            [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
      __syncthreads();
      dense_deep(buf1, LDH, PT, a.W, a.B, net.l[RAYDIR1],
            [&](int r, int c, float x) {
              const int p = p0 + r;
              if (c < C && p < P)
                a.ws_rf[ws.vp(v, p) * CR + C + c] =
                    f2b(x * a.reffeat[(size_t)(p / a.S) * C + c]);
            });
      __syncthreads();
      clk(FT_IN_PROD);
    }
  } else {
    for (int e = tid; e < V * PT; e += NT) {
      const int v = e / PT, r = e % PT, p = p0 + r;
      sm_m[v * PT + r] = p < P ? a.mask[(size_t)p * V + v] : 0.f;
    }
    __syncthreads();
    clk(FT_IN);
  }

  auto rf_val = [&](int r, int v, int c) -> float {
    const int p = p0 + r;
    if (p >= P) return 0.f;
    if (STATIC) return b2f(a.ws_rf[ws.vp(v, p) * CR + c]);
    return b2f(f2b(b2f(a.rgbfeat[((size_t)p * V + v) * C + c]) +
                   a.dirfeat[(size_t)p * C + c]));
  };

  // ---- pooling weights and the first mean/variance pooling ----
  for (int r = tid; r < PT; r += NT) {
    float nv = 0.f;
    for (int v = 0; v < V; ++v) nv += sm_m[v * PT + r];
    if (STATIC && a.anti_alias) {
      float emin = sm_e[r];
      for (int v = 1; v < V; ++v) emin = fminf(emin, sm_e[v * PT + r]);
      float wsum = 0.f;
      for (int v = 0; v < V; ++v) {
        const float w = (sm_e[v * PT + r] - emin) * sm_m[v * PT + r];
        sm_w[v * PT + r] = w;
        wsum += w;
      }
      const float inv = 1.f / (wsum + 1e-8f);
      for (int v = 0; v < V; ++v) sm_w[v * PT + r] *= inv;
    } else {
      const float inv = 1.f / (nv + 1e-8f);
      for (int v = 0; v < V; ++v) sm_w[v * PT + r] = sm_m[v * PT + r] * inv;
    }
    if (p0 + r < P) a.ws_nv[ws.pt(p0 + r)] = nv;
  }
  __syncthreads();
  // base_fc input [mean (CR) | var (CR) | rf_v (CR)]: the pooled columns
  // stay in buf0 for every view, only rf_v is rewritten per view
  // (the view loops unrolled so that their L2 reads go out together)
  for (int e = tid; e < PT * CR; e += NT) {
    const int r = e / CR, c = e % CR;
    float mean = 0.f, var = 0.f;
#pragma unroll 4
    for (int v = 0; v < V; ++v) mean += sm_w[v * PT + r] * rf_val(r, v, c);
#pragma unroll 4
    for (int v = 0; v < V; ++v) {
      const float d = rf_val(r, v, c) - mean;
      var += sm_w[v * PT + r] * d * d;
    }
    buf0[r * LDA + c] = f2b(mean);
    buf0[r * LDA + CR + c] = f2b(var);
  }
  clk.sync(FT_POOL1);

  // ---- per-view trunk: base_fc, vis_fc, vis_fc2 ----
  const int kb = net.l[BASE0].k;
  for (int v = 0; v < V; ++v) {
    const float* wv = sm_w + v * PT;
    const float* mk = sm_m + v * PT;
#pragma unroll 4
    for (int e = tid; e < PT * (kb - 2 * CR); e += NT) {
      const int r = e / (kb - 2 * CR), c = e % (kb - 2 * CR);
      buf0[r * LDA + 2 * CR + c] = f2b(c < CR ? rf_val(r, v, c) : 0.f);
    }
    __syncthreads();
    clk(FT_ELEM);
    dense_deep(buf0, LDA, PT, a.W, a.B, net.l[BASE0],
          [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    dense_deep(buf1, LDH, PT, a.W, a.B, net.l[BASE1],
          [&](int r, int c, float x) {
            const float y = elu(x);
            xb[r * LDG + c] = f2b(y);
            buf2[r * LDG + c] = f2b(y * wv[r]);
          });
    __syncthreads();
    dense_deep(buf2, LDG, PT, a.W, a.B, net.l[VIS0],
          [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    {
      Lin vis1 = net.l[VIS1];
      vis1.n = 128;                // column 128, the visibility logit, apart
      dense_deep(buf1, LDH, PT, a.W, a.B, vis1,
            [&](int r, int c, float x) {
              xb[r * LDG + c] = f2b(b2f(xb[r * LDG + c]) + elu(x));
            });
    }
    dot_rows(buf1, LDH, PT, a.W, a.B, net.l[VIS1], 128,
             [&](int r, float x) { sm_row[r] = sigm(elu(x)) * mk[r]; });
    __syncthreads();
    clk(FT_PROD);
    for (int e = tid; e < PT * 128; e += NT) {
      const int r = e >> 7, c = e & 127;
      buf2[r * LDG + c] = f2b(b2f(xb[r * LDG + c]) * sm_row[r]);
    }
    __syncthreads();
    clk(FT_ELEM);
    dense_deep(buf2, LDG, PT, a.W, a.B, net.l[VIS20],
          [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    dot_rows(buf1, LDH, PT, a.W, a.B, net.l[VIS21], 0,
             [&](int r, float x) { sm_vis[v * PT + r] = sigm(x) * mk[r]; });
    __syncthreads();
    clk(FT_PROD);
    for (int e = tid; e < PT * 16; e += NT) {      // 16-byte row pieces
      const int r = e >> 4, q = (e & 15) * 8, p = p0 + r;
      if (p < P)
        *reinterpret_cast<uint4*>(a.ws_x + ws.vp(v, p) * 128 + q) =
            *reinterpret_cast<const uint4*>(xb + r * LDG + q);
    }
    for (int r = tid; r < PT; r += NT) {
      const int p = p0 + r;
      if (p < P) {
        a.ws_vis[ws.vp(v, p)] = sm_vis[v * PT + r];
        a.ws_m[ws.vp(v, p)] = mk[r];
      }
    }
  }
  __syncthreads();
  clk(FT_ELEM);

  // ---- visibility re-pooling and geometry_fc ----
  for (int r = tid; r < PT; r += NT) {
    float vsum = 0.f;
    for (int v = 0; v < V; ++v) vsum += sm_vis[v * PT + r];
    const float inv = 1.f / (vsum + 1e-8f);
    float wmean = 0.f;
    for (int v = 0; v < V; ++v) {
      const float w2 = sm_vis[v * PT + r] * inv;
      sm_w[v * PT + r] = w2;
      wmean += w2;
    }
    sm_row[r] = wmean / (float)V;
  }
  __syncthreads();
  // mean/var of x over views, 8 channels per thread (16-byte loads)
  for (int e = tid; e < PT * 16; e += NT) {
    const int r = e >> 4, c0 = (e & 15) * 8, p = p0 + r;
    float mean[8], var[8], xv[8];
    for (int j = 0; j < 8; ++j) mean[j] = var[j] = 0.f;
    if (p < P) {
      for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 4
        for (int v = 0; v < V; ++v) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              a.ws_x + ws.vp(v, p) * 128 + c0);
          const bf16* xb = reinterpret_cast<const bf16*>(&raw);
          const float w = sm_w[v * PT + r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            xv[j] = b2f(xb[j]);
            if (pass == 0) mean[j] += w * xv[j];
            else var[j] += w * (xv[j] - mean[j]) * (xv[j] - mean[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      buf0[r * LDA + c0 + j] = f2b(mean[j]);
      buf0[r * LDA + 128 + c0 + j] = f2b(var[j]);
    }
  }
  const int kg = net.l[GEO0].k;
  for (int e = tid; e < PT * (kg - 256); e += NT) {
    const int r = e / (kg - 256), j = e % (kg - 256);
    buf0[r * LDA + 256 + j] = f2b(j == 0 ? sm_row[r] : 0.f);
  }
  __syncthreads();
  dense_deep(buf0, LDA, PT, a.W, a.B, net.l[GEO0],
        [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
  __syncthreads();
  dense_deep(buf1, LDH, PT, a.W, a.B, net.l[GEO1],
        [&](int r, int c, float x) {
          const int p = p0 + r;
          if (p < P) a.ws_gf[ws.pt(p) * 128 + c] = elu(x);
        });
  clk(FT_POOL2);
}

// Blocks of `kernel` one SM holds at `threads` threads and `smem` bytes of
// dynamic shared memory (the occupancy calculator), or -1 on an error.
template <typename Kern>
int blocks_per_sm(Kern kernel, size_t smem, int threads = NT) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace agg
