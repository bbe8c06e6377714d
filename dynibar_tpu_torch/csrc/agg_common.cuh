// Shared device code of the fused aggregators K2 (static_agg.cu) and K3
// (dynamic_agg.cu): a tensor-core dense layer, the per-point trunk kernel
// and the per-ray attention + heads kernel.
//
// Math from dynibar_tpu/ops/pallas_agg.py (_vis_pooling, _attention and the
// two kernel bodies); layout from the GPU.  Matmul operands are bf16 with
// f32 accumulation (mma.sync m16n8k16 tensor-core instructions);
// reductions, softmaxes and the layer norm run in f32, as
// pallas_agg.py:27-30 states for the TPU kernels.  Weights come packed by
// ops/agg.py: each layer zero-padded to [ceil16(out), ceil16(in)] bf16,
// biases f32, one slot table (Net).
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
constexpr int VMAX = 12;
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

// One warp's unit of a dense layer: a 16-column tile times NRT 16-row
// tiles.  A (ldmatrix from shared memory) and B (32-bit weight words from
// global memory, L2-resident) for k-step kk+1 are loaded while the MMAs
// of step kk run.
template <int NRT, typename EP>
__device__ __forceinline__ void dense_unit(const bf16* X, int ldx,
                                           const bf16* W, const float* B,
                                           const Lin& L, int nt, int rt0,
                                           EP& ep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nk = L.k >> 4;
  // this lane's weight words: rows nt*16+g and +8, k pair 2t (+8)
  const uint32_t* w0 =
      (const uint32_t*)(W + L.w + (size_t)(nt * 16 + g) * L.k) + t;
  const uint32_t* w1 = w0 + 4 * L.k;
  const uint32_t xs = (uint32_t)__cvta_generic_to_shared(
      X + (size_t)(rt0 * 16 + (lane & 15)) * ldx + (lane >> 4) * 8);
  const uint32_t tile = 16 * ldx * 2;       // bytes between row tiles
  float acc[NRT][2][4];
#pragma unroll
  for (int i = 0; i < NRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][h][j] = 0.f;
  uint32_t a0[NRT][4], a1[NRT][4], b0[4], b1[4];
  auto load = [&](uint32_t (&a)[NRT][4], uint32_t (&b)[4], int kk) {
    b[0] = __ldg(w0 + 8 * kk);
    b[1] = __ldg(w0 + 8 * kk + 4);
    b[2] = __ldg(w1 + 8 * kk);
    b[3] = __ldg(w1 + 8 * kk + 4);
#pragma unroll
    for (int i = 0; i < NRT; ++i) ldsm_x4(a[i], xs + i * tile + 32 * kk);
  };
  auto mma = [&](const uint32_t (&a)[NRT][4], const uint32_t (&b)[4]) {
#pragma unroll
    for (int i = 0; i < NRT; ++i) {
      mma16816(acc[i][0], a[i], b[0], b[1]);
      mma16816(acc[i][1], a[i], b[2], b[3]);
    }
  };
  load(a0, b0, 0);
  for (int kk = 0; kk < nk; kk += 2) {
    if (kk + 1 < nk) load(a1, b1, kk + 1);
    mma(a0, b0);
    if (kk + 1 < nk) {
      if (kk + 2 < nk) load(a0, b0, kk + 2);
      mma(a1, b1);
    }
  }
#pragma unroll
  for (int i = 0; i < NRT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = nt * 16 + h * 8 + 2 * t, r = (rt0 + i) * 16 + g;
      const float bias0 = B[L.b + c], bias1 = B[L.b + c + 1];
      ep(r, c, acc[i][h][0] + bias0);
      ep(r, c + 1, acc[i][h][1] + bias1);
      ep(r + 8, c, acc[i][h][2] + bias0);
      ep(r + 8, c + 1, acc[i][h][3] + bias1);
    }
  }
}

// Y = X @ W^T + b over `rows` rows (a multiple of 16) of X [rows, L.k]
// (bf16 in shared memory, row stride ldx, 16-byte aligned rows), W
// [L.n, L.k] bf16 in global memory, calling ep(row, col, value) for every
// (padded) output column straight from the accumulator registers.  A warp
// owns one 16-column tile and up to four 16-row tiles, so each B fragment
// feeds up to eight MMAs; narrow layers drop to one row tile per warp so
// that every warp has work.  Ends without a block barrier.
template <typename EP>
__device__ void dense(const bf16* X, int ldx, int rows, const bf16* W,
                      const float* B, const Lin L, EP ep) {
  const int warp = threadIdx.x >> 5;
  const int ntile = L.n >> 4, rtiles = rows >> 4;
  const int rpu = ntile * ((rtiles + 3) >> 2) >= NW ? 4 : 1;
  const int units = ntile * ((rtiles + rpu - 1) / rpu);
  for (int u = warp; u < units; u += NW) {
    const int nt = u % ntile, rt0 = (u / ntile) * rpu;
    switch (min(rpu, rtiles - rt0)) {
      case 4: dense_unit<4>(X, ldx, W, B, L, nt, rt0, ep); break;
      case 3: dense_unit<3>(X, ldx, W, B, L, nt, rt0, ep); break;
      case 2: dense_unit<2>(X, ldx, W, B, L, nt, rt0, ep); break;
      default: dense_unit<1>(X, ldx, W, B, L, nt, rt0, ep); break;
    }
  }
}

inline Net load_net(const int* meta) {
  Net net;
  for (int i = 0; i < NLAYERS; ++i)
    net.l[i] = Lin{meta[4 * i], meta[4 * i + 1], meta[4 * i + 2],
                   meta[4 * i + 3]};
  return net;
}

struct TrunkArgs {
  const bf16* W;
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

// 113,920 bytes at PT = 64: two blocks fit an SM's shared memory
constexpr size_t kTrunkSmem =
    (size_t)PT * (LDA + LDH + 2 * LDG) * 2 + 3 * (size_t)VMAX * PT * 4 +
    PT * 4;

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

template <bool STATIC>
__global__ void __launch_bounds__(NT, 2) trunk_kernel(TrunkArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = (bf16*)smem;                        // [PT][LDA] layer inputs
  bf16* buf1 = buf0 + PT * LDA;                    // [PT][LDH] hidden
  bf16* buf2 = buf1 + PT * LDH;                    // [PT][LDG] x*w, x*vis
  bf16* xb = buf2 + PT * LDG;                      // [PT][LDG] trunk x
  float* sm_m = (float*)(xb + PT * LDG);           // [VMAX][PT] masks
  float* sm_w = sm_m + VMAX * PT;                  // pooling weights
  float* sm_vis = sm_w + VMAX * PT;                // visibility (trunk)
  float* sm_e = sm_vis;                            // AA scores (pooling 1)
  float* sm_row = sm_vis + VMAX * PT;              // [PT]

  const Net& net = a.net;
  const int tid = threadIdx.x, p0 = blockIdx.x * PT;
  const int P = a.P, V = a.V, C = a.C, CR = STATIC ? 2 * a.C : a.C;

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
      for (int e = tid; e < PT * C; e += NT) {
        const int r = e / C, c = e % C, p = p0 + r;
        if (p < P)
          a.ws_rf[((size_t)v * P + p) * CR + c] =
              a.rgbfeat[((size_t)p * V + v) * C + c];
      }
      __syncthreads();
      dense(buf0, LDA, PT, a.W, a.B, net.l[RAYDIR0],
            [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
      __syncthreads();
      dense(buf1, LDH, PT, a.W, a.B, net.l[RAYDIR1],
            [&](int r, int c, float x) {
              const int p = p0 + r;
              if (c < C && p < P)
                a.ws_rf[((size_t)v * P + p) * CR + C + c] =
                    f2b(x * a.reffeat[(size_t)(p / a.S) * C + c]);
            });
      __syncthreads();
    }
  } else {
    for (int e = tid; e < V * PT; e += NT) {
      const int v = e / PT, r = e % PT, p = p0 + r;
      sm_m[v * PT + r] = p < P ? a.mask[(size_t)p * V + v] : 0.f;
    }
    __syncthreads();
  }

  auto rf_val = [&](int r, int v, int c) -> float {
    const int p = p0 + r;
    if (p >= P) return 0.f;
    if (STATIC) return b2f(a.ws_rf[((size_t)v * P + p) * CR + c]);
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
    if (p0 + r < P) a.ws_nv[p0 + r] = nv;
  }
  __syncthreads();
  // base_fc input [mean (CR) | var (CR) | rf_v (CR)]: the pooled columns
  // stay in buf0 for every view, only rf_v is rewritten per view
  for (int e = tid; e < PT * CR; e += NT) {
    const int r = e / CR, c = e % CR;
    float mean = 0.f, var = 0.f;
    for (int v = 0; v < V; ++v) mean += sm_w[v * PT + r] * rf_val(r, v, c);
    for (int v = 0; v < V; ++v) {
      const float d = rf_val(r, v, c) - mean;
      var += sm_w[v * PT + r] * d * d;
    }
    buf0[r * LDA + c] = f2b(mean);
    buf0[r * LDA + CR + c] = f2b(var);
  }

  // ---- per-view trunk: base_fc, vis_fc, vis_fc2 ----
  const int kb = net.l[BASE0].k;
  for (int v = 0; v < V; ++v) {
    const float* wv = sm_w + v * PT;
    const float* mk = sm_m + v * PT;
    for (int e = tid; e < PT * (kb - 2 * CR); e += NT) {
      const int r = e / (kb - 2 * CR), c = e % (kb - 2 * CR);
      buf0[r * LDA + 2 * CR + c] = f2b(c < CR ? rf_val(r, v, c) : 0.f);
    }
    __syncthreads();
    dense(buf0, LDA, PT, a.W, a.B, net.l[BASE0],
          [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    dense(buf1, LDH, PT, a.W, a.B, net.l[BASE1],
          [&](int r, int c, float x) {
            const float y = elu(x);
            xb[r * LDG + c] = f2b(y);
            buf2[r * LDG + c] = f2b(y * wv[r]);
          });
    __syncthreads();
    dense(buf2, LDG, PT, a.W, a.B, net.l[VIS0],
          [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    dense(buf1, LDH, PT, a.W, a.B, net.l[VIS1],
          [&](int r, int c, float x) {
            const float t = elu(x);
            if (c < 128) xb[r * LDG + c] = f2b(b2f(xb[r * LDG + c]) + t);
            else if (c == 128) sm_row[r] = sigm(t) * mk[r];
          });
    __syncthreads();
    for (int e = tid; e < PT * 128; e += NT) {
      const int r = e >> 7, c = e & 127;
      buf2[r * LDG + c] = f2b(b2f(xb[r * LDG + c]) * sm_row[r]);
    }
    __syncthreads();
    dense(buf2, LDG, PT, a.W, a.B, net.l[VIS20],
          [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    dense(buf1, LDH, PT, a.W, a.B, net.l[VIS21],
          [&](int r, int c, float x) {
            if (c == 0) sm_vis[v * PT + r] = sigm(x) * mk[r];
          });
    __syncthreads();
    for (int e = tid; e < PT * 16; e += NT) {      // 16-byte row pieces
      const int r = e >> 4, q = (e & 15) * 8, p = p0 + r;
      if (p < P)
        *reinterpret_cast<uint4*>(a.ws_x + ((size_t)v * P + p) * 128 + q) =
            *reinterpret_cast<const uint4*>(xb + r * LDG + q);
    }
    for (int r = tid; r < PT; r += NT) {
      const int p = p0 + r;
      if (p < P) {
        a.ws_vis[(size_t)v * P + p] = sm_vis[v * PT + r];
        a.ws_m[(size_t)v * P + p] = mk[r];
      }
    }
  }
  __syncthreads();

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
        for (int v = 0; v < V; ++v) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              a.ws_x + ((size_t)v * P + p) * 128 + c0);
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
  dense(buf0, LDA, PT, a.W, a.B, net.l[GEO0],
        [&](int r, int c, float x) { buf1[r * LDH + c] = f2b(elu(x)); });
  __syncthreads();
  dense(buf1, LDH, PT, a.W, a.B, net.l[GEO1],
        [&](int r, int c, float x) {
          const int p = p0 + r;
          if (p < P) a.ws_gf[(size_t)p * 128 + c] = elu(x);
        });
}

struct RayArgs {
  const bf16* W;
  const float* B;
  Net net;
  const float* gf;       // [P, 128]
  const float* nv;       // [P]
  int P, S, V, C;
  // static aggregator
  const bf16* ws_x;      // [V, P, 128]
  const float* ws_vis;   // [V, P]
  const float* ws_m;     // [V, P]
  const float* raydiff;  // [P, V, 4]
  const bf16* rgbfeat;   // [P, V, C]
  // dynamic aggregator
  const float* posenc;   // [S, 128] sample-axis encoding
  const float* pts;      // [P, 3]
  const float* dirpe;    // [R, 27]
  float shift;
  float* out;            // [P, 4]
};

constexpr size_t kRegion2 = 3 * (size_t)SMAX * 128 * 2;
constexpr size_t kRaySmem = (size_t)SMAX * LDG * 2 + kRegion2 +
                            (size_t)SMAX * LDG * 2 + (size_t)VMAX * 64 * 4 +
                            SMAX * 4;

template <bool STATIC>
__global__ void __launch_bounds__(NT, 1) ray_kernel(RayArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* gfb = (bf16*)smem;                         // [SMAX][LDG]
  unsigned char* r2 = smem + (size_t)SMAX * LDG * 2;
  bf16* ob = (bf16*)(r2 + kRegion2);               // [SMAX][LDG]
  float* lg = (float*)(ob + SMAX * LDG);           // [VMAX][64]
  float* snv = lg + VMAX * 64;                     // [SMAX]

  const Net& net = a.net;
  const int tid = threadIdx.x, ray = blockIdx.x;
  const int S = a.S, V = a.V, P = a.P, Sp = (S + 15) & ~15;
  const size_t p0 = (size_t)ray * S;

  auto gf_in = [&](int i, int c) -> float {
    if (i >= S) return 0.f;
    const float g = a.gf[(p0 + i) * 128 + c];
    return STATIC ? g : g + a.posenc[i * 128 + c];
  };
  for (int e = tid; e < Sp * 128; e += NT)
    gfb[(e >> 7) * LDG + (e & 127)] = f2b(gf_in(e >> 7, e & 127));
  for (int i = tid; i < Sp; i += NT) snv[i] = i < S ? a.nv[p0 + i] : 0.f;
  __syncthreads();

  // ---- ray transformer: projections, per-ray attention, fc, layer norm --
  bf16* q = (bf16*)r2;
  bf16* k = q + SMAX * 128;
  bf16* vv = k + SMAX * 128;
  dense(gfb, LDG, Sp, a.W, a.B, net.l[WQ],
        [&](int r, int c, float x) { q[r * 128 + c] = f2b(x); });
  dense(gfb, LDG, Sp, a.W, a.B, net.l[WK],
        [&](int r, int c, float x) { k[r * 128 + c] = f2b(x); });
  dense(gfb, LDG, Sp, a.W, a.B, net.l[WV],
        [&](int r, int c, float x) { vv[r * 128 + c] = f2b(x); });
  __syncthreads();
  const float scale = 0.17677669529663687f;       // 1 / sqrt(32)
  for (int pr = tid; pr < 4 * Sp; pr += NT) {
    const int h = pr / Sp, i = pr % Sp;
    bf16* o = ob + i * LDG + h * 32;
    if (i >= S) {
      for (int d = 0; d < 32; ++d) o[d] = f2b(0.f);
      continue;
    }
    float qv[32], acc[32];
    for (int d = 0; d < 32; ++d) {
      qv[d] = b2f(q[i * 128 + h * 32 + d]) * scale;
      acc[d] = 0.f;
    }
    // query-row masking (reference mlp_network.py:23-24): a query with at
    // most one valid view has every logit REPLACED by -1e9, i.e. uniform
    // attention over its ray
    const bool masked = snv[i] <= 1.f;
    float mx = 0.f;
    if (!masked) {
      mx = -INFINITY;
      for (int j = 0; j < S; ++j) {
        const bf16* kj = k + j * 128 + h * 32;
        float l = 0.f;
        for (int d = 0; d < 32; ++d) l += qv[d] * b2f(kj[d]);
        mx = fmaxf(mx, l);
      }
    }
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      float l = 0.f;
      if (!masked) {
        const bf16* kj = k + j * 128 + h * 32;
        for (int d = 0; d < 32; ++d) l += qv[d] * b2f(kj[d]);
        l -= mx;
      }
      const float pj = expf(l);
      sum += pj;
      const bf16* vj = vv + j * 128 + h * 32;
      for (int d = 0; d < 32; ++d) acc[d] += pj * b2f(vj[d]);
    }
    const float inv = 1.f / sum;
    for (int d = 0; d < 32; ++d) o[d] = f2b(acc[d] * inv);
  }
  __syncthreads();
  float* fo = (float*)r2;                          // [SMAX][128] f32
  dense(ob, LDG, Sp, a.W, a.B, net.l[WFC],
        [&](int r, int c, float x) { fo[r * 128 + c] = x + gf_in(r, c); });
  __syncthreads();
  {
    const int warp = tid >> 5, lane = tid & 31;
    const float* ln_s = a.B + net.l[LN].b;
    const float* ln_b = ln_s + 128;
    for (int i = warp; i < Sp; i += NW) {
      float x[4], s = 0.f;
      for (int j = 0; j < 4; ++j) {
        x[j] = fo[i * 128 + lane + 32 * j];
        s += x[j];
      }
      for (int off = 16; off; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const float mu = s / 128.f;
      float var = 0.f;
      for (int j = 0; j < 4; ++j) {
        const float d = x[j] - mu;
        var += d * d;
      }
      for (int off = 16; off; off >>= 1)
        var += __shfl_xor_sync(0xffffffffu, var, off);
      const float rs = rsqrtf(var / 128.f + 1e-6f);
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        gfb[i * LDG + c] = f2b((x[j] - mu) * rs * ln_s[c] + ln_b[c]);
      }
    }
  }
  __syncthreads();

  // ---- heads, 64 rows at a time ----
  for (int r0 = 0; r0 < Sp; r0 += 64) {
    const int rows = min(64, Sp - r0);
    const bf16* g = gfb + r0 * LDG;
    if (STATIC) {
      bf16* hin = (bf16*)r2;                       // [64][LDA]
      bf16* h1 = hin + 64 * LDA;                   // [64][LDG]
      bf16* h2 = h1 + 64 * LDG;                    // [64][LD64]
      dense(g, LDG, rows, a.W, a.B, net.l[OG0],
            [&](int r, int c, float x) { h1[r * LDG + c] = f2b(elu(x)); });
      __syncthreads();
      dense(h1, LDG, rows, a.W, a.B, net.l[OG1],
            [&](int r, int c, float x) {
              const int i = r0 + r;
              if (c == 0 && i < S)
                a.out[(p0 + i) * 4 + 3] = snv[i] < 1.f ? -1e9f : x;
            });
      __syncthreads();
      const int kr = net.l[RGB0].k;
      for (int v = 0; v < V; ++v) {
        // [gf' (128) | x_v (128)] as 16-byte copies, then vis, ray_diff
        for (int e = tid; e < rows * 32; e += NT) {
          const int r = e >> 5, q = e & 31, i = r0 + r;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (q < 16)
            val = *reinterpret_cast<const uint4*>(g + r * LDG + q * 8);
          else if (i < S)
            val = *reinterpret_cast<const uint4*>(
                a.ws_x + ((size_t)v * P + p0 + i) * 128 + (q - 16) * 8);
          *reinterpret_cast<uint4*>(hin + r * LDA + q * 8) = val;
        }
        for (int e = tid; e < rows * (kr - 256); e += NT) {
          const int r = e / (kr - 256), col = 256 + e % (kr - 256);
          const int i = r0 + r;
          const size_t p = p0 + i;
          float val = 0.f;
          if (i < S) {
            if (col == 256) val = a.ws_vis[(size_t)v * P + p];
            else if (col < 261) val = a.raydiff[(p * V + v) * 4 + col - 257];
          }
          hin[r * LDA + col] = f2b(val);
        }
        __syncthreads();
        dense(hin, LDA, rows, a.W, a.B, net.l[RGB0],
              [&](int r, int c, float x) { h1[r * LDG + c] = f2b(elu(x)); });
        __syncthreads();
        dense(h1, LDG, rows, a.W, a.B, net.l[RGB1],
              [&](int r, int c, float x) { h2[r * LD64 + c] = f2b(elu(x)); });
        __syncthreads();
        dense(h2, LD64, rows, a.W, a.B, net.l[RGB2],
              [&](int r, int c, float x) {
                const int i = r0 + r;
                if (c == 0)
                  lg[v * 64 + r] =
                      (i < S && a.ws_m[(size_t)v * P + p0 + i] == 0.f) ? -1e9f
                                                                       : x;
              });
        __syncthreads();
      }
      // blending: softmax over views in f32, then the views' source colors
      for (int r = tid; r < rows; r += NT) {
        const int i = r0 + r;
        if (i >= S) continue;
        float lmax = -INFINITY;
        for (int v = 0; v < V; ++v) lmax = fmaxf(lmax, lg[v * 64 + r]);
        float bsum = 0.f, rgb[3] = {0.f, 0.f, 0.f};
        for (int v = 0; v < V; ++v) {
          const float b = expf(lg[v * 64 + r] - lmax);
          const bf16* src = a.rgbfeat + ((p0 + i) * V + v) * a.C;
          bsum += b;
          for (int c = 0; c < 3; ++c) rgb[c] += b * b2f(src[c]);
        }
        for (int c = 0; c < 3; ++c) a.out[(p0 + i) * 4 + c] = rgb[c] / bsum;
      }
      __syncthreads();
    } else {
      constexpr int LD1 = 184, LD2 = 168;
      bf16* in1 = (bf16*)r2;                       // [64][LD1]
      bf16* h256 = in1 + 64 * LD1;                 // [64][LDH]
      bf16* g2 = h256 + 64 * LDH;                  // [64][LDG]
      bf16* h1 = g2 + 64 * LDG;                    // [64][LDG]
      bf16* h2 = ob;                               // [64][LD64]
      bf16* in2 = ob + 64 * LD64;                  // [64][LD2]
      const int k1 = net.l[REFPTS0].k, k2 = net.l[RGB0].k;
      for (int e = tid; e < rows * k1; e += NT) {
        const int r = e / k1, col = e % k1, i = r0 + r;
        bf16 val = f2b(0.f);
        if (col < 128) val = g[r * LDG + col];
        else if (col < 161 && i < S)
          val = f2b(pe_geo(a.pts + (p0 + i) * 3, 3, 5, col - 128));
        in1[r * LD1 + col] = val;
      }
      __syncthreads();
      dense(in1, LD1, rows, a.W, a.B, net.l[REFPTS0],
            [&](int r, int c, float x) { h256[r * LDH + c] = f2b(elu(x)); });
      __syncthreads();
      dense(h256, LDH, rows, a.W, a.B, net.l[REFPTS1],
            [&](int r, int c, float x) { g2[r * LDG + c] = f2b(elu(x)); });
      __syncthreads();
      dense(g2, LDG, rows, a.W, a.B, net.l[OG0],
            [&](int r, int c, float x) { h1[r * LDG + c] = f2b(elu(x)); });
      for (int e = tid; e < rows * k2; e += NT) {
        const int r = e / k2, col = e % k2, i = r0 + r;
        bf16 val = f2b(0.f);
        if (col < 128) val = g2[r * LDG + col];
        else if (col < 155 && i < S)
          val = f2b(a.dirpe[(size_t)ray * 27 + col - 128]);
        in2[r * LD2 + col] = val;
      }
      __syncthreads();
      dense(h1, LDG, rows, a.W, a.B, net.l[OG1],
            [&](int r, int c, float x) {
              const int i = r0 + r;
              if (c == 0 && i < S)
                a.out[(p0 + i) * 4 + 3] =
                    snv[i] < 1.f ? -1e9f : x - a.shift;
            });
      __syncthreads();
      dense(in2, LD2, rows, a.W, a.B, net.l[RGB0],
            [&](int r, int c, float x) { h1[r * LDG + c] = f2b(elu(x)); });
      __syncthreads();
      dense(h1, LDG, rows, a.W, a.B, net.l[RGB1],
            [&](int r, int c, float x) { h2[r * LD64 + c] = f2b(elu(x)); });
      __syncthreads();
      dense(h2, LD64, rows, a.W, a.B, net.l[RGB2],
            [&](int r, int c, float x) {
              const int i = r0 + r;
              if (c < 3 && i < S)
                a.out[(p0 + i) * 4 + c] = snv[i] > 0.f ? sigm(x) : 0.f;
            });
      __syncthreads();
    }
  }
}

// Both launches of one aggregator on `stream`; returns the cudaError_t.
template <bool STATIC>
int launch(const TrunkArgs& ta, const RayArgs& ra, int R, cudaStream_t s) {
  if (ta.V > VMAX || ta.S > SMAX || ta.C > CMAX || ta.V < 1 || ta.S < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_kernel<STATIC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTrunkSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ray_kernel<STATIC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kRaySmem);
  if (err != cudaSuccess) return (int)err;
  if (ta.P == 0) return 0;
  trunk_kernel<STATIC><<<(ta.P + PT - 1) / PT, NT, kTrunkSmem, s>>>(ta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ray_kernel<STATIC><<<R, NT, kRaySmem, s>>>(ra);
  return (int)cudaGetLastError();
}

}  // namespace agg
