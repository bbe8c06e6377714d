// The forwards K2 (static_agg.cu) and K3 (dynamic_agg.cu), for Hopper:
// the trunk launch (agg_common.cuh trunk_block, 64 points per block, two
// blocks per SM) and the ray launch, one ray per block.  They replace
// dynibar_tpu/ops/pallas_agg.py:225 _static_kernel and :325
// _dynamic_kernel, with and without residuals (K2/K2r; K3/K3r/K3p).
//
// What bounds them on the H100: operations (their products are far above
// the card's flop/byte ridge); what held them back, by their phase clocks
// (scripts/port_profile.py --forward --phases fwd): the products' k-steps
// waiting on weight fragments from L2 (two trunk blocks per SM leave the
// L1 too little room to keep the weights), the scalar attention (one
// thread per head and query), and the narrow heads' serial, barrier-bound
// layers.  The design: every product on mma.sync, the weights read
// fragment-major (ops/agg.py pack_frag: one 16-byte load per lane and
// k-step), in the trunk through a ring of eight fragments ahead of their
// MMAs (dense_deep), the trunk's one-column outputs (vis_fc's visibility
// logit, vis_fc2) as warp dot products (dot_rows); in the ray launch the
// attention on tensor cores (attn_mma.cuh attn_fwd_mma, the function the
// ray-side backwards K5a, K4a and K4s recompute it with, so the forward
// and every backward round q, k, v and the probabilities at the same
// points, those of dynibar_tpu/ops/pallas_agg.py:122-124,152-153), fc and
// the residual layer norm, then the sigma and RGB heads in 64-row chunks:
// the static blend head takes its first layer's product over the
// geometry feature once per chunk, runs two views' rows per pass and
// copies their inputs by cp.async.
#pragma once

#include "agg_common.cuh"
#include "attn_mma.cuh"

namespace agg {

// 16 bytes from global to shared memory by cp.async (L2 only, not kept in
// the L1), zeros where !valid; cp_async_wait waits for all of the thread's.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool STATIC>
__global__ void __launch_bounds__(NT, 2) trunk_kernel(TrunkArgs a) {
  trunk_block<STATIC>(a, blockIdx.x * PT, WsMap{a.P, 0});
}

struct RayArgs {
  const bf16* W;         // fragment-major (ops/agg.py pack_frag)
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
// the static head's gg [64][128] f32 and, for two views, hin [128][152],
// h1 [128][LDG] and h2 [128][LD64] bf16 span region 2 and o
static_assert((size_t)64 * 128 * 4 + (size_t)128 * (152 + LDG + LD64) * 2 <=
                  kRegion2 + (size_t)SMAX * LDG * 2,
              "the static head's two-view buffers fit region 2 and o");
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
  PhaseClock clk;

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
  dense_deep(gfb, LDG, Sp, a.W, a.B, net.l[WQ],
        [&](int r, int c, float x) { q[r * 128 + c] = f2b(x); });
  dense_deep(gfb, LDG, Sp, a.W, a.B, net.l[WK],
        [&](int r, int c, float x) { k[r * 128 + c] = f2b(x); });
  dense_deep(gfb, LDG, Sp, a.W, a.B, net.l[WV],
        [&](int r, int c, float x) { vv[r * 128 + c] = f2b(x); });
  __syncthreads();
  clk(FR_QKV);
  // per-ray attention over the ray's own samples; a query with at most one
  // valid view attends uniformly (reference mlp_network.py:23-24)
  attn_fwd_mma(q, k, vv, ob, snv, S, Sp, nullptr, nullptr);
  __syncthreads();
  clk(FR_ATTN);
  float* fo = (float*)r2;                          // [SMAX][128] f32
  dense_deep(ob, LDG, Sp, a.W, a.B, net.l[WFC],
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
  clk(FR_FC_LN);

  // ---- heads, 64 rows at a time ----
  for (int r0 = 0; r0 < Sp; r0 += 64) {
    const int rows = min(64, Sp - r0);
    const bf16* g = gfb + r0 * LDG;
    if (STATIC) {
      // rgb_fc's first layer on [gf' (128) | x_v (128) | vis, ray_diff]:
      // the gf' columns are the same for every view, so their product
      // (with the bias) is taken once per chunk into gg, and each view's
      // product runs over the other 144 columns only
      // Two views per pass: the layers' units cover 2 x rows rows, so the
      // narrow second and third layers give every warp one unit of twice
      // the rows, and each view pays half the passes' barriers.  Region 2
      // and o (dead after fc) hold gg, the inputs and the hidden rows.
      constexpr int LDI = 152;
      float* gg = (float*)r2;                      // [64][128] f32
      bf16* hin = (bf16*)(gg + 64 * 128);          // [128][LDI]
      bf16* h1 = hin + 128 * LDI;                  // [128][LDG]
      bf16* h2 = h1 + 128 * LDG;                   // [128][LD64]
      dense_deep(g, LDG, rows, a.W, a.B, net.l[OG0],
            [&](int r, int c, float x) { h1[r * LDG + c] = f2b(elu(x)); });
      __syncthreads();
      dense_deep(h1, LDG, rows, a.W, a.B, net.l[OG1],
            [&](int r, int c, float x) {
              const int i = r0 + r;
              if (c == 0 && i < S)
                a.out[(p0 + i) * 4 + 3] = snv[i] < 1.f ? -1e9f : x;
            });
      __syncthreads();
      clk(FR_SIGMA);
      dense_deep(g, LDG, rows, a.W, a.B, net.l[RGB0],
            [&](int r, int c, float x) { gg[r * 128 + c] = x; }, 0, 128);
      clk.sync(FR_HEAD_PROD);
      const int kr = net.l[RGB0].k - 128;
      // a pass row's view (r / rows) and row in the chunk (r % rows)
      auto vrow = [&](int r, int* rr) {
        const int j = rows == 64 ? r >> 6 : r / rows;
        *rr = r - j * rows;
        return j;
      };
      for (int v0 = 0; v0 < V; v0 += 2) {
        const int nv = min(2, V - v0), prow = nv * rows;
        // x_v as 16-byte asynchronous copies (which leave the L1 to the
        // weights), then vis and ray_diff (streaming loads, the loop
        // unrolled so that they go out together), for view v0 + j in rows
        // j * rows..
        for (int e = tid; e < prow * 16; e += NT) {
          const int rr = e >> 4, q = e & 15;
          int ri;
          const int v = v0 + vrow(rr, &ri), i = r0 + ri;
          cp_async16(hin + rr * LDI + q * 8,
                     a.ws_x + ((size_t)v * P + p0 + min(i, S - 1)) * 128 +
                         q * 8,
                     i < S);
        }
#pragma unroll 4
        for (int e = tid; e < prow * (kr - 128); e += NT) {
          const int rr = e / (kr - 128), col = 128 + e % (kr - 128);
          int ri;
          const int v = v0 + vrow(rr, &ri), i = r0 + ri;
          const size_t p = p0 + i;
          float val = 0.f;
          if (i < S) {
            if (col == 128) val = __ldcs(a.ws_vis + (size_t)v * P + p);
            else if (col < 133)
              val = __ldcs(a.raydiff + (p * V + v) * 4 + col - 129);
          }
          hin[rr * LDI + col] = f2b(val);
        }
        cp_async_wait();
        __syncthreads();
        clk(FR_HEAD_IN);
        dense_deep(hin, LDI, prow, a.W, a.B, net.l[RGB0],
              [&](int r, int c, float x) {
                int rr;
                vrow(r, &rr);
                h1[r * LDG + c] = f2b(elu(x + gg[rr * 128 + c]));
              }, 128, kr, false);
        __syncthreads();
        dense_deep(h1, LDG, prow, a.W, a.B, net.l[RGB1],
              [&](int r, int c, float x) { h2[r * LD64 + c] = f2b(elu(x)); });
        __syncthreads();
        dense_deep(h2, LD64, prow, a.W, a.B, net.l[RGB2],
              [&](int r, int c, float x) {
                int rr;
                const int v = v0 + vrow(r, &rr), i = r0 + rr;
                if (c == 0)
                  lg[v * 64 + rr] =
                      (i < S && a.ws_m[(size_t)v * P + p0 + i] == 0.f) ? -1e9f
                                                                       : x;
              });
        __syncthreads();
        clk(FR_HEAD_PROD);
      }
      // blending: softmax over views in f32, then the views' source colors
      for (int r = tid; r < rows; r += NT) {
        const int i = r0 + r;
        if (i >= S) continue;
        float lmax = -INFINITY;
        for (int v = 0; v < V; ++v) lmax = fmaxf(lmax, lg[v * 64 + r]);
        // every view's source color read at once, then summed in order
        float src[VMAX][3];
#pragma unroll
        for (int v = 0; v < VMAX; ++v) {
          if (v < V) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
              src[v][c] = b2f(a.rgbfeat[((p0 + i) * V + v) * a.C + c]);
          }
        }
        float bsum = 0.f, rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int v = 0; v < VMAX; ++v) {
          if (v >= V) break;
          const float b = expf(lg[v * 64 + r] - lmax);
          bsum += b;
          for (int c = 0; c < 3; ++c) rgb[c] += b * src[v][c];
        }
        for (int c = 0; c < 3; ++c) a.out[(p0 + i) * 4 + c] = rgb[c] / bsum;
      }
      __syncthreads();
      clk(FR_HEAD_OUT);
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
      clk(FR_HEAD_IN);
      dense_deep(in1, LD1, rows, a.W, a.B, net.l[REFPTS0],
            [&](int r, int c, float x) { h256[r * LDH + c] = f2b(elu(x)); });
      __syncthreads();
      dense_deep(h256, LDH, rows, a.W, a.B, net.l[REFPTS1],
            [&](int r, int c, float x) { g2[r * LDG + c] = f2b(elu(x)); });
      __syncthreads();
      dense_deep(g2, LDG, rows, a.W, a.B, net.l[OG0],
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
      dense_deep(h1, LDG, rows, a.W, a.B, net.l[OG1],
            [&](int r, int c, float x) {
              const int i = r0 + r;
              if (c == 0 && i < S)
                a.out[(p0 + i) * 4 + 3] =
                    snv[i] < 1.f ? -1e9f : x - a.shift;
            });
      __syncthreads();
      clk(FR_SIGMA);
      dense_deep(in2, LD2, rows, a.W, a.B, net.l[RGB0],
            [&](int r, int c, float x) { h1[r * LDG + c] = f2b(elu(x)); });
      __syncthreads();
      dense_deep(h1, LDG, rows, a.W, a.B, net.l[RGB1],
            [&](int r, int c, float x) { h2[r * LD64 + c] = f2b(elu(x)); });
      __syncthreads();
      dense_deep(h2, LD64, rows, a.W, a.B, net.l[RGB2],
            [&](int r, int c, float x) {
              const int i = r0 + r;
              if (c < 3 && i < S)
                a.out[(p0 + i) * 4 + c] = snv[i] > 0.f ? sigm(x) : 0.f;
            });
      __syncthreads();
      clk(FR_HEAD_PROD);
    }
  }
}

// Both launches of one aggregator on `stream`; returns the cudaError_t.
template <bool STATIC>
int launch(const TrunkArgs& ta, const RayArgs& ra, int R, cudaStream_t s) {
  if (ta.V > VMAX || ta.S > SMAX || ta.C > CMAX || ta.V < 1 || ta.S < 1)
    return (int)cudaErrorInvalidValue;
  const size_t trunk_bytes = trunk_smem(ta.V);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_kernel<STATIC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)trunk_smem(VMAX));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ray_kernel<STATIC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kRaySmem);
  if (err != cudaSuccess) return (int)err;
  if (ta.P == 0) return 0;
  trunk_kernel<STATIC><<<(ta.P + PT - 1) / PT, NT, trunk_bytes, s>>>(ta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ray_kernel<STATIC><<<R, NT, kRaySmem, s>>>(ra);
  return (int)cudaGetLastError();
}

}  // namespace agg
