// Ray-side dynamic-aggregator backward, the ray phase of K4s: pooling-2 ->
// geometry_fc -> 4-head ray transformer -> heads, recomputed from the
// forward's residuals and transposed, one ray (S <= 128 samples) at a
// time.  (K4a and the static K5a, in these phases, are ray_bwd_sm90.cuh;
// this body was K4a's before it.)
//
// Math of dynibar_tpu/ops/pallas_agg_bwd.py:514 dynamic_bwd_ray_kernel;
// layout of the forward's ray_kernel
// (agg_common.cuh).  Phases per ray:
//   A. geometry feature from the forward's workspace (ws_gf), q/k/v,
//      attention, fc and layer norm (y_hat kept in a per-block f32 scratch);
//   B. the heads in 64-row chunks, forward then transpose; the layer-norm
//      backward of each chunk gives d_o3;
//   C. attention backward: probabilities recomputed from q/k and the row
//      statistics, on tensor cores (attn_mma.cuh, the attention K4a and
//      K5a run).  A query with <= 1 valid view had all its logits replaced
//      by -1e9, so it attends uniformly and its logit cotangents are
//      dropped (pallas_agg_bwd.py:28-31);
//   D. geometry_fc backward from the recomputed pooling-2 input, then the
//      pooling-2 backward per view: d_mean_eff = d_mean - 2 d_var s2,
//      d_x (bf16) and d_vis (f32).
// Weight gradients go to the block's slab (agg_bwd_common.cuh).
#pragma once

#include "agg_bwd_common.cuh"
#include "attn_mma.cuh"

namespace agg {

struct RayBwdArgs {
  const bf16* W;
  const bf16* WT;
  const float* B;
  const float* Z;
  Net net;
  const float* gf;       // [P, 128] geometry_fc output (forward workspace)
  const bf16* ws_x;      // [V, P, 128]
  const float* ws_vis;   // [V, P]
  const float* ws_m;     // [V, P]
  const float* cot;      // [P, 4] cotangent of raw
  int P, S, V, C, R;
  const float* posenc;   // [S, 128]
  const float* pts;      // [P, 3]
  const float* dirpe;    // [R, 27]
  // outputs
  bf16* dx;              // [V, P, 128]
  float* dmisc;          // [V, P, 8]: d_vis in slot 0
  float* d_pts;          // [P, 3]
  float* d_dirpe;        // [R, 27]
  float* scratch;        // [gridDim.x, SMAX, kScratchLd] f32
  float* slabs;          // [kSlabs, slab_len] weight gradients
  int slab_len, w_total;
};

constexpr int LD1 = 184, LD2 = 168;   // dynamic ref_pts_fc / rgb_fc inputs
constexpr int kScratchLd = 128 + 128 + 272;
constexpr size_t kReg1 = 81920, kDo3Off = 47104, kReg2 = 133120;
constexpr size_t kRayBwdSmem =
    kReg1 + kReg2 +
    (3 * SMAX + 12 * SMAX + 256 + 32 + 64 * 3 + NW * VMAX) * 4;
static_assert(kRayBwdSmem <= 232448, "one ray backward block fits an SM");
// the buffers carved by hand out of the two regions below
static_assert((size_t)SMAX * LD1 * 2 <= kDo3Off &&
                  kDo3Off + (size_t)SMAX * LDG * 2 <= kReg1,
              "gf_attn and d_o3 fit region 1");
static_assert((size_t)64 * (LDH + LD2 + LDG + LD64 + LDS) * 2 +
                      64 * 128 * 4 <= kReg2,
              "heads fit region 2");
static_assert((size_t)SMAX * LDA * 2 <= kReg1 &&
                  (size_t)SMAX * (LDH + LDG) * 2 <= kReg2 &&
                  (size_t)SMAX * (3 * 128 + LDG) * 2 <= kReg2,
              "geometry_fc backward and q/k/v/o fit");

// The backward of one ray; workspace rows by `ws`.
__device__ __forceinline__ void ray_bwd_ray(const RayBwdArgs& a, int ray,
                                            const WsMap ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* reg2 = smem + kReg1;
  bf16* GA = (bf16*)smem;                      // gf_attn | pts PE
  bf16* DO3 = (bf16*)(smem + kDo3Off);         // [SMAX][LDG] d_o3, then d_q
  bf16* Q = (bf16*)reg2;                       // [SMAX][128]
  bf16* K = Q + SMAX * 128;
  bf16* Vv = K + SMAX * 128;
  bf16* O = Vv + SMAX * 128;                   // [SMAX][LDG]
  float* snv = (float*)(reg2 + kReg2);
  float* sinv = snv + SMAX;
  float* rstd = sinv + SMAX;
  float* st_m = rstd + SMAX;                   // [4][SMAX]
  float* st_l = st_m + 4 * SMAX;
  float* st_d = st_l + 4 * SMAX;
  float* lng = st_d + 4 * SMAX;                // [256] LN scale | bias grads
  float* sdp = lng + 256;                      // [32] d_dirpe
  float* spp = sdp + 32;                       // [64][3] d_pts
  // [NW][VMAX] pooling-2 weight cotangents, one row per warp: in shared
  // memory, not a register array, which spilled at VMAX = 14
  float* sdw = spp + 64 * 3;

  const Net& net = a.net;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.S, V = a.V, Sp = (S + 15) & ~15;
  const int GLD = LD1;
  float* slab = a.slabs + (size_t)(blockIdx.x % kSlabs) * a.slab_len;
  const int wt = a.w_total;
  float* SY = a.scratch + (size_t)blockIdx.x * SMAX * kScratchLd;  // y_hat
  float* SD = SY + SMAX * 128;                 // d_o3, then d_gf1
  float* SG = SD + SMAX * 128;                 // [SMAX][272] d_gin
  const float* ln_s = a.B + net.l[LN].b;
  const float* ln_b = ln_s + 128;

  {                                 // one ray
    const size_t p0 = (size_t)ray * S;
    auto gf_in = [&](int i, int c) -> float {
      if (i >= S) return 0.f;
      return a.gf[ws.pt(p0 + i) * 128 + c] + a.posenc[i * 128 + c];
    };
    auto load_gf = [&]() {
      for (int e = tid; e < Sp * 128; e += NT)
        O[(e >> 7) * LDG + (e & 127)] = f2b(gf_in(e >> 7, e & 127));
    };
    auto qkv = [&]() {
      dense(O, LDG, Sp, a.W, a.B, net.l[WQ],
            [&](int r, int c, float x) { Q[r * 128 + c] = f2b(x); });
      dense(O, LDG, Sp, a.W, a.B, net.l[WK],
            [&](int r, int c, float x) { K[r * 128 + c] = f2b(x); });
      dense(O, LDG, Sp, a.W, a.B, net.l[WV],
            [&](int r, int c, float x) { Vv[r * 128 + c] = f2b(x); });
    };
    // layer-norm backward of rows r0..r0+rows from d_gf_attn (DF, f32)
    auto ln_bwd = [&](int r0, int rows, const float* DF) {
      for (int r = warp; r < rows; r += NW) {
        const int i = r0 + r;
        float dy[4], yh[4], s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          const float dga = DF[r * 128 + c];
          yh[j] = SY[i * 128 + c];
          atomicAdd(&lng[c], dga * yh[j]);
          atomicAdd(&lng[128 + c], dga);
          dy[j] = dga * ln_s[c];
          s1 += dy[j];
          s2 += dy[j] * yh[j];
        }
        s1 = warp_sum(s1) * (1.f / 128.f);
        s2 = warp_sum(s2) * (1.f / 128.f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          const float d = i < S ? rstd[i] * (dy[j] - s1 - yh[j] * s2) : 0.f;
          SD[i * 128 + c] = d;
          DO3[i * LDG + c] = f2b(d);
        }
      }
    };

    // ---- A: forward recompute up to the layer norm ----
    for (int i = tid; i < Sp; i += NT) {
      float nv = 0.f, vs = 0.f;
      if (i < S)
        for (int v = 0; v < V; ++v) {
          nv += a.ws_m[ws.vp(v, p0 + i)];
          vs += a.ws_vis[ws.vp(v, p0 + i)];
        }
      snv[i] = nv;
      sinv[i] = 1.f / (vs + 1e-8f);
    }
    for (int e = tid; e < 256 + 32; e += NT) lng[e] = 0.f;   // lng, sdp
    load_gf();
    __syncthreads();
    qkv();
    __syncthreads();
    attn_fwd_mma(Q, K, Vv, O, snv, S, Sp, nullptr, nullptr);
    __syncthreads();
    dense(O, LDG, Sp, a.W, a.B, net.l[WFC], [&](int r, int c, float x) {
      SY[r * 128 + c] = x + gf_in(r, c);
    });
    __syncthreads();
    for (int i = warp; i < Sp; i += NW) {
      float x[4], s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = SY[i * 128 + lane + 32 * j];
        s += x[j];
      }
      const float mu = warp_sum(s) / 128.f;
      float var = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) var += (x[j] - mu) * (x[j] - mu);
      const float rs = rsqrtf(warp_sum(var) / 128.f + 1e-6f);
      if (lane == 0) rstd[i] = rs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        const float yh = (x[j] - mu) * rs;
        SY[i * 128 + c] = yh;
        GA[i * GLD + c] = f2b(yh * ln_s[c] + ln_b[c]);
      }
    }
    {
      const int k1 = net.l[REFPTS0].k;
      for (int e = tid; e < Sp * (k1 - 128); e += NT) {
        const int i = e / (k1 - 128), col = e % (k1 - 128);
        GA[i * LD1 + 128 + col] =
            f2b(col < 33 && i < S ? pe_geo(a.pts + (p0 + i) * 3, 3, 5, col)
                                  : 0.f);
      }
    }
    __syncthreads();

    // ---- B: heads, 64 rows at a time: forward, transpose, LN backward ----
    for (int r0 = 0; r0 < Sp; r0 += 64) {
      const int rows = min(64, Sp - r0);
      bf16* RH = (bf16*)reg2;                // [64][LDH]
      bf16* HIN = RH + 64 * LDH;             // [64][LD2] gf2 | dir PE
      bf16* H1 = HIN + 64 * LD2;             // [64][LDG]
      bf16* H2 = H1 + 64 * LDG;              // [64][LD64]
      bf16* D3 = H2 + 64 * LD64;             // [64][LDS]
      float* DF = (float*)(D3 + 64 * LDS);   // [64][128]
      const bf16* rp = GA + r0 * LD1;
      const int k2 = net.l[RGB0].k;
      for (int e = tid; e < 64 * 3; e += NT) spp[e] = 0.f;
      dense(rp, LD1, rows, a.W, a.B, net.l[REFPTS0],
            [&](int r, int c, float x) { RH[r * LDH + c] = f2b(elu(x)); });
      __syncthreads();
      dense(RH, LDH, rows, a.W, a.B, net.l[REFPTS1],
            [&](int r, int c, float x) { HIN[r * LD2 + c] = f2b(elu(x)); });
      for (int e = tid; e < rows * (k2 - 128); e += NT) {
        const int r = e / (k2 - 128), col = 128 + e % (k2 - 128);
        HIN[r * LD2 + col] =
            f2b(col < 155 && r0 + r < S ? a.dirpe[(size_t)ray * 27 + col - 128]
                                        : 0.f);
      }
      __syncthreads();
      // sigma head: sigma - shift, -1e9 (no gradient) where no view is valid
      dense(HIN, LD2, rows, a.W, a.B, net.l[OG0],
            [&](int r, int c, float x) { H1[r * LDG + c] = f2b(elu(x)); });
      for (int e = tid; e < rows * LDS; e += NT) {
        const int r = e / LDS, c = e % LDS, i = r0 + r;
        const float d = c == 0 && i < S && snv[i] >= 1.f
                            ? a.cot[(p0 + i) * 4 + 3] : 0.f;
        if (d != 0.f) atomicAdd(slab + wt + net.l[OG1].b, d);
        D3[e] = f2b(d);
      }
      __syncthreads();
      dw_accum(D3, LDS, H1, LDG, rows, slab, net.l[OG1]);
      __syncthreads();
      dense(D3, LDS, rows, a.WT, a.Z, tr(net.l[OG1]),
            [&](int r, int c, float x) {
              H1[r * LDG + c] = f2b(x * elu_d(b2f(H1[r * LDG + c])));
            });
      __syncthreads();
      grad_layer(H1, LDG, HIN, LD2, rows, slab, wt, net.l[OG0]);
      __syncthreads();
      dense(H1, LDG, rows, a.WT, a.Z, tr(net.l[OG0]),
            [&](int r, int c, float x) { DF[r * 128 + c] = x; });
      __syncthreads();
      // rgb head: sigmoid MLP on [gf2 | dir PE], 0 where no view is valid
      dense(HIN, LD2, rows, a.W, a.B, net.l[RGB0],
            [&](int r, int c, float x) { H1[r * LDG + c] = f2b(elu(x)); });
      __syncthreads();
      dense(H1, LDG, rows, a.W, a.B, net.l[RGB1],
            [&](int r, int c, float x) { H2[r * LD64 + c] = f2b(elu(x)); });
      __syncthreads();
      dense(H2, LD64, rows, a.W, a.B, net.l[RGB2],
            [&](int r, int c, float x) {
              const int i = r0 + r;
              float d = 0.f;
              if (c < 3 && i < S && snv[i] > 0.f) {
                const float rg = sigm(x);
                d = a.cot[(p0 + i) * 4 + c] * rg * (1.f - rg);
                atomicAdd(slab + wt + net.l[RGB2].b + c, d);
              }
              D3[r * LDS + c] = f2b(d);
            });
      __syncthreads();
      dw_accum(D3, LDS, H2, LD64, rows, slab, net.l[RGB2]);
      __syncthreads();
      dense(D3, LDS, rows, a.WT, a.Z, tr(net.l[RGB2]),
            [&](int r, int c, float x) {
              H2[r * LD64 + c] = f2b(x * elu_d(b2f(H2[r * LD64 + c])));
            });
      __syncthreads();
      grad_layer(H2, LD64, H1, LDG, rows, slab, wt, net.l[RGB1]);
      __syncthreads();
      dense(H2, LD64, rows, a.WT, a.Z, tr(net.l[RGB1]),
            [&](int r, int c, float x) {
              H1[r * LDG + c] = f2b(x * elu_d(b2f(H1[r * LDG + c])));
            });
      __syncthreads();
      grad_layer(H1, LDG, HIN, LD2, rows, slab, wt, net.l[RGB0]);
      __syncthreads();
      dense(H1, LDG, rows, a.WT, a.Z, tr(net.l[RGB0]),
            [&](int r, int c, float x) {
              if (c < 128)
                DF[r * 128 + c] += x;
              else if (c < 155 && r0 + r < S)
                atomicAdd(&sdp[c - 128], x);
            });
      __syncthreads();
      // ref_pts_fc (ELU output gf2, then its hidden layer)
      for (int e = tid; e < rows * 128; e += NT) {
        const int r = e >> 7, c = e & 127;
        HIN[r * LD2 + c] = f2b(DF[e] * elu_d(b2f(HIN[r * LD2 + c])));
      }
      __syncthreads();
      grad_layer(HIN, LD2, RH, LDH, rows, slab, wt, net.l[REFPTS1]);
      __syncthreads();
      dense(HIN, LD2, rows, a.WT, a.Z, tr(net.l[REFPTS1]),
            [&](int r, int c, float x) {
              RH[r * LDH + c] = f2b(x * elu_d(b2f(RH[r * LDH + c])));
            });
      __syncthreads();
      grad_layer(RH, LDH, rp, LD1, rows, slab, wt, net.l[REFPTS0]);
      __syncthreads();
      dense(RH, LDH, rows, a.WT, a.Z, tr(net.l[REFPTS0]),
            [&](int r, int c, float x) {
              const int i = r0 + r;
              if (c < 128) {
                DF[r * 128 + c] = x;
              } else if (c < 161 && i < S) {
                int chn;
                const float d =
                    pe_geo_bwd(a.pts + (p0 + i) * 3, 3, 5, c - 128, x, &chn);
                atomicAdd(&spp[r * 3 + chn], d);
              }
            });
      __syncthreads();
      for (int e = tid; e < rows * 3; e += NT) {
        const int i = r0 + e / 3;
        if (i < S) a.d_pts[(p0 + i) * 3 + e % 3] = spp[e];
      }
      ln_bwd(r0, rows, DF);
      __syncthreads();
    }

    // ---- C: attention backward ----
    load_gf();
    __syncthreads();
    qkv();
    __syncthreads();
    attn_fwd_mma(Q, K, Vv, O, snv, S, Sp, st_m, st_l);
    __syncthreads();
    dw_accum(DO3, LDG, O, LDG, Sp, slab, net.l[WFC]);
    __syncthreads();
    dense(DO3, LDG, Sp, a.WT, a.Z, tr(net.l[WFC]),
          [&](int r, int c, float x) { O[r * LDG + c] = f2b(x); });   // d_o
    __syncthreads();
    attn_bwd_mma(Q, K, Vv, O, DO3, snv, S, Sp, st_m, st_l, st_d);
    load_gf();                                       // gf1, the q/k/v input
    __syncthreads();
    dw_accum(DO3, LDG, O, LDG, Sp, slab, net.l[WQ]);
    dw_accum(K, 128, O, LDG, Sp, slab, net.l[WK]);
    dw_accum(Vv, 128, O, LDG, Sp, slab, net.l[WV]);
    dense(DO3, LDG, Sp, a.WT, a.Z, tr(net.l[WQ]),
          [&](int r, int c, float x) { SD[r * 128 + c] += x; });
    __syncthreads();
    dense(K, 128, Sp, a.WT, a.Z, tr(net.l[WK]),
          [&](int r, int c, float x) { SD[r * 128 + c] += x; });
    __syncthreads();
    dense(Vv, 128, Sp, a.WT, a.Z, tr(net.l[WV]),
          [&](int r, int c, float x) { SD[r * 128 + c] += x; });
    __syncthreads();

    // ---- D: geometry_fc and pooling-2 backward ----
    {
      bf16* G = (bf16*)smem;                   // [SMAX][LDA] pooling-2 out
      bf16* H = (bf16*)reg2;                   // [SMAX][LDH]
      bf16* DG = H + SMAX * LDH;               // [SMAX][LDG]
      for (int e = tid; e < Sp * 128; e += NT) {
        const int i = e >> 7, c = e & 127;
        DG[i * LDG + c] = f2b(
            i < S ? SD[e] * elu_d(a.gf[ws.pt(p0 + i) * 128 + c]) : 0.f);
      }
      // pooling-2 of x over views with the visibility weights (as forward)
      for (int e = tid; e < Sp * 16; e += NT) {
        const int i = e >> 4, c0 = (e & 15) * 8;
        float mean[8], var[8];
        for (int j = 0; j < 8; ++j) mean[j] = var[j] = 0.f;
        if (i < S) {
          const size_t p = p0 + i;
          for (int pass = 0; pass < 2; ++pass)
            for (int v = 0; v < V; ++v) {
              const uint4 raw = *reinterpret_cast<const uint4*>(
                  a.ws_x + ws.vp(v, p) * 128 + c0);
              const bf16* xb = reinterpret_cast<const bf16*>(&raw);
              const float w = a.ws_vis[ws.vp(v, p)] * sinv[i];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float xv = b2f(xb[j]);
                if (pass == 0) mean[j] += w * xv;
                else var[j] += w * (xv - mean[j]) * (xv - mean[j]);
              }
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          G[i * LDA + c0 + j] = f2b(mean[j]);
          G[i * LDA + 128 + c0 + j] = f2b(var[j]);
        }
      }
      const int kg = net.l[GEO0].k;
      for (int e = tid; e < Sp * (kg - 256); e += NT) {
        const int i = e / (kg - 256), j = e % (kg - 256);
        float val = 0.f;
        if (j == 0 && i < S) {
          for (int v = 0; v < V; ++v)
            val += a.ws_vis[ws.vp(v, p0 + i)] * sinv[i];
          val /= (float)V;
        }
        G[i * LDA + 256 + j] = f2b(val);
      }
      __syncthreads();
      dense(G, LDA, Sp, a.W, a.B, net.l[GEO0],
            [&](int r, int c, float x) { H[r * LDH + c] = f2b(elu(x)); });
      __syncthreads();
      grad_layer(DG, LDG, H, LDH, Sp, slab, wt, net.l[GEO1]);
      __syncthreads();
      dense(DG, LDG, Sp, a.WT, a.Z, tr(net.l[GEO1]),
            [&](int r, int c, float x) {
              H[r * LDH + c] = f2b(x * elu_d(b2f(H[r * LDH + c])));
            });
      __syncthreads();
      grad_layer(H, LDH, G, LDA, Sp, slab, wt, net.l[GEO0]);
      __syncthreads();
      dense(H, LDH, Sp, a.WT, a.Z, tr(net.l[GEO0]),
            [&](int r, int c, float x) {
              if (c < 257) SG[r * 272 + c] = x;
            });
      __syncthreads();
      // pooling-2 backward, one warp per sample, 4 channels per lane
      for (int i = warp; i < S; i += NW) {
        const size_t p = p0 + i;
        const float inv = sinv[i];
        const int c0 = lane * 4;
        auto load4 = [&](int v, float (&x)[4]) {
          const uint2 raw = *reinterpret_cast<const uint2*>(
              a.ws_x + ws.vp(v, p) * 128 + c0);
          const bf16* xb = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] = b2f(xb[j]);
        };
        float mean[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
        float x[4], dme[4], dvr[4];
        for (int v = 0; v < V; ++v) {
          load4(v, x);
          const float w = a.ws_vis[ws.vp(v, p)] * inv;
#pragma unroll
          for (int j = 0; j < 4; ++j) mean[j] += w * x[j];
        }
        for (int v = 0; v < V; ++v) {
          load4(v, x);
          const float w = a.ws_vis[ws.vp(v, p)] * inv;
#pragma unroll
          for (int j = 0; j < 4; ++j) s2[j] += w * (x[j] - mean[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dvr[j] = SG[i * 272 + 128 + c0 + j];
          dme[j] = SG[i * 272 + c0 + j] - 2.f * dvr[j] * s2[j];
        }
        const float dws = SG[i * 272 + 256] / (float)V;
        float* dw2 = sdw + warp * VMAX;     // written and read by lane 0
        float dvsum = 0.f;
        for (int v = 0; v < V; ++v) {
          load4(v, x);
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part += x[j] * dme[j] +
                    (x[j] - mean[j]) * (x[j] - mean[j]) * dvr[j];
          const float d = warp_sum(part) + dws;
          if (lane == 0) dw2[v] = d;
          dvsum -= inv * inv * a.ws_vis[ws.vp(v, p)] * d;
        }
        for (int v = 0; v < V; ++v) {
          load4(v, x);
          const size_t pv = ws.vp(v, p);
          const float w = a.ws_vis[pv] * inv;
          bf16* dxo = a.dx + pv * 128 + c0;
          __align__(8) bf16 outv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            outv[j] = f2b(w * (dme[j] + 2.f * (x[j] - mean[j]) * dvr[j]));
          }
          *reinterpret_cast<uint2*>(dxo) = *reinterpret_cast<uint2*>(outv);
          if (lane == 0)
            a.dmisc[pv * 8] = 0.f + inv * dw2[v] + dvsum;
        }
      }
      for (int c = tid; c < 256; c += NT)
        atomicAdd(slab + wt + net.l[LN].b + c, lng[c]);
      for (int c = tid; c < 27; c += NT)
          a.d_dirpe[(size_t)ray * 27 + c] = sdp[c];
      __syncthreads();
    }
  }
}

}  // namespace agg
