// K5a and K4a, the static and dynamic ray backward, for Hopper: pooling-2
// -> geometry_fc -> 4-head ray transformer -> heads, recomputed from the
// forward's residuals (K2r, K3r) and transposed, one ray (S <= 128
// samples) per block, persistent blocks.  STATIC picks the heads: the
// static sigma head and the per-view blend-logit rgb head with its softmax
// over views, or the dynamic ref_pts_fc, sigma head (sigma - shift) and
// sigmoid rgb head.
//
// Math of dynibar_tpu/ops/pallas_agg_bwd.py:879 static_bwd_ray_kernel and
// :514 dynamic_bwd_ray_kernel (and K4s's ray phase, dynamic_agg_bwd1.cu),
// in phases:
//   A. geometry feature from the forward's workspace (dynamic: plus the
//      positional encoding), q/k/v, attention, fc and layer norm (y_hat
//      kept in a per-block f32 scratch);
//   B. the heads in 64-row chunks.  Static: the sigma head forward and
//      transposed, the blend logits of every view, their softmax over
//      views, then per view the rgb head forward again and transposed.
//      Dynamic: ref_pts_fc on [gf_attn | pts PE], the sigma head and the
//      rgb head on [gf2 | dir PE], forward then transposed, back through
//      ref_pts_fc (d_pts).  The layer-norm backward of each chunk gives
//      d_o3;
//   C. attention backward (probabilities recomputed from q/k and the row
//      statistics, in f32; a query with <= 1 valid view attends uniformly
//      and its logit cotangents are dropped, pallas_agg_bwd.py:28-31);
//   D. geometry_fc backward from the recomputed pooling-2 input, then the
//      pooling-2 backward per view: d_x (bf16) and d_vis (f32).
//
// What bounds it on the H100: operations (3x the ray side's forward matmul
// flops; static: the blend head, 261 -> 128 -> 64 -> 1 per (sample, view),
// is three quarters of them).  The design (sm90_common.cuh): every layer
// product runs on wgmma m64nNk16 (N up to 64) with its weights streamed
// through a ring of three 8 KB slabs in shared memory, filled by bulk
// copies from the tiled pack ahead of the products (no W^T pack, no
// weight fragment from global memory inside a product).  The attention
// runs on mma.sync (attn_mma.cuh).  Segments: A's four products; static,
// per chunk the sigma head's three, the logit pass (three per view) and
// the transposed pass (five per view); dynamic, the heads' thirteen per
// chunk, one segment over the chunks; C's seven; D's three.  The room:
// the attention row statistics (12 x 128 f32) live in a per-block global
// workspace.  Static: the geometry_fc input keeps 272 columns; the blend
// head's weights (88 KB) do not fit beside the phase-B buffers, so they
// stream through the ring once per view and pass.  Dynamic: o (phases A
// and C) sits over gf_attn, which is dead whenever o is live, so region 2
// holds only q/k/v or the heads' buffers; none of the heads' 246 KB of
// weights can be resident (the asserts below), so all of them stream.
// Weight gradients stay on mma.sync into the slabs (agg_bwd_common.cuh).
#pragma once

#include "agg_bwd_common.cuh"
#include "attn_mma.cuh"
#include "phase_clock.cuh"
#include "sm90_common.cuh"

namespace agg {

struct RayBwd90Args {
  const bf16* Wt;        // tiled weights (sm90_common.cuh)
  const float* B;
  Net net;
  const float* gf;       // [P, 128] geometry_fc output (K2r / K3r workspace)
  const bf16* ws_x;      // [V, P, 128]
  const float* ws_vis;   // [V, P]
  const float* ws_m;     // [V, P]
  const float* cot;      // [P, 4] cotangent of raw
  int P, S, V, C, R;
  // static
  const float* raydiff;  // [P, V, 4]
  const bf16* rgbfeat;   // [P, V, C]
  // dynamic
  const float* posenc;   // [S, 128]
  const float* pts;      // [P, 3]
  const float* dirpe;    // [R, 27]
  float* d_pts;          // [P, 3]
  float* d_dirpe;        // [R, 27]
  // outputs
  bf16* dx;              // [V, P, 128]
  float* dmisc;          // [V, P, 8]: d_vis; static d_rgb, d_raydiff (1:8)
  float* scratch;        // [gridDim.x, SMAX, kRayScratchLd] f32
  float* stats;          // [gridDim.x, 12, SMAX] attention row statistics
  float* slabs;          // [kSlabs, slab_len] weight gradients
  int slab_len, w_total;
};

constexpr int kRayLdg = 272;        // geometry_fc input, 257 -> 272 cols
constexpr int kRayStages = 3;
// the per-block f32 scratch rows: y_hat | d_o3, then d_gf1 | d_gin (272)
constexpr int kRayScratchLd = 128 + 128 + 272;
constexpr size_t kRayRing = (size_t)kRayStages * kSlabBytes + kRingSmemBytes;

// Static (K5a): the ring (25,600), regions 1 and 2, then the f32 rows:
// 231,360 bytes.
constexpr size_t kSR1 = (size_t)SMAX * kRayLdg * 2;     // 69,632
constexpr size_t kSR2 = (size_t)SMAX * (3 * 128 + LDG) * 2;   // 133,120
constexpr size_t kStaticRayBwdSmem =
    kRayRing + kSR1 + kSR2 + (3 * SMAX + 256 + NW * VMAX) * 4;
static_assert(kStaticRayBwdSmem <= 232448, "one K5a block fits an SM");
static_assert(2 * (size_t)SMAX * LDG * 2 <= kSR1,
              "gf_attn and d_o3 fit region 1");
static_assert((size_t)64 * (LDA + LDG + LD64 + LDS) * 2 + 64 * 128 * 4 +
                      2 * (size_t)VMAX * 64 * 4 <= kSR2,
              "heads (LG, PB [VMAX][64]) fit region 2");
static_assert((size_t)SMAX * (LDH + LDG) * 2 <= kSR2 &&
                  (size_t)SMAX * (3 * 128 + LDG) * 2 <= kSR2,
              "geometry_fc backward and q/k/v/o fit region 2");

// Dynamic (K4a): region 1 holds [gf_attn | pts PE] (ref_pts_fc's input,
// 161 -> 176 columns) and d_o3, o over gf_attn, and in phase D the
// pooling-2 output; region 2 q/k/v, the heads' buffers or the geometry_fc
// backward; f32 rows (incl. d_dirpe and a chunk's d_pts): 229,184 bytes.
constexpr int kRayLd1 = 184;        // [gf_attn | pts PE], 176 cols
constexpr int kRayLd2 = 168;        // [gf2 | dir PE], 160 cols
constexpr size_t kDDo3 = (size_t)SMAX * kRayLd1 * 2;    // 47,104
constexpr size_t kDR1 = kDDo3 + (size_t)SMAX * LDG * 2;  // 81,920
constexpr size_t kDHeads =
    (size_t)64 * (LDH + kRayLd2 + LDG + LD64 + LDS) * 2 + 64 * 128 * 4;
constexpr size_t kDR2 = kDHeads;                          // 117,760
constexpr size_t kDynRayF32 = (3 * SMAX + 256 + 32 + 64 * 3 + NW * VMAX) * 4;
constexpr size_t kDynRayBwdSmem = kRayRing + kDR1 + kDR2 + kDynRayF32;
static_assert(kDynRayBwdSmem <= 232448, "one K4a block fits an SM");
static_assert((size_t)SMAX * LDG * 2 <= kDDo3,
              "o (phases A and C) fits over gf_attn");
static_assert((size_t)SMAX * kRayLdg * 2 <= kDR1,
              "the pooling-2 output (phase D) fits region 1");
static_assert((size_t)SMAX * 3 * 128 * 2 <= kDR2 &&
                  (size_t)SMAX * (LDH + LDG) * 2 <= kDR2,
              "q/k/v and the geometry_fc backward fit region 2");
// The heads' padded weights (ref_pts_fc 256x176 + 128x256, out_geometry_fc
// 128x128 + 16x128, rgb_fc 128x160 + 64x128 + 16x64, bf16): 251,904 bytes,
// more than the block's whole shared memory, let alone the 28,864 bytes
// its buffers leave: every head weight streams through the ring.
constexpr size_t kDynHeadWeights =
    2 * (256 * 176 + 128 * 256 + 128 * 128 + 16 * 128 + 128 * 160 +
         64 * 128 + 16 * 64);
static_assert(kDynHeadWeights > 232448 - (kDynRayBwdSmem - kRayRing),
              "the dynamic heads' weights stream");

// The backward of one ray; `smem` is the block's buffer past the ring,
// workspace rows by `ws` (K4s keeps one ray's in a per-block scratch).
template <bool STATIC>
__device__ __forceinline__ void ray_bwd90_ray(const RayBwd90Args& a, int ray,
                                              WRing<kRayStages>& ring,
                                              unsigned char* smem,
                                              const WsMap ws) {
  constexpr int GLD = STATIC ? LDG : kRayLd1;  // gf_attn's row stride
  unsigned char* reg2 = smem + (STATIC ? kSR1 : kDR1);
  bf16* GA = (bf16*)smem;                      // [SMAX][GLD] gf_attn (| PE)
  bf16* DO3 = (bf16*)(smem + (STATIC ? (size_t)SMAX * LDG * 2 : kDDo3));
  bf16* Q = (bf16*)reg2;                       // [SMAX][128]
  bf16* K = Q + SMAX * 128;
  bf16* Vv = K + SMAX * 128;
  // [SMAX][LDG]: static after v, dynamic over gf_attn
  bf16* O = STATIC ? Vv + SMAX * 128 : GA;
  float* snv = (float*)(reg2 + (STATIC ? kSR2 : kDR2));
  float* sinv = snv + SMAX;
  float* rstd = sinv + SMAX;
  float* lng = rstd + SMAX;                    // [256] LN scale | bias grads
  float* sdp = lng + 256;                      // dynamic: [32] d_dirpe
  float* spp = sdp + 32;                       // dynamic: [64][3] d_pts
  // [NW][VMAX] pooling-2 weight cotangents, one row per warp
  float* sdw = STATIC ? lng + 256 : spp + 64 * 3;

  const Net& net = a.net;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.S, V = a.V, Sp = (S + 15) & ~15;
  float* slab = a.slabs + (size_t)(blockIdx.x % kSlabs) * a.slab_len;
  const int wt = a.w_total;
  float* SY = a.scratch + (size_t)blockIdx.x * SMAX * kRayScratchLd;
  float* SD = SY + SMAX * 128;                 // d_o3, then d_gf1
  float* SG = SD + SMAX * 128;                 // [SMAX][272] d_gin
  float* st_m = a.stats + (size_t)blockIdx.x * 12 * SMAX;   // [4][SMAX]
  float* st_l = st_m + 4 * SMAX;
  float* st_d = st_l + 4 * SMAX;
  const float* ln_s = a.B + net.l[LN].b;
  const float* ln_b = ln_s + 128;
  PhaseClock clk;

  const size_t p0 = (size_t)ray * S;
  auto vp = [&](int v, size_t p) -> size_t { return ws.vp(v, p); };
  auto gf_in = [&](int i, int c) -> float {
    if (i >= S) return 0.f;
    const float g = a.gf[ws.pt(p0 + i) * 128 + c];
    return STATIC ? g : g + a.posenc[i * 128 + c];
  };
  auto load_gf = [&]() {
    for (int e = tid; e < Sp * 128; e += NT)
      O[(e >> 7) * LDG + (e & 127)] = f2b(gf_in(e >> 7, e & 127));
  };
  auto qkv = [&]() {
    ring.consume(WQ, 0, O, LDG, Sp, a.B,
                 [&](int r, int c, float x) { Q[r * 128 + c] = f2b(x); });
    ring.consume(WK, 0, O, LDG, Sp, a.B,
                 [&](int r, int c, float x) { K[r * 128 + c] = f2b(x); });
    ring.consume(WV, 0, O, LDG, Sp, a.B,
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
        nv += a.ws_m[vp(v, p0 + i)];
        vs += a.ws_vis[vp(v, p0 + i)];
      }
    snv[i] = nv;
    sinv[i] = 1.f / (vs + 1e-8f);
  }
  for (int e = tid; e < (STATIC ? 256 : 256 + 32); e += NT) lng[e] = 0.f;
  load_gf();
  const WOp kA[4] = {{WQ, 0}, {WK, 0}, {WV, 0}, {WFC, 0}};
  ring.begin(kA, 4, 1, Sp);
  qkv();
  __syncthreads();
  attn_fwd_mma(Q, K, Vv, O, snv, S, Sp, nullptr, nullptr);
  __syncthreads();
  ring.consume(WFC, 0, O, LDG, Sp, a.B, [&](int r, int c, float x) {
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
  if (!STATIC) {                     // ref_pts_fc input: | pts PE | 0 |
    const int k1 = net.l[REFPTS0].k;
    for (int e = tid; e < Sp * (k1 - 128); e += NT) {
      const int i = e / (k1 - 128), col = e % (k1 - 128);
      GA[i * GLD + 128 + col] =
          f2b(col < 33 && i < S ? pe_geo(a.pts + (p0 + i) * 3, 3, 5, col)
                                : 0.f);
    }
  }
  __syncthreads();
  clk(RP_A);

  // ---- B: heads, 64 rows at a time: forward, transpose, LN backward ----
  if constexpr (STATIC) {
  for (int r0 = 0; r0 < Sp; r0 += 64) {
    const int rows = min(64, Sp - r0);
    bf16* HIN = (bf16*)reg2;                   // [64][LDA]
    bf16* H1 = HIN + 64 * LDA;                 // [64][LDG]
    bf16* H2 = H1 + 64 * LDG;                  // [64][LD64]
    bf16* D3 = H2 + 64 * LD64;                 // [64][LDS]
    float* DF = (float*)(D3 + 64 * LDS);       // [64][128]
    float* LG = DF + 64 * 128;                 // [VMAX][64] (asserted above)
    float* PB = LG + VMAX * 64;                // [VMAX][64]
    const bf16* g = GA + r0 * LDG;
    const int kr = net.l[RGB0].k;
    // sigma head: -1e9 (no gradient) where no view is valid
    const WOp kSigma[3] = {{OG0, 0}, {OG1, 1}, {OG0, 1}};
    ring.begin(kSigma, 3, 1, rows);
    ring.consume(OG0, 0, g, LDG, rows, a.B,
                 [&](int r, int c, float x) { H1[r * LDG + c] = f2b(elu(x)); });
    for (int e = tid; e < rows * LDS; e += NT) {
      const int r = e / LDS, c = e % LDS, i = r0 + r;
      const float d = c == 0 && i < S && snv[i] >= 1.f
                          ? a.cot[(p0 + i) * 4 + 3] : 0.f;
      if (d != 0.f) atomicAdd(slab + wt + net.l[OG1].b, d);
      D3[e] = f2b(d);
    }
    __syncthreads();
    clk(RP_HEAD_FWD);
    dw_accum(D3, LDS, H1, LDG, rows, slab, net.l[OG1]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(OG1, 1, D3, LDS, rows, nullptr, [&](int r, int c, float x) {
      H1[r * LDG + c] = f2b(x * elu_d(b2f(H1[r * LDG + c])));
    });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    grad_layer(H1, LDG, g, LDG, rows, slab, wt, net.l[OG0]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(OG0, 1, H1, LDG, rows, nullptr,
                 [&](int r, int c, float x) { DF[r * 128 + c] = x; });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    // per-view blend-logit head: [gf' | x_v | vis_v | ray_diff_v]
    auto head_in = [&](int v) {
      for (int e = tid; e < rows * 32; e += NT) {
        const int r = e >> 5, q = e & 31, i = r0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q < 16)
          val = *reinterpret_cast<const uint4*>(g + r * LDG + q * 8);
        else if (i < S)
          val = *reinterpret_cast<const uint4*>(
              a.ws_x + vp(v, p0 + i) * 128 + (q - 16) * 8);
        *reinterpret_cast<uint4*>(HIN + r * LDA + q * 8) = val;
      }
      for (int e = tid; e < rows * (kr - 256); e += NT) {
        const int r = e / (kr - 256), col = 256 + e % (kr - 256);
        const int i = r0 + r;
        const size_t p = p0 + i;
        float val = 0.f;
        if (i < S) {
          if (col == 256) val = a.ws_vis[vp(v, p)];
          else if (col < 261) val = a.raydiff[(p * V + v) * 4 + col - 257];
        }
        HIN[r * LDA + col] = f2b(val);
      }
      __syncthreads();
      clk(RP_HEAD_ELEM);
      ring.consume(RGB0, 0, HIN, LDA, rows, a.B, [&](int r, int c, float x) {
        H1[r * LDG + c] = f2b(elu(x));
      });
      __syncthreads();
      clk(RP_HEAD_FWD);
      ring.consume(RGB1, 0, H1, LDG, rows, a.B, [&](int r, int c, float x) {
        H2[r * LD64 + c] = f2b(elu(x));
      });
      __syncthreads();
      clk(RP_HEAD_FWD);
    };
    const WOp kLogit[3] = {{RGB0, 0}, {RGB1, 0}, {RGB2, 0}};
    ring.begin(kLogit, 3, V, rows);
    for (int v = 0; v < V; ++v) {
      head_in(v);
      ring.consume(RGB2, 0, H2, LD64, rows, a.B, [&](int r, int c, float x) {
        const int i = r0 + r;
        if (c == 0)
          LG[v * 64 + r] =
              (i < S && a.ws_m[vp(v, p0 + i)] == 0.f) ? -1e9f : x;
      });
      __syncthreads();
      clk(RP_HEAD_FWD);
    }
    // softmax over views; d_logit = p (dp - sum_u p_u dp_u) on valid views
    for (int r = tid; r < rows; r += NT) {
      const int i = r0 + r;
      if (i >= S) {
        for (int v = 0; v < V; ++v) LG[v * 64 + r] = 0.f;
        continue;
      }
      const size_t p = p0 + i;
      float lmax = -INFINITY, bsum = 0.f, sb = 0.f;
      for (int v = 0; v < V; ++v) lmax = fmaxf(lmax, LG[v * 64 + r]);
      for (int v = 0; v < V; ++v) {
        PB[v * 64 + r] = expf(LG[v * 64 + r] - lmax);
        bsum += PB[v * 64 + r];
      }
      const float drgb[3] = {a.cot[p * 4], a.cot[p * 4 + 1],
                             a.cot[p * 4 + 2]};
      for (int v = 0; v < V; ++v) {
        const bf16* src = a.rgbfeat + (p * V + v) * a.C;
        const float pv = PB[v * 64 + r] / bsum;
        const float dp = b2f(src[0]) * drgb[0] + b2f(src[1]) * drgb[1] +
                         b2f(src[2]) * drgb[2];
        PB[v * 64 + r] = pv;
        LG[v * 64 + r] = dp;
        sb += pv * dp;
        for (int c = 0; c < 3; ++c)
          a.dmisc[vp(v, p) * 8 + 1 + c] = pv * drgb[c];
      }
      for (int v = 0; v < V; ++v)
        LG[v * 64 + r] = a.ws_m[vp(v, p)] > 0.f
                             ? PB[v * 64 + r] * (LG[v * 64 + r] - sb)
                             : 0.f;
    }
    __syncthreads();
    clk(RP_HEAD_ELEM);
    const WOp kRgbT[5] = {{RGB0, 0}, {RGB1, 0}, {RGB2, 1}, {RGB1, 1},
                          {RGB0, 1}};
    ring.begin(kRgbT, 5, V, rows);
    for (int v = 0; v < V; ++v) {
      head_in(v);
      for (int e = tid; e < rows * LDS; e += NT)
        D3[e] = f2b(e % LDS == 0 ? LG[v * 64 + e / LDS] : 0.f);
      // no bias gradient: the blend-logit bias cancels in the softmax over
      // views, so its gradient is identically zero
      __syncthreads();
      clk(RP_HEAD_ELEM);
      dw_accum(D3, LDS, H2, LD64, rows, slab, net.l[RGB2]);
      __syncthreads();
      clk(RP_HEAD_DW);
      ring.consume(RGB2, 1, D3, LDS, rows, nullptr,
                   [&](int r, int c, float x) {
                     H2[r * LD64 + c] = f2b(x * elu_d(b2f(H2[r * LD64 + c])));
                   });
      __syncthreads();
      clk(RP_HEAD_TRANS);
      grad_layer(H2, LD64, H1, LDG, rows, slab, wt, net.l[RGB1]);
      __syncthreads();
      clk(RP_HEAD_DW);
      ring.consume(RGB1, 1, H2, LD64, rows, nullptr,
                   [&](int r, int c, float x) {
                     H1[r * LDG + c] = f2b(x * elu_d(b2f(H1[r * LDG + c])));
                   });
      __syncthreads();
      clk(RP_HEAD_TRANS);
      grad_layer(H1, LDG, HIN, LDA, rows, slab, wt, net.l[RGB0]);
      __syncthreads();
      clk(RP_HEAD_DW);
      ring.consume(RGB0, 1, H1, LDG, rows, nullptr,
                   [&](int r, int c, float x) {
                     const int i = r0 + r;
                     if (c < 128) {
                       DF[r * 128 + c] += x;
                     } else if (i < S) {
                       const size_t pv = vp(v, p0 + i);
                       if (c < 256) a.dx[pv * 128 + c - 128] = f2b(x);
                       else if (c == 256) a.dmisc[pv * 8] = x;
                       else if (c < 261) a.dmisc[pv * 8 + 4 + c - 257] = x;
                     }
                   });
      __syncthreads();
      clk(RP_HEAD_TRANS);
    }
    ln_bwd(r0, rows, DF);
    __syncthreads();
    clk(RP_HEAD_ELEM);
  }

  } else {
  bf16* RH = (bf16*)reg2;                      // [64][LDH] ref_pts_fc hidden
  bf16* HIN = RH + 64 * LDH;                   // [64][kRayLd2] gf2 | dir PE
  bf16* H1 = HIN + 64 * kRayLd2;               // [64][LDG]
  bf16* H2 = H1 + 64 * LDG;                    // [64][LD64]
  bf16* D3 = H2 + 64 * LD64;                   // [64][LDS]
  float* DF = (float*)(D3 + 64 * LDS);         // [64][128]
  const int k2 = net.l[RGB0].k;
  const WOp kHeads[13] = {
      {REFPTS0, 0}, {REFPTS1, 0}, {OG0, 0},  {OG1, 1},     {OG0, 1},
      {RGB0, 0},    {RGB1, 0},    {RGB2, 0}, {RGB2, 1},    {RGB1, 1},
      {RGB0, 1},    {REFPTS1, 1}, {REFPTS0, 1}};
  ring.begin(kHeads, 13, (Sp + 63) / 64, 64);
  for (int r0 = 0; r0 < Sp; r0 += 64) {
    const int rows = min(64, Sp - r0);
    const bf16* rp = GA + r0 * GLD;
    for (int e = tid; e < 64 * 3; e += NT) spp[e] = 0.f;
    ring.consume(REFPTS0, 0, rp, GLD, rows, a.B,
                 [&](int r, int c, float x) { RH[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    clk(RP_HEAD_FWD);
    ring.consume(REFPTS1, 0, RH, LDH, rows, a.B, [&](int r, int c, float x) {
      HIN[r * kRayLd2 + c] = f2b(elu(x));
    });
    for (int e = tid; e < rows * (k2 - 128); e += NT) {
      const int r = e / (k2 - 128), col = 128 + e % (k2 - 128);
      HIN[r * kRayLd2 + col] =
          f2b(col < 155 && r0 + r < S ? a.dirpe[(size_t)ray * 27 + col - 128]
                                      : 0.f);
    }
    __syncthreads();
    clk(RP_HEAD_FWD);
    // sigma head: sigma - shift, -1e9 (no gradient) where no view is valid
    ring.consume(OG0, 0, HIN, kRayLd2, rows, a.B,
                 [&](int r, int c, float x) { H1[r * LDG + c] = f2b(elu(x)); });
    for (int e = tid; e < rows * LDS; e += NT) {
      const int r = e / LDS, c = e % LDS, i = r0 + r;
      const float d = c == 0 && i < S && snv[i] >= 1.f
                          ? a.cot[(p0 + i) * 4 + 3] : 0.f;
      if (d != 0.f) atomicAdd(slab + wt + net.l[OG1].b, d);
      D3[e] = f2b(d);
    }
    __syncthreads();
    clk(RP_HEAD_FWD);
    dw_accum(D3, LDS, H1, LDG, rows, slab, net.l[OG1]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(OG1, 1, D3, LDS, rows, nullptr, [&](int r, int c, float x) {
      H1[r * LDG + c] = f2b(x * elu_d(b2f(H1[r * LDG + c])));
    });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    grad_layer(H1, LDG, HIN, kRayLd2, rows, slab, wt, net.l[OG0]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(OG0, 1, H1, LDG, rows, nullptr,
                 [&](int r, int c, float x) { DF[r * 128 + c] = x; });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    // rgb head: sigmoid MLP on [gf2 | dir PE], 0 where no view is valid
    ring.consume(RGB0, 0, HIN, kRayLd2, rows, a.B,
                 [&](int r, int c, float x) { H1[r * LDG + c] = f2b(elu(x)); });
    __syncthreads();
    clk(RP_HEAD_FWD);
    ring.consume(RGB1, 0, H1, LDG, rows, a.B, [&](int r, int c, float x) {
      H2[r * LD64 + c] = f2b(elu(x));
    });
    __syncthreads();
    clk(RP_HEAD_FWD);
    ring.consume(RGB2, 0, H2, LD64, rows, a.B, [&](int r, int c, float x) {
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
    clk(RP_HEAD_FWD);
    dw_accum(D3, LDS, H2, LD64, rows, slab, net.l[RGB2]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(RGB2, 1, D3, LDS, rows, nullptr, [&](int r, int c, float x) {
      H2[r * LD64 + c] = f2b(x * elu_d(b2f(H2[r * LD64 + c])));
    });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    grad_layer(H2, LD64, H1, LDG, rows, slab, wt, net.l[RGB1]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(RGB1, 1, H2, LD64, rows, nullptr, [&](int r, int c, float x) {
      H1[r * LDG + c] = f2b(x * elu_d(b2f(H1[r * LDG + c])));
    });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    grad_layer(H1, LDG, HIN, kRayLd2, rows, slab, wt, net.l[RGB0]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(RGB0, 1, H1, LDG, rows, nullptr, [&](int r, int c, float x) {
      if (c < 128)
        DF[r * 128 + c] += x;
      else if (c < 155 && r0 + r < S)
        atomicAdd(&sdp[c - 128], x);
    });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    // ref_pts_fc (ELU output gf2, then its hidden layer)
    for (int e = tid; e < rows * 128; e += NT) {
      const int r = e >> 7, c = e & 127;
      HIN[r * kRayLd2 + c] = f2b(DF[e] * elu_d(b2f(HIN[r * kRayLd2 + c])));
    }
    __syncthreads();
    clk(RP_HEAD_ELEM);
    grad_layer(HIN, kRayLd2, RH, LDH, rows, slab, wt, net.l[REFPTS1]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(REFPTS1, 1, HIN, kRayLd2, rows, nullptr,
                 [&](int r, int c, float x) {
                   RH[r * LDH + c] = f2b(x * elu_d(b2f(RH[r * LDH + c])));
                 });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    grad_layer(RH, LDH, rp, GLD, rows, slab, wt, net.l[REFPTS0]);
    __syncthreads();
    clk(RP_HEAD_DW);
    ring.consume(REFPTS0, 1, RH, LDH, rows, nullptr,
                 [&](int r, int c, float x) {
                   const int i = r0 + r;
                   if (c < 128) {
                     DF[r * 128 + c] = x;
                   } else if (c < 161 && i < S) {
                     int chn;
                     const float d = pe_geo_bwd(a.pts + (p0 + i) * 3, 3, 5,
                                                c - 128, x, &chn);
                     atomicAdd(&spp[r * 3 + chn], d);
                   }
                 });
    __syncthreads();
    clk(RP_HEAD_TRANS);
    for (int e = tid; e < rows * 3; e += NT) {
      const int i = r0 + e / 3;
      if (i < S) a.d_pts[(p0 + i) * 3 + e % 3] = spp[e];
    }
    ln_bwd(r0, rows, DF);
    __syncthreads();
    clk(RP_HEAD_ELEM);
  }
  }

  // ---- C: attention backward ----
  load_gf();
  const WOp kC[7] = {{WQ, 0},  {WK, 0}, {WV, 0}, {WFC, 1},
                     {WQ, 1}, {WK, 1}, {WV, 1}};
  ring.begin(kC, 7, 1, Sp);
  qkv();
  __syncthreads();
  attn_fwd_mma(Q, K, Vv, O, snv, S, Sp, st_m, st_l);
  __syncthreads();
  clk(RP_C);
  dw_accum(DO3, LDG, O, LDG, Sp, slab, net.l[WFC]);
  __syncthreads();
  clk(RP_C_DW);
  ring.consume(WFC, 1, DO3, LDG, Sp, nullptr,
               [&](int r, int c, float x) { O[r * LDG + c] = f2b(x); });  // d_o
  __syncthreads();
  attn_bwd_mma(Q, K, Vv, O, DO3, snv, S, Sp, st_m, st_l, st_d);
  load_gf();                                       // gf1, the q/k/v input
  __syncthreads();
  clk(RP_C);
  dw_accum(DO3, LDG, O, LDG, Sp, slab, net.l[WQ]);
  dw_accum(K, 128, O, LDG, Sp, slab, net.l[WK]);
  dw_accum(Vv, 128, O, LDG, Sp, slab, net.l[WV]);
#ifdef AGG_PHASE_CLOCKS
  __syncthreads();
  clk(RP_C_DW);
#endif
  // the three transposed products add into d_gf1 by reductions: no
  // barrier between them
  ring.consume(WQ, 1, DO3, LDG, Sp, nullptr,
               [&](int r, int c, float x) { atomicAdd(&SD[r * 128 + c], x); });
  ring.consume(WK, 1, K, 128, Sp, nullptr,
               [&](int r, int c, float x) { atomicAdd(&SD[r * 128 + c], x); });
  ring.consume(WV, 1, Vv, 128, Sp, nullptr,
               [&](int r, int c, float x) { atomicAdd(&SD[r * 128 + c], x); });
  __syncthreads();
  clk(RP_C);

  // ---- D: geometry_fc and pooling-2 backward ----
  bf16* G = (bf16*)smem;                       // [SMAX][kRayLdg] pooling-2
  bf16* H = (bf16*)reg2;                       // [SMAX][LDH]
  bf16* DG = H + SMAX * LDH;                   // [SMAX][LDG]
  for (int e = tid; e < Sp * 128; e += NT) {
    const int i = e >> 7, c = e & 127;
    DG[i * LDG + c] =
        f2b(i < S ? SD[e] * elu_d(a.gf[ws.pt(p0 + i) * 128 + c]) : 0.f);
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
              a.ws_x + vp(v, p) * 128 + c0);
          const bf16* xb = reinterpret_cast<const bf16*>(&raw);
          const float w = a.ws_vis[vp(v, p)] * sinv[i];
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
      G[i * kRayLdg + c0 + j] = f2b(mean[j]);
      G[i * kRayLdg + 128 + c0 + j] = f2b(var[j]);
    }
  }
  const int kg = net.l[GEO0].k;
  for (int e = tid; e < Sp * (kg - 256); e += NT) {
    const int i = e / (kg - 256), j = e % (kg - 256);
    float val = 0.f;
    if (j == 0 && i < S) {
      for (int v = 0; v < V; ++v) val += a.ws_vis[vp(v, p0 + i)] * sinv[i];
      val /= (float)V;
    }
    G[i * kRayLdg + 256 + j] = f2b(val);
  }
  const WOp kD[3] = {{GEO0, 0}, {GEO1, 1}, {GEO0, 1}};
  ring.begin(kD, 3, 1, Sp);
  clk(RP_D);
  ring.consume(GEO0, 0, G, kRayLdg, Sp, a.B,
               [&](int r, int c, float x) { H[r * LDH + c] = f2b(elu(x)); });
  __syncthreads();
  clk(RP_D);
  grad_layer(DG, LDG, H, LDH, Sp, slab, wt, net.l[GEO1]);
  __syncthreads();
  clk(RP_D_DW);
  ring.consume(GEO1, 1, DG, LDG, Sp, nullptr, [&](int r, int c, float x) {
    H[r * LDH + c] = f2b(x * elu_d(b2f(H[r * LDH + c])));
  });
  __syncthreads();
  clk(RP_D);
  grad_layer(H, LDH, G, kRayLdg, Sp, slab, wt, net.l[GEO0]);
  __syncthreads();
  clk(RP_D_DW);
  ring.consume(GEO0, 1, H, LDH, Sp, nullptr, [&](int r, int c, float x) {
    if (c < 257) SG[r * 272 + c] = x;
  });
  __syncthreads();
  // pooling-2 backward, one warp per sample, 4 channels per lane
  for (int i = warp; i < S; i += NW) {
    const size_t p = p0 + i;
    const float inv = sinv[i];
    const int c0 = lane * 4;
    auto load4 = [&](int v, float (&x)[4]) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(a.ws_x + vp(v, p) * 128 + c0);
      const bf16* xb = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = b2f(xb[j]);
    };
    float mean[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
    float x[4], dme[4], dvr[4];
    for (int v = 0; v < V; ++v) {
      load4(v, x);
      const float w = a.ws_vis[vp(v, p)] * inv;
#pragma unroll
      for (int j = 0; j < 4; ++j) mean[j] += w * x[j];
    }
    for (int v = 0; v < V; ++v) {
      load4(v, x);
      const float w = a.ws_vis[vp(v, p)] * inv;
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
        part += x[j] * dme[j] + (x[j] - mean[j]) * (x[j] - mean[j]) * dvr[j];
      const float d = warp_sum(part) + dws;
      if (lane == 0) dw2[v] = d;
      dvsum -= inv * inv * a.ws_vis[vp(v, p)] * d;
    }
    for (int v = 0; v < V; ++v) {
      load4(v, x);
      const size_t pv = vp(v, p);
      const float w = a.ws_vis[pv] * inv;
      bf16* dxo = a.dx + pv * 128 + c0;
      __align__(8) bf16 outv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        // static: onto the blend head's d_x from phase B
        outv[j] = f2b(w * (dme[j] + 2.f * (x[j] - mean[j]) * dvr[j]) +
                      (STATIC ? b2f(dxo[j]) : 0.f));
      *reinterpret_cast<uint2*>(dxo) = *reinterpret_cast<uint2*>(outv);
      if (lane == 0)
        a.dmisc[pv * 8] =
            (STATIC ? a.dmisc[pv * 8] : 0.f) + inv * dw2[v] + dvsum;
    }
  }
  for (int c = tid; c < 256; c += NT)
    atomicAdd(slab + wt + net.l[LN].b + c, lng[c]);
  if (!STATIC)
    for (int c = tid; c < 27; c += NT)
      a.d_dirpe[(size_t)ray * 27 + c] = sdp[c];
  __syncthreads();
  clk(RP_D);
}

// The kernel's body: its launch file defines the __global__ entry
// (static_agg_bwd.cu: static_ray_bwd_kernel, dynamic_agg_bwd.cu:
// dynamic_ray_bwd_kernel), so each library compiles only its own.
template <bool STATIC>
__device__ __forceinline__ void ray_bwd90_rays(const RayBwd90Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  WRing<kRayStages> ring;
  ring.init((RingSmem*)(smem + kRayStages * kSlabBytes), smem, a.Wt, &a.net,
            RP_RING_WAIT);
  __syncthreads();
  for (int ray = blockIdx.x; ray < a.R; ray += gridDim.x)
    ray_bwd90_ray<STATIC>(a, ray, ring, smem + kRayRing, WsMap{a.P, 0});
}

}  // namespace agg
