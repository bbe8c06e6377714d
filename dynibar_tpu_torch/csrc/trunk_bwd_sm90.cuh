// K5b, the static trunk backward, for Hopper: pooling-1 and the per-view
// base/vis/vis2 trunk recomputed and transposed one view at a time over
// 64-point blocks, the anti-alias weight chain and the per-view input MLP
// ray_dir_fc.
//
// Math of dynibar_tpu/ops/pallas_agg_bwd.py:1109 static_bwd_trunk_kernel,
// as the trunk-side body K4b/K5c share (trunk_bwd.cuh): a block recomputes
// the pooled [mean | var] columns once, then per view the trunk forward
// from the rf residual of K2r and its transpose from K5a's d_x / d_vis;
// each layer's input cotangent overwrites its input activation in place
// (ELU' from the post-activation).  After the view loop, pooling-1's
// backward and the input MLP, recomputed and transposed per view.
//
// What bounds it on the H100: operations (3x the trunk side's forward
// matmul flops).  The design (sm90_common.cuh):
//   * every layer product (forward and transposed, 12 per view) runs on
//     wgmma m64nNk16 (N up to 64), A from the activation rows by ldmatrix,
//     B from a ring of five 8 KB weight slabs (64 x 64 blocks of W) in
//     shared memory that bulk copies fill from the tiled pack
//     (L2-resident) while earlier slabs are multiplied; no weight
//     fragment is fetched from global memory inside a product, and the
//     transposed products read the same tiles (no W^T pack);
//   * the ring runs ahead across layers and views: one segment is the
//     view's twelve products repeated over the views, another the input
//     MLP's four;
//   * the room: the pooled cotangent d_[mean | var] (64 x 144 f32) lives
//     in a per-block global workspace (L2; base_fc's transposed product
//     adds into it with reductions, which do not wait), and the
//     trunk input keeps base_fc's 224 columns (K5c's stride): 36,864 +
//     6,144 bytes towards the ring's 40,960.
// Weight gradients stay on mma.sync into the slabs (agg_bwd_common.cuh).
#pragma once

#include "agg_bwd_common.cuh"
#include "phase_clock.cuh"
#include "sm90_common.cuh"

namespace agg {

struct StaticTrunkBwdArgs {
  const bf16* Wt;        // tiled weights (sm90_common.cuh)
  const float* B;
  Net net;
  const bf16* rgbfeat;   // [P, V, C]
  const float* mask;     // [P, V]
  int P, S, V, C;
  const float* pts;      // [P, 3]
  const float* reffeat;  // [R, C]
  const float* raydiff;  // [P, V, 4]
  const float* srcpl;    // [P, V, 6]
  int anti_alias, mask_rgb;
  const bf16* ws_rf;     // [V, P, 2C] K2r residual
  const bf16* dx;        // [V, P, 128] from K5a
  const float* dmisc;    // [V, P, 8]: d_vis, d_rgb (1:4), d_raydiff (4:8)
  float* drf;            // [V, P, 2C] workspace
  float* ws_dgf;         // [gridDim.x, PT, kTrunkLdf] pooled cotangents
  float* d_rgbfeat;      // [P, V, C]
  float* d_raydiff;      // [P, V, 4]
  float* d_srcpl;        // [P, V, 6]
  float* d_pts;          // [P, 3]
  float* d_reffeat;      // [P, C]
  float* d_s;            // [P]
  float* slabs;          // [kSlabs, slab_len] weight gradients
  int slab_len, w_total;
};

constexpr int kTrunkLdx = 232;      // base_fc input, 3 CR <= 216 -> 224
constexpr int kTrunkLdt = 152;      // vis_fc output (129 -> 144 cols)
constexpr int kTrunkLdf = 144;      // d_[mean | var], f32, in the workspace
constexpr int kTrunkCrMax = kTrunkLdf / 2;
constexpr int kTrunkStages = 5;
constexpr size_t kTrunkRing =
    (size_t)kTrunkStages * kSlabBytes + kRingSmemBytes;

// PT = 64 points: 217,088 + 1,024 V bytes (228,352 at V = 11, 231,424 at
// 14), the ring's 41,984 included.  One block per SM.
constexpr size_t static_trunk_bwd_smem(int V) {
  return kTrunkRing +
         (size_t)PT * (kTrunkLdx + LDH + 5 * LDG + kTrunkLdt + LDS) * 2 +
         4 * (size_t)V * PT * 4 + 8 * (size_t)PT * 4;
}
static_assert(static_trunk_bwd_smem(VMAX) <= 232448,
              "K5b fits one block at VMAX views");
static_assert(PT * 72 * 4 <= 2 * PT * LDG * 2 && PT * 64 * 4 <= PT * LDG * 2,
              "input-MLP f32 buffers fit over xw + xv and eh");

__device__ __forceinline__ void static_trunk_bwd_block(
    const StaticTrunkBwdArgs& a, int p0,
    WRing<kTrunkStages>& ring, unsigned char* smem) {
  constexpr int LDX = kTrunkLdx, LDT = kTrunkLdt, LDF = kTrunkLdf;
  bf16* xin = (bf16*)smem;                 // [PT][LDX] trunk input
  bf16* ah = xin + PT * LDX;               // [PT][LDH] base_fc hidden
  bf16* x0 = ah + PT * LDH;                // [PT][LDG] base_fc output
  bf16* ch = x0 + PT * LDG;                // vis_fc hidden
  bf16* xw = ch + PT * LDG;                // x0 * w
  bf16* xv = xw + PT * LDG;                // x * vis0
  bf16* eh = xv + PT * LDG;                // vis_fc2 hidden
  bf16* tb = eh + PT * LDG;                // [PT][LDT] vis_fc output
  bf16* ds = tb + PT * LDT;                // [PT][LDS]
  const Net& net = a.net;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = a.P, V = a.V, C = a.C, CR = 2 * a.C;
  float* sm_m = (float*)(ds + PT * LDS);   // [V][PT] effective masks
  float* sm_w = sm_m + V * PT;             // pooling-1 weights
  float* sm_dw = sm_w + V * PT;            // their cotangents
  float* sm_ed = sm_dw + V * PT;           // AA scores exp(|s|(dot-1))
  float* r_vis0 = sm_ed + V * PT;          // [PT]
  float* r_sg0 = r_vis0 + PT;
  float* r_sg = r_sg0 + PT;
  float* r_winv = r_sg + PT;
  float* r_pts = r_winv + PT;              // [PT][3]
  float* dgf = a.ws_dgf + (size_t)blockIdx.x * PT * LDF;   // [PT][LDF]
  float* slab = a.slabs + (size_t)(blockIdx.x % kSlabs) * a.slab_len;
  const int wt = a.w_total;
  const float s_val = a.anti_alias ? a.B[net.l[AA_S].b] : 0.f;
  const float s_abs = fabsf(s_val);
  PhaseClock clk;

  auto rf_val = [&](int r, int v, int c) -> float {
    const int p = p0 + r;
    return p < P ? b2f(a.ws_rf[((size_t)v * P + p) * CR + c]) : 0.f;
  };

  // ---- masks and pooling-1 weights (as the forward) ----
  for (int r = tid; r < PT; r += NT) {
    const int p = p0 + r;
    float msum = 0.f;
    for (int v = 0; v < V; ++v) {
      float m = 0.f, ex = 0.f;
      if (p < P) {
        const size_t pv = (size_t)p * V + v;
        m = a.mask[pv];
        if (a.mask_rgb) {
          const bf16* rgb = a.rgbfeat + pv * C;
          m = (b2f(rgb[0]) + b2f(rgb[1]) + b2f(rgb[2])) > 1e-3f ? m : 0.f;
        }
        ex = expf(s_abs * (a.raydiff[4 * pv + 3] - 1.f));
      }
      sm_m[v * PT + r] = m;
      sm_ed[v * PT + r] = ex;
      sm_dw[v * PT + r] = 0.f;
      msum += m;
    }
    if (a.anti_alias) {
      float emin = sm_ed[r];
      for (int v = 1; v < V; ++v) emin = fminf(emin, sm_ed[v * PT + r]);
      float wsum = 0.f;
      for (int v = 0; v < V; ++v) {
        const float w = (sm_ed[v * PT + r] - emin) * sm_m[v * PT + r];
        sm_w[v * PT + r] = w;
        wsum += w;
      }
      const float inv = 1.f / (wsum + 1e-8f);
      r_winv[r] = inv;
      for (int v = 0; v < V; ++v) sm_w[v * PT + r] *= inv;
    } else {
      const float inv = 1.f / (msum + 1e-8f);
      for (int v = 0; v < V; ++v) sm_w[v * PT + r] = sm_m[v * PT + r] * inv;
    }
  }
  for (int e = tid; e < PT * LDF; e += NT) dgf[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < PT * CR; e += NT) {
    const int r = e / CR, c = e % CR;
    float mean = 0.f, var = 0.f;
    for (int v = 0; v < V; ++v) mean += sm_w[v * PT + r] * rf_val(r, v, c);
    for (int v = 0; v < V; ++v) {
      const float d = rf_val(r, v, c) - mean;
      var += sm_w[v * PT + r] * d * d;
    }
    xin[r * LDX + c] = f2b(mean);
    xin[r * LDX + CR + c] = f2b(var);
  }

  // ---- per view: trunk recompute, then its transpose ----
  const WOp kView[12] = {
      {BASE0, 0}, {BASE1, 0}, {VIS0, 0},  {VIS1, 0},  {VIS20, 0}, {VIS21, 0},
      {VIS21, 1}, {VIS20, 1}, {VIS1, 1},  {VIS0, 1},  {BASE1, 1}, {BASE0, 1}};
  ring.begin(kView, 12, V, PT);
  const int kb = net.l[BASE0].k;
  for (int v = 0; v < V; ++v) {
    const float* wv = sm_w + v * PT;
    const float* mk = sm_m + v * PT;
    for (int e = tid; e < PT * (kb - 2 * CR); e += NT) {
      const int r = e / (kb - 2 * CR), c = e % (kb - 2 * CR);
      xin[r * LDX + 2 * CR + c] = f2b(c < CR ? rf_val(r, v, c) : 0.f);
    }
    __syncthreads();
    clk(v == 0 ? TP_POOL1 : TP_ELEM);
    ring.consume(BASE0, 0, xin, LDX, PT, a.B,
                 [&](int r, int c, float x) { ah[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    clk(TP_FWD);
    ring.consume(BASE1, 0, ah, LDH, PT, a.B, [&](int r, int c, float x) {
      const float y = elu(x);
      x0[r * LDG + c] = f2b(y);
      xw[r * LDG + c] = f2b(y * wv[r]);
    });
    __syncthreads();
    clk(TP_FWD);
    ring.consume(VIS0, 0, xw, LDG, PT, a.B,
                 [&](int r, int c, float x) { ch[r * LDG + c] = f2b(elu(x)); });
    __syncthreads();
    clk(TP_FWD);
    ring.consume(VIS1, 0, ch, LDG, PT, a.B, [&](int r, int c, float x) {
      const float t = elu(x);
      tb[r * LDT + c] = f2b(t);
      if (c == 128) {
        const float sg0 = sigm(t);
        r_sg0[r] = sg0;
        r_vis0[r] = sg0 * mk[r];
      }
    });
    __syncthreads();
    clk(TP_FWD);
    for (int e = tid; e < PT * 128; e += NT) {
      const int r = e >> 7, c = e & 127;
      const float x = b2f(f2b(b2f(x0[r * LDG + c]) + b2f(tb[r * LDT + c])));
      xv[r * LDG + c] = f2b(x * r_vis0[r]);
    }
    __syncthreads();
    clk(TP_ELEM);
    ring.consume(VIS20, 0, xv, LDG, PT, a.B,
                 [&](int r, int c, float x) { eh[r * LDG + c] = f2b(elu(x)); });
    __syncthreads();
    clk(TP_FWD);
    ring.consume(VIS21, 0, eh, LDG, PT, a.B, [&](int r, int c, float x) {
      if (c == 0) r_sg[r] = sigm(x);
    });
    __syncthreads();
    clk(TP_FWD);

    // vis = sigmoid(vh) * m
    for (int e = tid; e < PT * LDS; e += NT) {
      const int r = e / LDS, c = e % LDS, p = p0 + r;
      float d = 0.f;
      if (c == 0 && p < P) {
        const float sg = r_sg[r];
        d = sg * (1.f - sg) * mk[r] * a.dmisc[((size_t)v * P + p) * 8];
        // one-column bias: summed from the f32 values (bf16 terms of
        // mixed sign lose the sum)
        atomicAdd(slab + wt + net.l[VIS21].b, d);
      }
      ds[e] = f2b(d);
    }
    __syncthreads();
    clk(TP_ELEM);
    dw_accum(ds, LDS, eh, LDG, PT, slab, net.l[VIS21]);
    __syncthreads();
    clk(TP_DW);
    ring.consume(VIS21, 1, ds, LDS, PT, nullptr, [&](int r, int c, float x) {
      eh[r * LDG + c] = f2b(x * elu_d(b2f(eh[r * LDG + c])));
    });
    __syncthreads();
    clk(TP_TRANS);
    grad_layer(eh, LDG, xv, LDG, PT, slab, wt, net.l[VIS20]);
    __syncthreads();
    clk(TP_DW);
    ring.consume(VIS20, 1, eh, LDG, PT, nullptr,
                 [&](int r, int c, float x) { xv[r * LDG + c] = f2b(x); });
    __syncthreads();
    clk(TP_TRANS);
    // xv = x * vis0, x = x0 + t[:128]: d_x and d_t, one warp per point
    for (int r = warp; r < PT; r += NW) {
      const int p = p0 + r;
      float dxx[4], tt[4], part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        tt[q] = b2f(tb[r * LDT + c]);
        const float x = b2f(f2b(b2f(x0[r * LDG + c]) + tt[q]));
        const float dv = b2f(xv[r * LDG + c]);
        const float din =
            p < P ? b2f(a.dx[((size_t)v * P + p) * 128 + c]) : 0.f;
        dxx[q] = din + r_vis0[r] * dv;
        part += x * dv;
      }
      const float dvis0 = warp_sum(part);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tb[r * LDT + lane + 32 * q] = f2b(dxx[q] * elu_d(tt[q]));
      if (lane < 16) {
        float val = 0.f;
        if (lane == 0) {
          const float sg0 = r_sg0[r];
          val = sg0 * (1.f - sg0) * mk[r] * dvis0 *
                elu_d(b2f(tb[r * LDT + 128]));
        }
        tb[r * LDT + 128 + lane] = f2b(val);
      }
    }
    __syncthreads();
    clk(TP_ELEM);
    grad_layer(tb, LDT, ch, LDG, PT, slab, wt, net.l[VIS1]);
    __syncthreads();
    clk(TP_DW);
    ring.consume(VIS1, 1, tb, LDT, PT, nullptr, [&](int r, int c, float x) {
      ch[r * LDG + c] = f2b(x * elu_d(b2f(ch[r * LDG + c])));
    });
    __syncthreads();
    clk(TP_TRANS);
    grad_layer(ch, LDG, xw, LDG, PT, slab, wt, net.l[VIS0]);
    __syncthreads();
    clk(TP_DW);
    ring.consume(VIS0, 1, ch, LDG, PT, nullptr,
                 [&](int r, int c, float x) { xw[r * LDG + c] = f2b(x); });
    __syncthreads();
    clk(TP_TRANS);
    // xw = x0 * w_v; d_x0 = d_x + w_v d_xw, through base_fc's last ELU
    for (int r = warp; r < PT; r += NW) {
      const int p = p0 + r;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        const float din =
            p < P ? b2f(a.dx[((size_t)v * P + p) * 128 + c]) : 0.f;
        const float dxx = din + r_vis0[r] * b2f(xv[r * LDG + c]);
        const float dxw = b2f(xw[r * LDG + c]);
        const float y0 = b2f(x0[r * LDG + c]);
        part += y0 * dxw;
        x0[r * LDG + c] = f2b((dxx + wv[r] * dxw) * elu_d(y0));
      }
      const float s = warp_sum(part);
      if (lane == 0) sm_dw[v * PT + r] += s;
    }
    __syncthreads();
    clk(TP_ELEM);
    grad_layer(x0, LDG, ah, LDH, PT, slab, wt, net.l[BASE1]);
    __syncthreads();
    clk(TP_DW);
    ring.consume(BASE1, 1, x0, LDG, PT, nullptr, [&](int r, int c, float x) {
      ah[r * LDH + c] = f2b(x * elu_d(b2f(ah[r * LDH + c])));
    });
    __syncthreads();
    clk(TP_TRANS);
    grad_layer(ah, LDH, xin, LDX, PT, slab, wt, net.l[BASE0]);
    __syncthreads();
    clk(TP_DW);
    ring.consume(BASE0, 1, ah, LDH, PT, nullptr, [&](int r, int c, float x) {
      const int p = p0 + r;
      if (c < 2 * CR)
        atomicAdd(&dgf[r * LDF + c], x);     // a reduction: no load to wait on
      else if (c < 3 * CR && p < P)
        a.drf[((size_t)v * P + p) * CR + c - 2 * CR] = x;
    });
    __syncthreads();
    clk(TP_TRANS);
  }

  // ---- pooling-1 backward ----
  // one warp per point, lanes over the channels: the anti-alias cotangent
  // of each view's weight is a warp sum, not 2C shared atomics on one word
  for (int r = warp; r < PT; r += NW) {
    const int p = p0 + r;
    if (p >= P) continue;
    for (int c0 = 0; c0 < CR; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < CR;
      float mean = 0.f, s0 = 0.f, dme = 0.f, dvr = 0.f;
      if (on) {
        for (int v = 0; v < V; ++v) mean += sm_w[v * PT + r] * rf_val(r, v, c);
        for (int v = 0; v < V; ++v)
          s0 += sm_w[v * PT + r] * (rf_val(r, v, c) - mean);
        dvr = dgf[r * LDF + CR + c];
        dme = dgf[r * LDF + c] - 2.f * dvr * s0;
      }
      for (int v = 0; v < V; ++v) {
        float term = 0.f;
        if (on) {
          const float rf = rf_val(r, v, c), w = sm_w[v * PT + r];
          const size_t iv = ((size_t)v * P + p) * CR + c;
          const float dt = a.drf[iv] + w * (dme + 2.f * (rf - mean) * dvr);
          term = rf * dme + (rf - mean) * (rf - mean) * dvr;
          if (c < C)
            a.d_rgbfeat[((size_t)p * V + v) * C + c] =
                dt + (c < 3 ? a.dmisc[((size_t)v * P + p) * 8 + 1 + c] : 0.f);
          else
            a.drf[iv] = dt;
        }
        if (a.anti_alias) {
          term = warp_sum(term);
          if (lane == 0) sm_dw[v * PT + r] += term;
        }
      }
    }
  }
  __syncthreads();
  clk(TP_POOL1_BWD);

  // ---- input MLP (ray_dir_fc) recompute + transpose ----
  {
    float* dh = (float*)xw;                 // [PT][72] f32 over xw, xv
    float* acc = (float*)eh;                // [PT][64]: d_reffeat | d_ptspe
    const int kin = net.l[RAYDIR0].k;
    for (int e = tid; e < PT * 64; e += NT) acc[e] = 0.f;
    for (int e = tid; e < PT * 3; e += NT) {
      const int r = e / 3, c = e % 3, p = p0 + r;
      const float x = p < P ? a.pts[3 * (size_t)p + c] : 0.f;
      r_pts[e] = x;
      pe5(xin + r * LDX, 3, c, x);
    }
    const WOp kInmlp[4] = {
        {RAYDIR0, 0}, {RAYDIR1, 0}, {RAYDIR1, 1}, {RAYDIR0, 1}};
    ring.begin(kInmlp, 4, V, PT);
    for (int v = 0; v < V; ++v) {
      for (int e = tid; e < PT * 6; e += NT) {
        const int r = e / 6, c = e % 6, p = p0 + r;
        pe5(xin + r * LDX + 33, 6, c,
            p < P ? a.srcpl[((size_t)p * V + v) * 6 + c] : 0.f);
      }
      for (int e = tid; e < PT * (kin - 99); e += NT) {
        const int r = e / (kin - 99), j = e % (kin - 99), p = p0 + r;
        xin[r * LDX + 99 + j] = f2b(
            j < 4 && p < P ? a.raydiff[((size_t)p * V + v) * 4 + j] : 0.f);
      }
      for (int e = tid; e < PT * 48; e += NT) {
        const int r = e / 48, c = e % 48, p = p0 + r;
        float dc = 0.f, dsf = 0.f;
        if (c < C && p < P) {
          dc = a.drf[((size_t)v * P + p) * CR + C + c];
          dsf = dc * a.reffeat[(size_t)(p / a.S) * C + c];
        }
        dh[r * 72 + c] = dc;
        x0[r * LDG + c] = f2b(dsf);
      }
      __syncthreads();
      clk(TP_INMLP);
      ring.consume(RAYDIR0, 0, xin, LDX, PT, a.B, [&](int r, int c, float x) {
        ah[r * LDH + c] = f2b(elu(x));
      });
      __syncthreads();
      clk(TP_INMLP);
      // sf = ray_dir_fc(.); rf[C:] = sf * reffeat: d_sf into x0 and the
      // cotangent d_rf[C:] into dh first, so the product's epilogue reads
      // shared memory only
      ring.consume(RAYDIR1, 0, ah, LDH, PT, a.B, [&](int r, int c, float x) {
        if (c < C) acc[r * 64 + c] += dh[r * 72 + c] * x;
      });
      __syncthreads();
      clk(TP_INMLP);
      grad_layer(x0, LDG, ah, LDH, PT, slab, wt, net.l[RAYDIR1]);
      __syncthreads();
      clk(TP_INMLP_DW);
      ring.consume(RAYDIR1, 1, x0, LDG, PT, nullptr,
                   [&](int r, int c, float x) {
                     ah[r * LDH + c] = f2b(x * elu_d(b2f(ah[r * LDH + c])));
                   });
      __syncthreads();
      clk(TP_INMLP);
      grad_layer(ah, LDH, xin, LDX, PT, slab, wt, net.l[RAYDIR0]);
      __syncthreads();
      clk(TP_INMLP_DW);
      ring.consume(RAYDIR0, 1, ah, LDH, PT, nullptr,
                   [&](int r, int c, float x) {
                     if (c < 33) {
                       int chn;
                       const float d =
                           pe_geo_bwd(r_pts + 3 * r, 3, 5, c, x, &chn);
                       atomicAdd(&acc[r * 64 + 48 + chn], d);
                     } else if (c < 103) {
                       dh[r * 72 + c - 33] = x;
                     }
                   });
      __syncthreads();
      clk(TP_INMLP);
      for (int e = tid; e < PT * 10; e += NT) {
        const int r = e / 10, j = e % 10, p = p0 + r;
        if (p >= P) continue;
        const size_t pv = (size_t)p * V + v;
        const float* d = dh + r * 72;
        if (j < 6) {           // source Plücker coordinate j, through its PE
          const float x = a.srcpl[pv * 6 + j];
          float g = d[j];
          for (int f = 0; f < 5; ++f) {
            const float fr = (float)(1 << f);
            float sn, cs;
            sincosf(fr * x, &sn, &cs);
            g += fr * (d[36 + 6 * f + j] * cs - d[6 + 6 * f + j] * sn);
          }
          a.d_srcpl[pv * 6 + j] = g;
        } else {
          const int k = j - 6;
          a.d_raydiff[pv * 4 + k] =
              d[66 + k] + a.dmisc[((size_t)v * P + p) * 8 + 4 + k];
        }
      }
      __syncthreads();
      clk(TP_INMLP);
    }
    for (int e = tid; e < PT * C; e += NT) {
      const int r = e / C, c = e % C, p = p0 + r;
      if (p < P) a.d_reffeat[(size_t)p * C + c] = acc[r * 64 + c];
    }
    for (int e = tid; e < PT * 3; e += NT) {
      const int r = e / 3, p = p0 + r;
      if (p < P) a.d_pts[3 * (size_t)p + e % 3] = acc[r * 64 + 48 + e % 3];
    }
  }

  // ---- anti-alias weight chain -> d_dot (ray_diff[..., 3]) and d_s ----
  for (int r = tid; r < PT; r += NT) {
    const int p = p0 + r;
    if (p >= P) continue;
    if (!a.anti_alias) {
      a.d_s[p] = 0.f;
      continue;
    }
    float sw = 0.f, emin = sm_ed[r];
    for (int v = 0; v < V; ++v) {
      sw += sm_w[v * PT + r] * sm_dw[v * PT + r];
      emin = fminf(emin, sm_ed[v * PT + r]);
    }
    // d_wp, computed once per view: where every valid view's weight is 0
    // (the only valid view is the argmin, wsum = 0, winv = 1e8) the two
    // paths into ed (direct and through the min) must cancel exactly
    const float winv = r_winv[r];
    float dem = 0.f, cnt = 0.f;
    for (int v = 0; v < V; ++v) {
      const float dwp = sm_m[v * PT + r] * winv * (sm_dw[v * PT + r] - sw);
      sm_dw[v * PT + r] = dwp;
      dem -= dwp;
      cnt += sm_ed[v * PT + r] == emin ? 1.f : 0.f;
    }
    float dsl = 0.f;
    for (int v = 0; v < V; ++v) {
      const size_t pv = (size_t)p * V + v;
      const float ed = sm_ed[v * PT + r];
      // the min over views splits its cotangent evenly among ties
      const float ded = sm_dw[v * PT + r] + (ed == emin ? dem / cnt : 0.f);
      a.d_raydiff[pv * 4 + 3] += ded * ed * s_abs;
      dsl += ded * ed * (a.raydiff[pv * 4 + 3] - 1.f);
    }
    a.d_s[p] = dsl * (s_val > 0.f ? 1.f : (s_val < 0.f ? -1.f : 0.f));
  }
  __syncthreads();
  clk(TP_AA);
}

__global__ void __launch_bounds__(NT, 1)
    static_trunk_bwd_kernel(StaticTrunkBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  WRing<kTrunkStages> ring;
  ring.init((RingSmem*)(smem + kTrunkStages * kSlabBytes), smem, a.Wt,
            &a.net, TP_RING_WAIT);
  __syncthreads();
  for (int blk = blockIdx.x; blk < (a.P + PT - 1) / PT; blk += gridDim.x)
    static_trunk_bwd_block(a, blk * PT, ring, smem + kTrunkRing);
}

}  // namespace agg
