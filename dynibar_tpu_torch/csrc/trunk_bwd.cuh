// Trunk-side aggregator backward (K4b dynamic, K5c static; K4s's trunk
// phase): pooling-1 and the per-view base/vis/vis2 trunk, recomputed and
// transposed one view at a time over 64-point blocks, plus (static) the
// anti-alias weight chain.  K5c stops at the d_rf seam: it leaves d_rf_tot,
// the anti-alias d_dot and d_s for K5d (static_agg_bwd3.cu), which
// transposes the input MLP.  (K5b, the trunk with the input MLP, is
// trunk_bwd_sm90.cuh.)
//
// Math of dynibar_tpu/ops/pallas_agg_bwd.py:733 dynamic_bwd_trunk_kernel
// and :1328 static_bwd_trunk3_kernel; layout of the forward's trunk_block
// (agg_common.cuh).  A block recomputes the pooled [mean | var] columns
// once, then per view: the trunk forward from rf (static: the rf residual
// of K2r; dynamic: bf16(rgb_feat + dirfeat)), and its transpose from the
// ray side's d_x / d_vis.  Each layer's input cotangent overwrites its
// input activation in place (ELU' from the post-activation), so one view's
// activations and cotangents fit the block's shared memory together.  The
// per-view d_rf goes to a workspace; after the view loop, pooling-1's
// backward (d_mean_eff = d_mean - 2 d_var sum_v w_v (rf_v - mean)) adds
// its part.  Mask cotangents are never formed.
//
// What bounds it on the H100: operations (3x the trunk side's forward
// matmul flops).  The design, for a regime where a warp's k-step waits on
// its weight fragment from L2 (the forwards' finding):
//   * the recompute runs on the forward's product routine: dense_deep on
//     the fragment-major pack (pack_frag, eight k-steps of weights in
//     flight), the units chosen for the fewest rounds.  The one-column
//     outputs (vis_fc's visibility logit, vis_fc2) stay on the MMAs, and
//     the one-column cotangents are rounded to bf16 as before, so that
//     K5c keeps K5b's arithmetic (the static routes' card check holds
//     them to 1e-3 of each other); trunk_block's warp dot products would
//     round the logit otherwise;
//   * the transposed products are dense_deep on the fragment-major pack of
//     the transposes (pack_frag_t); a one-column layer's transpose is a
//     rank-1 product done in the epilogue or elementwise;
//   * weight gradients: 32 x 32 blocks of dW per warp (8 MMAs for 4
//     ldmatrix per k-step), flushed with 16-byte reductions; the two
//     one-column rows (vis_fc2, the visibility logit) add up in shared
//     memory over the views and flush once per 64-point block;
//   * 512 threads per block (NTH), twice the warps the one block per SM
//     that shared memory allows would otherwise hold, to hide the waits.
// In the phase-clock build thread 0 adds each phase's cycles up
// (TrunkPhase, phase_clock.cuh).
#pragma once

#include "agg_bwd_common.cuh"
#include "phase_clock.cuh"

namespace agg {

struct TrunkBwdArgs {
  const bf16* WF;        // fragment-major weights (ops/agg.py pack_frag)
  const bf16* WTF;       // fragment-major transposes (pack_frag_t)
  const float* B;
  Net net;
  const bf16* rgbfeat;   // [P, V, C]
  const float* mask;     // [P, V]
  int P, S, V, C;
  // static aggregator
  const float* raydiff;  // [P, V, 4]
  int anti_alias, mask_rgb;
  const bf16* ws_rf;     // [V, P, 2C] K2r residual
  // dynamic aggregator
  const float* dirfeat;  // [P, C]
  // from the ray-side backward
  const bf16* dx;        // [V, P, 128]
  const float* dmisc;    // [V, P, 8]: d_vis, static d_rgb (1:4), d_raydiff (4:8)
  // outputs
  float* drf;            // [V, P, CR] workspace; K5c: d_rf_tot
  float* d_dot;          // [V, P] K5c: anti-alias cotangent of ray_diff[3]
  float* d_rgbfeat;      // [P, V, C]
  float* d_dirfeat;      // [P, C]
  float* d_s;            // [P]
  float* slabs;          // [kSlabs, slab_len] weight gradients
  int slab_len, w_total;
};

constexpr int LDF = 144;            // f32 d_[mean | var] of pooling-1
constexpr int CRMAX = LDF / 2;
constexpr int LDK = 232;            // base_fc input, 3 CR <= 216 -> 224 cols
constexpr int kTrunkBwdThreads = 512;   // K4b, K5c (K4s runs 256)
constexpr int kOneColF32 = 520;     // the one-column rows' f32 block

// PT = 64 points: 208,928 + 1,024 V bytes (223,264 at V = 14).  One block
// per SM.
constexpr size_t trunk_bwd_smem(int V) {
  return (size_t)PT * (LDK + LDH + 6 * LDG) * 2 + (size_t)PT * LDF * 4 +
         4 * (size_t)V * PT * 4 + 8 * (size_t)PT * 4 + kOneColF32 * 4;
}
static_assert(trunk_bwd_smem(VMAX) <= 232448,
              "the trunk backward fits one block at VMAX views");

// STATIC: the static aggregator's trunk (rf residual, anti-alias chain).
// The backward of one 64-point block from point p0 by NTH threads;
// workspace rows by `ws`.
template <bool STATIC, int NTH>
__device__ __forceinline__ void trunk_bwd_block(const TrunkBwdArgs& a,
                                                int p0, const WsMap ws) {
  constexpr int LDX = LDK, NWB = NTH / 32;
  static_assert(NTH % 128 == 0, "column passes: NTH / 128 rows at a time");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xin = (bf16*)smem;                 // [PT][LDX] trunk input
  bf16* ah = xin + PT * LDX;               // [PT][LDH] base_fc hidden
  bf16* x0 = ah + PT * LDH;                // [PT][LDG] base_fc output
  bf16* ch = x0 + PT * LDG;                // vis_fc hidden
  bf16* xw = ch + PT * LDG;                // x0 * w
  bf16* xv = xw + PT * LDG;                // x * vis0
  bf16* eh = xv + PT * LDG;                // vis_fc2 hidden
  bf16* tb = eh + PT * LDG;                // vis_fc output t[:128], d_t
  float* dgf = (float*)(tb + PT * LDG);    // [PT][LDF]
  const Net& net = a.net;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = a.P, V = a.V, C = a.C, CR = STATIC ? 2 * a.C : a.C;
  float* sm_m = dgf + PT * LDF;            // [V][PT] effective masks
  float* sm_w = sm_m + V * PT;             // pooling-1 weights
  float* sm_dw = sm_w + V * PT;            // their cotangents (static AA)
  float* sm_ed = sm_dw + V * PT;           // AA scores exp(|s|(dot-1))
  float* r_vis0 = sm_ed + V * PT;          // [PT]
  float* r_sg0 = r_vis0 + PT;
  float* r_winv = r_sg0 + PT;
  float* r_t1 = r_winv + PT;               // vis logit's activation, bf16
  float* r_dl = r_t1 + PT;                 // its cotangent, bf16
  float* r_ds = r_dl + PT;                 // vis_fc2's pre-activation's, f32
  // the one-column rows: vis_fc2's dW and vis_fc's row 128 (the logit)
  // summed over the views, those rows of W, their two bias gradients
  float* g21 = r_vis0 + 8 * PT;
  float* g1r = g21 + 128;
  float* w21 = g1r + 128;
  float* w1r = w21 + 128;
  float* gb = w1r + 128;
  float* slab = a.slabs + (size_t)(blockIdx.x % kSlabs) * a.slab_len;
  const int wt = a.w_total;
  const float s_val = (STATIC && a.anti_alias) ? a.B[net.l[AA_S].b] : 0.f;
  const float s_abs = fabsf(s_val);
  Lin vis1 = net.l[VIS1];
  vis1.n = 128;                  // dW: row 128, the visibility logit, apart
  PhaseClock clk;

  auto rf_val = [&](int r, int v, int c) -> float {
    const int p = p0 + r;
    if (p >= P) return 0.f;
    if (STATIC) return b2f(a.ws_rf[ws.vp(v, p) * CR + c]);
    return b2f(f2b(b2f(a.rgbfeat[((size_t)p * V + v) * C + c]) +
                   a.dirfeat[(size_t)p * C + c]));
  };

  // ---- masks and pooling-1 weights (as the forward) ----
  for (int c = tid; c < 128; c += NTH) {
    g21[c] = g1r[c] = 0.f;
    w21[c] = b2f(a.WF[frag_index(net.l[VIS21], 0, c)]);
    w1r[c] = b2f(a.WF[frag_index(net.l[VIS1], 128, c)]);
  }
  if (tid < 2) gb[tid] = 0.f;
  for (int r = tid; r < PT; r += NTH) {
    const int p = p0 + r;
    float msum = 0.f;
    for (int v = 0; v < V; ++v) {
      float m = 0.f, ex = 0.f;
      if (p < P) {
        const size_t pv = (size_t)p * V + v;
        m = a.mask[pv];
        if (STATIC && a.mask_rgb) {
          const bf16* rgb = a.rgbfeat + pv * C;
          m = (b2f(rgb[0]) + b2f(rgb[1]) + b2f(rgb[2])) > 1e-3f ? m : 0.f;
        }
        if (STATIC) ex = expf(s_abs * (a.raydiff[4 * pv + 3] - 1.f));
      }
      sm_m[v * PT + r] = m;
      sm_ed[v * PT + r] = ex;
      sm_dw[v * PT + r] = 0.f;
      msum += m;
    }
    if (STATIC && a.anti_alias) {
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
  for (int e = tid; e < PT * LDF; e += NTH) dgf[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < PT * CR; e += NTH) {
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
  const int kb = net.l[BASE0].k;
  for (int v = 0; v < V; ++v) {
    const float* wv = sm_w + v * PT;
    const float* mk = sm_m + v * PT;
    for (int e = tid; e < PT * (kb - 2 * CR); e += NTH) {
      const int r = e / (kb - 2 * CR), c = e % (kb - 2 * CR);
      xin[r * LDX + 2 * CR + c] = f2b(c < CR ? rf_val(r, v, c) : 0.f);
    }
    __syncthreads();
    clk(v == 0 ? TP_POOL1 : TP_ELEM);
    dense_deep<NTH>(xin, LDX, PT, a.WF, a.B, net.l[BASE0],
                    [&](int r, int c, float x) { ah[r * LDH + c] = f2b(elu(x)); });
    __syncthreads();
    clk(TP_FWD);
    dense_deep<NTH>(ah, LDH, PT, a.WF, a.B, net.l[BASE1],
                    [&](int r, int c, float x) {
                      const float y = elu(x);
                      x0[r * LDG + c] = f2b(y);
                      xw[r * LDG + c] = f2b(y * wv[r]);
                    });
    __syncthreads();
    clk(TP_FWD);
    dense_deep<NTH>(xw, LDG, PT, a.WF, a.B, net.l[VIS0],
                    [&](int r, int c, float x) { ch[r * LDG + c] = f2b(elu(x)); });
    __syncthreads();
    clk(TP_FWD);
    dense_deep<NTH>(ch, LDG, PT, a.WF, a.B, net.l[VIS1],
                    [&](int r, int c, float x) {
                      const float t = elu(x);
                      if (c < 128) {
                        tb[r * LDG + c] = f2b(t);
                      } else if (c == 128) {
                        const float sg0 = sigm(t);
                        r_t1[r] = b2f(f2b(t));
                        r_sg0[r] = sg0;
                        r_vis0[r] = sg0 * mk[r];
                      }
                    });
    __syncthreads();
    clk(TP_FWD);
    for (int e = tid; e < PT * 128; e += NTH) {
      const int r = e >> 7, c = e & 127;
      const float x = b2f(f2b(b2f(x0[r * LDG + c]) + b2f(tb[r * LDG + c])));
      xv[r * LDG + c] = f2b(x * r_vis0[r]);
    }
    __syncthreads();
    clk(TP_ELEM);
    dense_deep<NTH>(xv, LDG, PT, a.WF, a.B, net.l[VIS20],
                    [&](int r, int c, float x) { eh[r * LDG + c] = f2b(elu(x)); });
    __syncthreads();
    // vis = sigmoid(vh) * m: the cotangent of vh, f32
    dense_deep<NTH>(eh, LDG, PT, a.WF, a.B, net.l[VIS21],
                    [&](int r, int c, float x) {
                      const int p = p0 + r;
                      if (c != 0) return;
                      const float sg = sigm(x);
                      r_ds[r] = p < P ? sg * (1.f - sg) * mk[r] *
                                            a.dmisc[ws.vp(v, p) * 8]
                                      : 0.f;
                    });
    __syncthreads();
    clk(TP_FWD);
    {  // vis_fc2's last layer: dW row 0 and bias (from the f32 values:
       // bf16 terms of mixed sign lose the sum) summed, d_eh in place
      const int c = tid & 127;
      float part = 0.f;
      for (int r = tid >> 7; r < PT; r += NTH / 128) {
        const float e = b2f(eh[r * LDG + c]), d = b2f(f2b(r_ds[r]));
        part += d * e;
        eh[r * LDG + c] = f2b(d * w21[c] * elu_d(e));
      }
      atomicAdd(&g21[c], part);
      if (warp == 0) {
        const float s = warp_sum(r_ds[lane] + r_ds[lane + 32]);
        if (lane == 0) gb[0] += s;
      }
    }
    __syncthreads();
    clk(TP_ELEM);
    grad_layer_wide<NTH>(eh, LDG, xv, LDG, PT, slab, wt, net.l[VIS20]);
    __syncthreads();
    clk(TP_DW);
    dense_deep<NTH>(eh, LDG, PT, a.WTF, a.B, tr(net.l[VIS20]),
                    [&](int r, int c, float x) { xv[r * LDG + c] = f2b(x); },
                    0, -1, false);
    __syncthreads();
    clk(TP_TRANS);
    // xv = x * vis0, x = x0 + t: d_x and d_t, one warp per point
    for (int r = warp; r < PT; r += NWB) {
      const int p = p0 + r;
      float dxx[4], tt[4], part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        tt[q] = b2f(tb[r * LDG + c]);
        const float x = b2f(f2b(b2f(x0[r * LDG + c]) + tt[q]));
        const float dv = b2f(xv[r * LDG + c]);
        const float din = p < P ? b2f(a.dx[ws.vp(v, p) * 128 + c]) : 0.f;
        dxx[q] = din + r_vis0[r] * dv;
        part += x * dv;
      }
      const float dvis0 = warp_sum(part);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tb[r * LDG + lane + 32 * q] = f2b(dxx[q] * elu_d(tt[q]));
      if (lane == 0) {
        const float sg0 = r_sg0[r];
        r_dl[r] = b2f(f2b(sg0 * (1.f - sg0) * mk[r] * dvis0 *
                          elu_d(r_t1[r])));
      }
    }
    __syncthreads();
    clk(TP_ELEM);
    grad_layer_wide<NTH>(tb, LDG, ch, LDG, PT, slab, wt, vis1);
    {  // the logit's row of vis_fc: dW and bias summed
      const int c = tid & 127;
      float part = 0.f;
      for (int r = tid >> 7; r < PT; r += NTH / 128)
        part += r_dl[r] * b2f(ch[r * LDG + c]);
      atomicAdd(&g1r[c], part);
      if (warp == 0) {
        const float s = warp_sum(r_dl[lane] + r_dl[lane + 32]);
        if (lane == 0) gb[1] += s;
      }
    }
    __syncthreads();
    clk(TP_DW);
    // d_ch: d_t through rows 0..127 on the MMAs, the logit's row rank-1
    dense_deep<NTH>(tb, LDG, PT, a.WTF, a.B, tr(net.l[VIS1]),
                    [&](int r, int c, float x) {
                      ch[r * LDG + c] = f2b((x + r_dl[r] * w1r[c]) *
                                            elu_d(b2f(ch[r * LDG + c])));
                    },
                    0, 128, false);
    __syncthreads();
    clk(TP_TRANS);
    grad_layer_wide<NTH>(ch, LDG, xw, LDG, PT, slab, wt, net.l[VIS0]);
    __syncthreads();
    clk(TP_DW);
    dense_deep<NTH>(ch, LDG, PT, a.WTF, a.B, tr(net.l[VIS0]),
                    [&](int r, int c, float x) { xw[r * LDG + c] = f2b(x); },
                    0, -1, false);
    __syncthreads();
    clk(TP_TRANS);
    // xw = x0 * w_v; d_x0 = d_x + w_v d_xw, through base_fc's last ELU
    for (int r = warp; r < PT; r += NWB) {
      const int p = p0 + r;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        const float din = p < P ? b2f(a.dx[ws.vp(v, p) * 128 + c]) : 0.f;
        const float dxx = din + r_vis0[r] * b2f(xv[r * LDG + c]);
        const float dxw = b2f(xw[r * LDG + c]);
        const float y0 = b2f(x0[r * LDG + c]);
        part += y0 * dxw;
        x0[r * LDG + c] = f2b((dxx + wv[r] * dxw) * elu_d(y0));
      }
      if (STATIC) {
        const float s = warp_sum(part);
        if (lane == 0) sm_dw[v * PT + r] += s;
      }
    }
    __syncthreads();
    clk(TP_ELEM);
    grad_layer_wide<NTH>(x0, LDG, ah, LDH, PT, slab, wt, net.l[BASE1]);
    __syncthreads();
    clk(TP_DW);
    dense_deep<NTH>(x0, LDG, PT, a.WTF, a.B, tr(net.l[BASE1]),
                    [&](int r, int c, float x) {
                      ah[r * LDH + c] = f2b(x * elu_d(b2f(ah[r * LDH + c])));
                    },
                    0, -1, false);
    __syncthreads();
    clk(TP_TRANS);
    grad_layer_wide<NTH>(ah, LDH, xin, LDX, PT, slab, wt, net.l[BASE0]);
    __syncthreads();
    clk(TP_DW);
    dense_deep<NTH>(ah, LDH, PT, a.WTF, a.B, tr(net.l[BASE0]),
                    [&](int r, int c, float x) {
                      const int p = p0 + r;
                      if (c < 2 * CR)
                        dgf[r * LDF + c] += x;
                      else if (c < 3 * CR && p < P)
                        a.drf[ws.vp(v, p) * CR + c - 2 * CR] = x;
                    },
                    0, -1, false);
    __syncthreads();
    clk(TP_TRANS);
  }
  for (int c = tid; c < 128; c += NTH) {
    atomicAdd(slab + net.l[VIS21].w + c, g21[c]);
    atomicAdd(slab + net.l[VIS1].w + 128 * net.l[VIS1].k + c, g1r[c]);
  }
  if (tid == 0) {
    atomicAdd(slab + wt + net.l[VIS21].b, gb[0]);
    atomicAdd(slab + wt + net.l[VIS1].b + 128, gb[1]);
  }

  // ---- pooling-1 backward ----
  for (int e = tid; e < PT * CR; e += NTH) {
    const int r = e / CR, c = e % CR, p = p0 + r;
    if (p >= P) continue;
    float mean = 0.f, s0 = 0.f, dsum = 0.f;
    for (int v = 0; v < V; ++v) mean += sm_w[v * PT + r] * rf_val(r, v, c);
    for (int v = 0; v < V; ++v)
      s0 += sm_w[v * PT + r] * (rf_val(r, v, c) - mean);
    const float dm = dgf[r * LDF + c], dvr = dgf[r * LDF + CR + c];
    const float dme = dm - 2.f * dvr * s0;
    for (int v = 0; v < V; ++v) {
      const float rf = rf_val(r, v, c), w = sm_w[v * PT + r];
      const size_t iv = ws.vp(v, p) * CR + c;
      const float dt = a.drf[iv] + w * (dme + 2.f * (rf - mean) * dvr);
      const size_t ig = ((size_t)p * V + v) * C + c;
      if (STATIC) {
        if (a.anti_alias)
          atomicAdd(&sm_dw[v * PT + r],
                    rf * dme + (rf - mean) * (rf - mean) * dvr);
        a.drf[iv] = dt;
      } else {
        a.d_rgbfeat[ig] = dt;
        dsum += dt;
      }
    }
    if (!STATIC) a.d_dirfeat[(size_t)p * C + c] = dsum;
  }
  __syncthreads();
  clk(TP_POOL1_BWD);
  if (!STATIC) return;

  // ---- anti-alias weight chain -> d_dot (ray_diff[..., 3]) and d_s ----
  for (int r = tid; r < PT; r += NTH) {
    const int p = p0 + r;
    if (p >= P) continue;
    if (!a.anti_alias) {
      a.d_s[p] = 0.f;
      for (int v = 0; v < V; ++v) a.d_dot[ws.vp(v, p)] = 0.f;
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
      const float ded =
          sm_dw[v * PT + r] + (ed == emin ? dem / cnt : 0.f);
      a.d_dot[ws.vp(v, p)] = ded * ed * s_abs;
      dsl += ded * ed * (a.raydiff[pv * 4 + 3] - 1.f);
    }
    a.d_s[p] = dsl * (s_val > 0.f ? 1.f : (s_val < 0.f ? -1.f : 0.f));
  }
  __syncthreads();
  clk(TP_AA);
}

// <false> is K4b, <true> K5c.
template <bool STATIC>
__global__ void __launch_bounds__(kTrunkBwdThreads, 1)
    trunk_bwd_kernel(TrunkBwdArgs a) {
  for (int blk = blockIdx.x; blk < (a.P + PT - 1) / PT; blk += gridDim.x)
    trunk_bwd_block<STATIC, kTrunkBwdThreads>(a, blk * PT, WsMap{a.P, 0});
}

}  // namespace agg
