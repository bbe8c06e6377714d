// K5c / K5d: the trunk and input-MLP halves of the three-kernel static
// backward (route "pallas_split3"; K5a, the ray side, is static_agg_bwd.cu's).
//
// K5c replaces dynibar_tpu/ops/pallas_agg_bwd.py:1328
// static_bwd_trunk3_kernel (launched by pallas_agg.py:671): the anti-alias
// pooling weights, pooling-1 and the base/vis/vis2 trunk, transposed, and
// nothing of the input MLP; 12 weight gradients, d_rf_tot [V, P, 2C] f32
// (the whole per-view input cotangent, both halves), d_dot [V, P] (the
// anti-alias chain's cotangent of ray_diff[..., 3]) and d_s per point.  It
// is trunk_bwd_kernel<true> (trunk_bwd.cuh).
//
// K5d replaces :1484 static_bwd_inmlp_kernel (pallas_agg.py:707): the
// per-view input MLP ray_dir_fc on [pts PE | src Plücker PE | ray_diff],
// recomputed from its inputs and transposed from d_rf_tot's second half
// (rf[C:] = ray_dir_fc(.) * reffeat); 4 weight gradients, d_rgb_feat (the
// first half of d_rf_tot plus K5a's blend d_rgb), d_ray_diff (the MLP's,
// K5a's and d_dot), d_src_pl, d_pts and d_reffeat.
//
// What bounds them on the H100: operations.  Per point and view the input
// MLP is 2·(112·256 + 256·48) flops forward, three times that here; the
// trunk's are about eight times more.
//
// Design: the split moves the input MLP out of the trunk kernel, whose
// shared memory sets the trunk's tile (one view's activations and
// cotangents in place over 64 points).  K5c needs base_fc's 224 input
// columns instead of the 280 of the input MLP's pooled + per-view input
// (223,264 bytes at V = 14 against 232,448): still one block of 64 points
// per SM, at 512 threads (trunk_bwd.cuh).  K5d's own footprint (91,904
// bytes) fits two blocks per SM.  Both are persistent grids over 64-point
// blocks with the views in a loop, weight gradients into the shared slabs
// (agg_bwd_common.cuh) that K5a started; the reduce runs after K5d.

#include "trunk_bwd.cuh"

using namespace agg;

namespace {

struct InmlpBwdArgs {
  const bf16* W;
  const bf16* WT;
  const float* B;
  const float* Z;
  Net net;
  const float* pts;      // [P, 3]
  const float* reffeat;  // [R, C]
  const float* raydiff;  // [P, V, 4]
  const float* srcpl;    // [P, V, 6]
  const float* drf;      // [V, P, 2C] d_rf_tot from K5c
  const float* dmisc;    // [V, P, 8] from K5a: d_rgb (1:4), d_raydiff (4:8)
  const float* d_dot;    // [V, P] from K5c
  int P, S, V, C;
  float* d_rgbfeat;      // [P, V, C]
  float* d_raydiff;      // [P, V, 4]
  float* d_srcpl;        // [P, V, 6]
  float* d_pts;          // [P, 3]
  float* d_reffeat;      // [P, C]
  float* slabs;
  int slab_len, w_total;
};

constexpr int LDI = 120;            // ray_dir_fc input, 103 -> 112 columns
constexpr int LDC = 56;             // its output cotangent, 3 + C -> 48 cols
constexpr int LDR = 64;             // f32 d_reffeat (C) | d_pts PE (48:51)
constexpr int CIMAX = 36;           // 3 + C, as K5b's CRMAX / 2
constexpr size_t kInmlpSmem = (size_t)PT * (LDI + LDH + LDC) * 2 +
                              (size_t)PT * (72 + LDR + 3) * 4;
static_assert(2 * (kInmlpSmem + 1024) <= 233472, "two K5d blocks per SM");

__global__ void __launch_bounds__(NT, 2) inmlp_bwd_kernel(InmlpBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xin = (bf16*)smem;                 // [PT][LDI] MLP input
  bf16* ah = xin + PT * LDI;               // [PT][LDH] hidden, then d_hidden
  bf16* dsf = ah + PT * LDH;               // [PT][LDC] d of the MLP output
  float* dh = (float*)(dsf + PT * LDC);    // [PT][72] d of the PE columns
  float* acc = dh + PT * 72;               // [PT][LDR]
  float* r_pts = acc + PT * LDR;           // [PT][3]

  const Net& net = a.net;
  const int tid = threadIdx.x;
  const int P = a.P, V = a.V, C = a.C, CR = 2 * a.C;
  float* slab = a.slabs + (size_t)(blockIdx.x % kSlabs) * a.slab_len;
  const int wt = a.w_total, kin = net.l[RAYDIR0].k;
  const int nblk = (P + PT - 1) / PT;

  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    const int p0 = blk * PT;
    for (int e = tid; e < PT * LDR; e += NT) acc[e] = 0.f;
    // the point encoding is the same for every view
    for (int e = tid; e < PT * 3; e += NT) {
      const int r = e / 3, c = e % 3, p = p0 + r;
      const float x = p < P ? a.pts[3 * (size_t)p + c] : 0.f;
      r_pts[e] = x;
      pe5(xin + r * LDI, 3, c, x);
    }
    for (int v = 0; v < V; ++v) {
      for (int e = tid; e < PT * 6; e += NT) {
        const int r = e / 6, c = e % 6, p = p0 + r;
        pe5(xin + r * LDI + 33, 6, c,
            p < P ? a.srcpl[((size_t)p * V + v) * 6 + c] : 0.f);
      }
      for (int e = tid; e < PT * (kin - 99); e += NT) {
        const int r = e / (kin - 99), j = e % (kin - 99), p = p0 + r;
        xin[r * LDI + 99 + j] = f2b(
            j < 4 && p < P ? a.raydiff[((size_t)p * V + v) * 4 + j] : 0.f);
      }
      __syncthreads();
      dense(xin, LDI, PT, a.W, a.B, net.l[RAYDIR0],
            [&](int r, int c, float x) { ah[r * LDH + c] = f2b(elu(x)); });
      __syncthreads();
      // sf = ray_dir_fc(.); rf[C:] = sf * reffeat
      dense(ah, LDH, PT, a.W, a.B, net.l[RAYDIR1],
            [&](int r, int c, float x) {
              const int p = p0 + r;
              float d = 0.f;
              if (c < C && p < P) {
                const float dc = a.drf[((size_t)v * P + p) * CR + C + c];
                d = dc * a.reffeat[(size_t)(p / a.S) * C + c];
                acc[r * LDR + c] += dc * x;
              }
              dsf[r * LDC + c] = f2b(d);
            });
      __syncthreads();
      grad_layer(dsf, LDC, ah, LDH, PT, slab, wt, net.l[RAYDIR1]);
      __syncthreads();
      dense(dsf, LDC, PT, a.WT, a.Z, tr(net.l[RAYDIR1]),
            [&](int r, int c, float x) {
              ah[r * LDH + c] = f2b(x * elu_d(b2f(ah[r * LDH + c])));
            });
      __syncthreads();
      grad_layer(ah, LDH, xin, LDI, PT, slab, wt, net.l[RAYDIR0]);
      __syncthreads();
      dense(ah, LDH, PT, a.WT, a.Z, tr(net.l[RAYDIR0]),
            [&](int r, int c, float x) {
              if (c < 33) {
                int chn;
                const float d = pe_geo_bwd(r_pts + 3 * r, 3, 5, c, x, &chn);
                atomicAdd(&acc[r * LDR + 48 + chn], d);
              } else if (c < 103) {
                dh[r * 72 + c - 33] = x;
              }
            });
      __syncthreads();
      for (int e = tid; e < PT * 10; e += NT) {
        const int r = e / 10, j = e % 10, p = p0 + r;
        if (p >= P) continue;
        const size_t pv = (size_t)p * V + v, vp = (size_t)v * P + p;
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
          a.d_raydiff[pv * 4 + k] = d[66 + k] + a.dmisc[vp * 8 + 4 + k] +
                                    (k == 3 ? a.d_dot[vp] : 0.f);
        }
      }
      for (int e = tid; e < PT * C; e += NT) {
        const int r = e / C, c = e % C, p = p0 + r;
        if (p >= P) continue;
        const size_t vp = (size_t)v * P + p;
        a.d_rgbfeat[((size_t)p * V + v) * C + c] =
            a.drf[vp * CR + c] + (c < 3 ? a.dmisc[vp * 8 + 1 + c] : 0.f);
      }
      __syncthreads();
    }
    for (int e = tid; e < PT * C; e += NT) {
      const int r = e / C, c = e % C, p = p0 + r;
      if (p < P) a.d_reffeat[(size_t)p * C + c] = acc[r * LDR + c];
    }
    for (int e = tid; e < PT * 3; e += NT) {
      const int r = e / 3, p = p0 + r;
      if (p < P) a.d_pts[3 * (size_t)p + e % 3] = acc[r * LDR + 48 + e % 3];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dyn_static_agg_bwd_trunk3(
    const void* WF, const void* WTF, const void* B, const void* meta,
    const void* rgbfeat, const void* mask,
    const void* raydiff, const void* ws_rf, int anti_alias, int mask_rgb,
    const void* dx, const void* dmisc, void* drf, void* d_dot, void* d_s,
    void* slabs, int slab_len, int w_total, int R, int S, int V, int C,
    int nblocks, void* stream) {
  if (V > VMAX || S > SMAX || 2 * C > CRMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  TrunkBwdArgs a{};
  a.WF = (const bf16*)WF;
  a.WTF = (const bf16*)WTF;
  a.B = (const float*)B;
  a.net = load_net((const int*)meta);
  a.rgbfeat = (const bf16*)rgbfeat;
  a.mask = (const float*)mask;
  a.P = R * S;
  a.S = S;
  a.V = V;
  a.C = C;
  a.raydiff = (const float*)raydiff;
  a.anti_alias = anti_alias;
  a.mask_rgb = mask_rgb;
  a.ws_rf = (const bf16*)ws_rf;
  a.dx = (const bf16*)dx;
  a.dmisc = (const float*)dmisc;
  a.drf = (float*)drf;
  a.d_dot = (float*)d_dot;
  a.d_s = (float*)d_s;
  a.slabs = (float*)slabs;
  a.slab_len = slab_len;
  a.w_total = w_total;
  return launch_persistent(trunk_bwd_kernel<true>, trunk_bwd_smem(V), a,
                           (a.P + PT - 1) / PT, nblocks,
                           (cudaStream_t)stream, kTrunkBwdThreads);
}

extern "C" int dyn_static_agg_bwd_inmlp(
    const void* W, const void* WT, const void* B, const void* Z,
    const void* meta, const void* pts, const void* reffeat,
    const void* raydiff, const void* srcpl, const void* drf,
    const void* dmisc, const void* d_dot, void* d_rgbfeat, void* d_raydiff,
    void* d_srcpl, void* d_pts, void* d_reffeat, void* slabs, int slab_len,
    int w_total, int R, int S, int V, int C, int nblocks, void* stream) {
  if (V > VMAX || S > SMAX || C > CIMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  InmlpBwdArgs a{};
  a.W = (const bf16*)W;
  a.WT = (const bf16*)WT;
  a.B = (const float*)B;
  a.Z = (const float*)Z;
  a.net = load_net((const int*)meta);
  a.pts = (const float*)pts;
  a.reffeat = (const float*)reffeat;
  a.raydiff = (const float*)raydiff;
  a.srcpl = (const float*)srcpl;
  a.drf = (const float*)drf;
  a.dmisc = (const float*)dmisc;
  a.d_dot = (const float*)d_dot;
  a.P = R * S;
  a.S = S;
  a.V = V;
  a.C = C;
  a.d_rgbfeat = (float*)d_rgbfeat;
  a.d_raydiff = (float*)d_raydiff;
  a.d_srcpl = (float*)d_srcpl;
  a.d_pts = (float*)d_pts;
  a.d_reffeat = (float*)d_reffeat;
  a.slabs = (float*)slabs;
  a.slab_len = slab_len;
  a.w_total = w_total;
  return launch_persistent(inmlp_bwd_kernel, kInmlpSmem, a,
                           (a.P + PT - 1) / PT, nblocks,
                           (cudaStream_t)stream);
}

// The two kernels' footprints at V views and the blocks an SM holds:
// out = {K5c bytes, K5c blocks, K5d bytes, K5d blocks}.
extern "C" int dyn_occupancy(int V, int* out) {
  out[0] = (int)trunk_bwd_smem(V);
  out[1] = blocks_per_sm(trunk_bwd_kernel<true>, trunk_bwd_smem(V),
                         kTrunkBwdThreads);
  out[2] = (int)kInmlpSmem;
  out[3] = blocks_per_sm(inmlp_bwd_kernel, kInmlpSmem);
  return (int)cudaGetLastError();
}

extern "C" int dyn_agg_reduce(const void* slabs, int nslab, int len,
                              void* out, void* stream) {
  return launch_reduce((const float*)slabs, nslab, len, (float*)out,
                       (cudaStream_t)stream);
}
