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
// trunk's are about eight times more.  K5d also reads d_rf_tot (0.77 GB at
// the mono step's V = 14, P = 196,608): at the memory's rate, a third of
// its products' time at the tensor cores'.
//
// Design: the split moves the input MLP out of the trunk kernel, whose
// shared memory sets the trunk's tile (one view's activations and
// cotangents in place over 64 points).  K5c needs base_fc's 224 input
// columns instead of the 280 of the input MLP's pooled + per-view input
// (223,264 bytes at V = 14 against 232,448): still one block of 64 points
// per SM, at 512 threads (trunk_bwd.cuh).  Both are persistent grids over
// 64-point blocks with the views in a loop, weight gradients into the
// shared slabs (agg_bwd_common.cuh) that K5a started; the reduce runs
// after K5d.  K5d, two blocks of 256 threads per SM (phase clocks: PERF.md
// section 5):
//   * its four products run on dense_deep over the fragment-major pack
//     (pack_frag) and its transposes (pack_frag_t), eight k-steps of
//     weights in flight, as K2/K3, K4b and K5c;
//   * a view's inputs (its d_rf_tot rows, d_misc rows, src_pl, ray_diff,
//     d_dot) come into shared memory by cp.async, coalesced 16-byte copies
//     where the rows allow; the epilogues and the output assembly read
//     them there;
//   * the transposed first layer's epilogue only stores: the point
//     encoding's cotangents go through the encoding afterwards, one thread
//     per point and channel (in the epilogue the warps owning those
//     columns computed every sin and cos alone, while the others waited);
//   * weight gradients flush per view with 16-byte reductions
//     (dw_blocks); the first layer's bias comes out of its dW products as
//     the column of a ones input column (its weight column is padding),
//     the second layer's is a column sum over the threads.  The products
//     are the parent's, bf16 operands and f32 sums: only the order of the
//     f32 sums changes.
// A second stage of inputs, one block of 512 threads and weight
// gradients kept in shared memory over the views lost to this shape
// (PERF.md section 6).  In the phase-clock build thread 0 adds each
// phase's cycles up (InmlpPhase, phase_clock.cuh).

#include "trunk_bwd.cuh"

using namespace agg;

namespace {

struct InmlpBwdArgs {
  const bf16* WF;        // fragment-major weights (ops/agg.py pack_frag)
  const bf16* WTF;       // fragment-major transposes (pack_frag_t)
  const float* B;
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

constexpr int kInmlpThreads = 256;
constexpr int LDI = 120;            // ray_dir_fc input, 103 -> 112 columns
constexpr int LDC = 56;             // its output cotangent, 3 + C -> 48 cols
constexpr int LDR = 64;             // f32 d_reffeat (C) | d_pts (48:51)
constexpr int CIMAX = 36;           // 3 + C, as K5b's CRMAX / 2
constexpr int kHid = 256;           // ray_dir_fc's hidden width
// one view's staged inputs, f32 offsets
constexpr int kStDrf = 0;                   // [PT][2C] d_rf_tot, 2C <= 72
constexpr int kStMisc = kStDrf + PT * 72;   // [PT][8] d_misc
constexpr int kStSrc = kStMisc + PT * 8;    // [PT][6] src_pl
constexpr int kStRay = kStSrc + PT * 6;     // [PT][4] ray_diff
constexpr int kStDot = kStRay + PT * 4;     // [PT] d_dot
constexpr int kStage = kStDot + PT;
constexpr size_t kInmlpSmem =
    (size_t)PT * (LDI + LDH + LDC) * 2 +
    4 * ((size_t)PT * (72 + LDR + 3) + kStage);
static_assert(2 * (kInmlpSmem + 1024) <= 233472, "two K5d blocks per SM");
static_assert(68 + 33 * 4 <= LDI * 2, "dpe fits a row of xin");

// cp.async of 4, 8 or 16 bytes (16: L2 only, not kept in the L1)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// gb[c] += sum_r dY[r][c] for c < ncols (global reductions): NTH / ncols
// threads per column, each over every (NTH / ncols)-th row.
template <int NTH>
__device__ __forceinline__ void db_sum(const bf16* dY, int ldy, int rows,
                                       float* gb, int ncols) {
  const int split = NTH / ncols, c = threadIdx.x % ncols,
            part = threadIdx.x / ncols;
  if (part >= split) return;
  float s = 0.f;
  for (int r = part; r < rows; r += split) s += b2f(dY[r * ldy + c]);
  atomicAdd(gb + c, s);
}

__global__ void __launch_bounds__(kInmlpThreads, 2)
    inmlp_bwd_kernel(InmlpBwdArgs a) {
  constexpr int NTH = kInmlpThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xin = (bf16*)smem;                 // [PT][LDI] MLP input
  bf16* ah = xin + PT * LDI;               // [PT][LDH] hidden, then d_hidden
  bf16* dsf = ah + PT * LDH;               // [PT][LDC] d of the MLP output
  float* dh = (float*)(dsf + PT * LDC);    // [PT][72] d of the PE columns
  float* acc = dh + PT * 72;               // [PT][LDR]
  float* r_pts = acc + PT * LDR;           // [PT][3]
  float* st = r_pts + PT * 3;              // [kStage] one view's inputs

  const Net& net = a.net;
  const Lin L0 = net.l[RAYDIR0], L1 = net.l[RAYDIR1];
  const int tid = threadIdx.x;
  const int P = a.P, V = a.V, C = a.C, CR = 2 * a.C;
  float* slab = a.slabs + (size_t)(blockIdx.x % kSlabs) * a.slab_len;
  const int kin = L0.k;
  const int nblk = (P + PT - 1) / PT;
  // the point encoding's 33 f32 cotangents of row r, over xin's bf16
  // columns 34..99 (the per-view input columns)
  auto dpe = [&](int r) {
    return reinterpret_cast<float*>(reinterpret_cast<char*>(xin) +
                                    r * LDI * 2 + 68);
  };
  // every view's d_rf_tot rows start 16-byte aligned
  const bool drf16 = ((size_t)P * CR) % 4 == 0;
  PhaseClock clk;

  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    const int p0 = blk * PT, np = min(PT, P - p0);
    for (int e = tid; e < PT * LDR; e += NTH) acc[e] = 0.f;
    // the point encoding is the same for every view
    for (int e = tid; e < PT * 3; e += NTH) {
      const int r = e / 3, c = e - 3 * r, p = p0 + r;
      const float x = p < P ? a.pts[3 * (size_t)p + c] : 0.f;
      r_pts[e] = x;
      pe5(xin + r * LDI, 3, c, x);
    }
    for (int v = 0; v < V; ++v) {
      {  // this view's inputs, one commit group
        const size_t vp0 = (size_t)v * P + p0;
        const float* drf = a.drf + vp0 * CR;
        const int n = np * CR, n4 = drf16 ? n >> 2 : 0;
        for (int e = tid; e < n4; e += NTH)
          cp_async<16>(st + kStDrf + 4 * e, drf + 4 * e);
        for (int e = 4 * n4 + tid; e < n; e += NTH)
          cp_async<4>(st + kStDrf + e, drf + e);
        for (int e = tid; e < 2 * np; e += NTH)
          cp_async<16>(st + kStMisc + 4 * e, a.dmisc + vp0 * 8 + 4 * e);
        for (int e = tid; e < 3 * np; e += NTH) {
          const int r = e / 3, q = e - 3 * r;
          cp_async<8>(st + kStSrc + 6 * r + 2 * q,
                      a.srcpl + ((size_t)(p0 + r) * V + v) * 6 + 2 * q);
        }
        for (int r = tid; r < np; r += NTH) {
          cp_async<16>(st + kStRay + 4 * r,
                       a.raydiff + ((size_t)(p0 + r) * V + v) * 4);
          cp_async<4>(st + kStDot + r, a.d_dot + vp0 + r);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      for (int e = tid; e < PT * 6; e += NTH) {
        const int r = e / 6, c = e - 6 * r;
        pe5(xin + r * LDI + 33, 6, c, p0 + r < P ? st[kStSrc + e] : 0.f);
      }
      // ray_diff, then zeros, then (last padding column, whose weights are
      // zero) ones: the first layer's bias gradient as a dW column
      for (int e = tid; e < PT * (kin - 99); e += NTH) {
        const int r = e / (kin - 99), j = e - (kin - 99) * r;
        const bool in = p0 + r < P;
        xin[r * LDI + 99 + j] =
            f2b(j < 4 && in ? st[kStRay + 4 * r + j]
                            : (j == kin - 100 && in ? 1.f : 0.f));
      }
      __syncthreads();
      clk(IP_STAGE);
      dense_deep<NTH>(xin, LDI, PT, a.WF, a.B, L0,
                      [&](int r, int c, float x) {
                        ah[r * LDH + c] = f2b(elu(x));
                      });
      __syncthreads();
      // sf = ray_dir_fc(.); rf[C:] = sf * reffeat
      dense_deep<NTH>(ah, LDH, PT, a.WF, a.B, L1,
                      [&](int r, int c, float x) {
                        const int p = p0 + r;
                        float d = 0.f;
                        if (c < C && p < P) {
                          const float dc = st[kStDrf + r * CR + C + c];
                          d = dc * __ldg(a.reffeat + (size_t)(p / a.S) * C +
                                         c);
                          acc[r * LDR + c] += dc * x;
                        }
                        dsf[r * LDC + c] = f2b(d);
                      });
      __syncthreads();
      clk(IP_FWD);
      dw_blocks<NTH>(dsf, LDC, ah, LDH, PT, L1,
                     [&](int row, int col, float4 g) {
                       atomicAdd(reinterpret_cast<float4*>(
                                     slab + L1.w + (size_t)row * L1.k + col),
                                 g);
                     });
      clk.sync(IP_DW);
      db_sum<NTH>(dsf, LDC, PT, slab + a.w_total + L1.b, L1.n);
      __syncthreads();
      clk(IP_DB);
      dense_deep<NTH>(dsf, LDC, PT, a.WTF, a.B, tr(L1),
                      [&](int r, int c, float x) {
                        ah[r * LDH + c] =
                            f2b(x * elu_d(b2f(ah[r * LDH + c])));
                      },
                      0, -1, false);
      __syncthreads();
      clk(IP_TRANS);
      // the first layer's dW; its last column (the ones) is the bias's
      {
        float* gw = slab + L0.w;
        float* gb = slab + a.w_total + L0.b;
        dw_blocks<NTH>(ah, LDH, xin, LDI, PT, L0,
                       [&](int row, int col, float4 g) {
                         atomicAdd(reinterpret_cast<float4*>(
                                       gw + (size_t)row * kin + col),
                                   g);
                         if (col + 4 == kin) atomicAdd(gb + row, g.w);
                       });
      }
      __syncthreads();
      clk(IP_DW);
      // its transpose: the point encoding's cotangents go to dpe (in xin's
      // per-view columns, free once dW is done) and through the encoding
      // below, spread over the threads
      dense_deep<NTH>(ah, LDH, PT, a.WTF, a.B, tr(L0),
                      [&](int r, int c, float x) {
                        if (c < 33)
                          dpe(r)[c] = x;
                        else if (c < 103)
                          dh[r * 72 + c - 33] = x;
                      },
                      0, -1, false);
      __syncthreads();
      clk(IP_TRANS);
      // d_pts through its encoding
      for (int e = tid; e < PT * 3; e += NTH) {
        const int r = e / 3, ch = e - 3 * r;
        const float* d = dpe(r);
        float g = d[ch];
        for (int f = 0; f < 5; ++f) {
          const float fr = (float)(1 << f);
          float sn, cs;
          sincosf(fr * r_pts[e], &sn, &cs);
          g += fr * (d[18 + 3 * f + ch] * cs - d[3 + 3 * f + ch] * sn);
        }
        acc[r * LDR + 48 + ch] += g;
      }
      // d_src_pl through its encoding, d_ray_diff as one 16-byte row
      for (int e = tid; e < PT * 8; e += NTH) {
        const int r = e >> 3, j = e & 7, p = p0 + r;
        if (p >= P || j == 7) continue;
        const size_t pv = (size_t)p * V + v;
        const float* d = dh + r * 72;
        if (j < 6) {
          const float x = st[kStSrc + 6 * r + j];
          float g = d[j];
          for (int f = 0; f < 5; ++f) {
            const float fr = (float)(1 << f);
            float sn, cs;
            sincosf(fr * x, &sn, &cs);
            g += fr * (d[36 + 6 * f + j] * cs - d[6 + 6 * f + j] * sn);
          }
          a.d_srcpl[pv * 6 + j] = g;
        } else {
          const float* m = st + kStMisc + 8 * r;
          *reinterpret_cast<float4*>(a.d_raydiff + pv * 4) =
              make_float4(d[66] + m[4], d[67] + m[5], d[68] + m[6],
                          d[69] + m[7] + st[kStDot + r]);
        }
      }
      for (int e = tid; e < PT * 64; e += NTH) {
        const int r = e >> 6, c = e & 63, p = p0 + r;
        if (c >= C || p >= P) continue;
        a.d_rgbfeat[((size_t)p * V + v) * C + c] =
            st[kStDrf + r * CR + c] +
            (c < 3 ? st[kStMisc + 8 * r + 1 + c] : 0.f);
      }
      __syncthreads();
      clk(IP_OUT);
    }
    for (int e = tid; e < PT * 64; e += NTH) {
      const int r = e >> 6, c = e & 63, p = p0 + r;
      if (p >= P) continue;
      if (c < C) a.d_reffeat[(size_t)p * C + c] = acc[r * LDR + c];
      else if (c >= 48 && c < 51)
        a.d_pts[3 * (size_t)p + c - 48] = acc[r * LDR + c];
    }
    __syncthreads();
    clk(IP_OUT);
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
    const void* WF, const void* WTF, const void* B, const void* meta,
    const void* pts, const void* reffeat, const void* raydiff,
    const void* srcpl, const void* drf, const void* dmisc, const void* d_dot,
    void* d_rgbfeat, void* d_raydiff, void* d_srcpl, void* d_pts,
    void* d_reffeat, void* slabs, int slab_len, int w_total, int R, int S,
    int V, int C, int nblocks, void* stream) {
  InmlpBwdArgs a{};
  a.net = load_net((const int*)meta);
  const Lin& L0 = a.net.l[RAYDIR0];
  const Lin& L1 = a.net.l[RAYDIR1];
  // the input's 103 columns padded to 112: the last is the bias's ones
  if (V > VMAX || S > SMAX || C > CIMAX || V < 1 || S < 1 || L0.n != kHid ||
      L0.k != 112 || L1.k != kHid || L1.n > 48)
    return (int)cudaErrorInvalidValue;
  a.WF = (const bf16*)WF;
  a.WTF = (const bf16*)WTF;
  a.B = (const float*)B;
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
                           (cudaStream_t)stream, kInmlpThreads);
}

// The two kernels' footprints at V views and the blocks an SM holds:
// out = {K5c bytes, K5c blocks, K5d bytes, K5d blocks}.
extern "C" int dyn_occupancy(int V, int* out) {
  out[0] = (int)trunk_bwd_smem(V);
  out[1] = blocks_per_sm(trunk_bwd_kernel<true>, trunk_bwd_smem(V),
                         kTrunkBwdThreads);
  out[2] = (int)kInmlpSmem;
  out[3] = blocks_per_sm(inmlp_bwd_kernel, kInmlpSmem, kInmlpThreads);
  return (int)cudaGetLastError();
}

extern "C" int dyn_agg_reduce(const void* slabs, int nslab, int len,
                              void* out, void* stream) {
  return launch_reduce((const float*)slabs, nslab, len, (float*)out,
                       (cudaStream_t)stream);
}
