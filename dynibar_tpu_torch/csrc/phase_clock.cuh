// Per-phase clocks of a kernel, compiled in only with -DAGG_PHASE_CLOCKS
// (the separate library scripts/port_profile.py --phases builds; the
// production build has none of it).  Thread 0 of each block adds the
// clock64() cycles since its previous mark to the mark's phase: marks sit
// right after block barriers, so the time between two marks is the
// block's.  Summed over blocks and launches into g_phase_cycles, read and
// zeroed from the host through dyn_phase_clocks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace agg {

constexpr int kPhases = 32;

// The two kernels of one library count into separate ranges: the ray
// side's RayPhase, the trunk side's TrunkPhase (K5a / K5b in
// static_agg_bwd, K4a / K4b in dynamic_agg_bwd, which have no input MLP
// or anti-alias chain).
// K5b, the static trunk backward: masks, pooling-1 weights and the pooled
// columns; per view: forward recompute, transposed products, weight
// gradients (dW products and their flush), elementwise; pooling-1
// backward; the input MLP (products and elementwise, weight gradients);
// the anti-alias chain.
enum TrunkPhase { TP_POOL1 = 16, TP_FWD, TP_TRANS, TP_DW, TP_ELEM, TP_POOL1_BWD,
                  TP_INMLP, TP_INMLP_DW, TP_AA, TP_RING_WAIT = 31 };
// K5a, the static ray backward: A (recompute up to the layer norm); B, the
// heads per 64-row chunk (forward, transposed, weight gradients,
// elementwise); C (attention backward, and its weight gradients); D
// (geometry_fc and pooling-2 backward, and its weight gradients).  The
// *_RING_WAIT counters hold thread 0's waits on weight slabs, the two
// below each its time in the slabs' products and in their epilogues,
// inside the other phases' time.
enum RayPhase { RP_A, RP_HEAD_FWD, RP_HEAD_TRANS, RP_HEAD_DW, RP_HEAD_ELEM,
                RP_C, RP_C_DW, RP_D, RP_D_DW, RP_RING_WAIT = 15 };
// The forwards K2/K3 (static_agg, dynamic_agg; K4s's trunk phase runs the
// same trunk_block).  Trunk: the per-view input features (static: the
// encodings, masks and copies, then the input MLP ray_dir_fc's products);
// pooling-1; per view, the dense layers' products (with their epilogues)
// and the elementwise work between them (the rf_v columns, x * vis, the
// workspace stores); the visibility re-pooling and geometry_fc.  Ray:
// q/k/v; the attention; fc and the layer norm; the sigma head (dynamic:
// with ref_pts_fc); the heads' input rows, products, and (static) the
// softmax over views.
enum FwdTrunkPhase { FT_IN = 16, FT_IN_PROD, FT_POOL1, FT_PROD, FT_ELEM,
                     FT_POOL2 };
enum FwdRayPhase { FR_QKV, FR_ATTN, FR_FC_LN, FR_SIGMA, FR_HEAD_IN,
                   FR_HEAD_PROD, FR_HEAD_OUT };
// K5d (static_agg_bwd3), the static input-MLP backward: the input
// staging and encodings; the forward recompute (two products); the
// transposed products; the weight gradients (products and flush); the bias
// gradients; the output assembly (d_srcpl, d_raydiff, d_rgbfeat, d_pts,
// d_reffeat).  Counters that K5c's TrunkPhase leaves free.
enum InmlpPhase { IP_STAGE, IP_FWD, IP_TRANS, IP_DW, IP_DB, IP_OUT };
// K4s (dynamic_agg_bwd1): its three phases per ray and thread 0's waits at
// the barriers between them (counters the ray phase's RayPhase leaves
// free; the phases' own marks also count, into the ranges above).
enum SinglePhase { SP_TRUNK = 9, SP_RAY, SP_TRUNK_BWD, SP_HANDOFF };

#ifdef AGG_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[kPhases];

struct PhaseClock {
  long long t0;
  __device__ __forceinline__ PhaseClock() { t0 = clock64(); }
  __device__ __forceinline__ void operator()(int phase) {
    const long long t = clock64();
    if (threadIdx.x == 0)
      atomicAdd(&g_phase_cycles[phase], (unsigned long long)(t - t0));
    t0 = t;
  }
  // a mark where the kernel itself has no block barrier: this build adds one
  __device__ __forceinline__ void sync(int phase) {
    __syncthreads();
    (*this)(phase);
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void operator()(int) const {}
  __device__ __forceinline__ void sync(int) const {}
};
#endif

}  // namespace agg

#ifdef AGG_PHASE_CLOCKS
// Copy the kPhases sums to `out` (host), then zero them if `reset`.
extern "C" int dyn_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, agg::g_phase_cycles,
                                       sizeof(agg::g_phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[agg::kPhases] = {};
    e = cudaMemcpyToSymbol(agg::g_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#endif
