// Hopper (sm_90a) building blocks of the redesigned static backward K5a /
// K5b, meant for the later redesigns of the other aggregator backwards:
// mbarriers, bulk asynchronous copies (cp.async.bulk, completed on an
// mbarrier), warpgroup matrix products (wgmma) with A from registers and B
// from shared memory, and a ring of weight slabs in shared memory that
// the bulk copies keep filled ahead of the products reading it.
//
// Tiled weights (ops/agg.py tile_weights): each layer's padded W [N, K]
// bf16 at its usual offset, cut into blocks of at most 64 x 64 stored one
// after the other (row blocks, then column blocks); inside a block, 8x8
// core matrices row-major over (n8, k8), each 8 rows of 8 consecutive k
// (128 bytes).  A slab is one block, one bulk copy into a stage, and one
// copy serves both products through wgmma's descriptor strides:
//   forward     Y = X W^T: B[k][n] = W[n][k], K-major: k8 stride 128 (the
//               leading byte offset), n8 stride 16 x (block k extent);
//   transposed  dX = dY W: B[n][k] = W[n][k], reduced over n, MN-major
//               (the transpose-B bit): n8 stride (leading) 16 x (block k
//               extent), k8 stride 128.
//
// Products: a warpgroup (4 warps, 128 threads) computes a 64-row tile
// times up to 64 output columns of a block, over the reduction's slabs in
// turn, with m64nNk16 steps (N = 16..64) into registers; each warp's A
// fragment (its 16 rows) comes from the activation rows in shared memory
// by ldmatrix, as mma.sync's, so the activation buffers keep their padded
// row layout.  64-row products hand the column blocks to the two
// warpgroups in turn; 128-row products give both warpgroups every slab,
// one row tile each.
//
// The ring: STAGES slab buffers of 8 KB; per stage a full mbarrier, an
// empty mbarrier and the index of the slab last issued into it.  The warps
// that multiply a slab (its owners: one warpgroup, or both over 128 rows)
// wait for its index, then on the full barrier's parity, and release it
// by arriving on the empty barrier; the stage's first owner warp waits on
// that barrier and issues the copy of the slab STAGES further on, so the
// owners find their next slabs in flight while they compute, and the
// other warpgroup does not wait for them.  The empty barrier's release /
// acquire order the owners' reads before the copy, so the ring issues no
// membar.cta.  A parity wait alone tells only
// two consecutive fills of a stage apart: the index wait makes it exact
// (a slab is issued only after every earlier fill of its stage was waited
// on and released).  A segment (an op list repeated `reps` times, e.g. one
// view's layer products over the views of a block) is announced by
// begin(), which issues the first STAGES slabs.  Every thread walks the
// same op list in the same order (consume() traps on a mismatch).  In the
// phase-clock build, thread 0's waits on slabs, products and epilogues add
// up in counters of their own.
#pragma once

#include "agg_common.cuh"
#include "phase_clock.cuh"

#if defined(__CUDA_ARCH__) && !defined(__CUDA_ARCH_FEAT_SM90_ALL)
#error "sm90_common.cuh needs sm_90a (wgmma): build for compute_90a/sm_90a"
#endif

namespace agg {

__device__ __forceinline__ uint32_t sm_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sm_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          sm_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival of `count` on the barrier (release semantics, CTA scope).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sm_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of the phase with this parity.  A wait that has
// not completed after 2^32 cycles of the SM's clock (about 2 s at 1.98 GHz;
// a slab's copy takes microseconds) traps, so a copy that was never issued
// fails the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = sm_u32(bar);
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// Order this thread's earlier shared-memory accesses (those of the generic
// proxy, and through the barriers before it the async proxy's reads of
// completed wgmma) before the async proxy's later writes of a bulk copy.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- bulk asynchronous copy, global -> shared, completing on `bar` ----
// dst, src 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm_u32(bar))
      : "memory");
}

// ---- wgmma ----
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets (PTX ISA, "Matrix Descriptor Format").
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32);
}

// d[64 x N] = A[64 x 16] B[16 x N] (+ d if acc): A in registers (this
// warp's 16 rows as mma.sync's A fragment), B by descriptor; TRANS_B 1
// reads B MN-major.  acc is wgmma's scale-d operand, so a product's first
// step needs no zeroing of d outside the wgmma.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, "
      "{%8,%9,%10,%11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc),
        "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc),
        "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n48(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23}, "
      "{%24,%25,%26,%27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc),
        "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc),
        "n"(TRANS_B)
      : "memory");
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_n(float* d, const uint32_t (&a)[4],
                                        uint64_t desc, int acc) {
  if constexpr (N == 64) wgmma_n64<TRANS_B>(d, a, desc, acc);
  else if constexpr (N == 48) wgmma_n48<TRANS_B>(d, a, desc, acc);
  else if constexpr (N == 32) wgmma_n32<TRANS_B>(d, a, desc, acc);
  else wgmma_n16<TRANS_B>(d, a, desc, acc);
}

// Keep registers that an in-flight wgmma reads or writes where they are:
// the compiler sees the asm statement as their last use, and could hand
// them to another value before the product has completed.
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}
template <int NR>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One warpgroup's 64 rows times one slab: nks <= 4 reduction steps of 16,
// A from ldmatrix at xa (+32 bytes a step), B at slab (+kstride a step).
// The slab's A fragments are loaded first, then its products issue back
// to back under one fence and one commit.  Accumulates into d (N / 2
// floats a thread), or overwrites it if `first`.
template <int N, int TRANS_B>
__device__ __forceinline__ void wg_block(float* d, uint32_t xa, uint32_t slab,
                                         int nks, uint32_t lbo, uint32_t sbo,
                                         uint32_t kstride, bool first) {
  uint32_t a[4][4];
  __syncwarp();                     // converged for the .aligned ops
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < nks) ldsm_x4(a[kk], xa + kk * 32);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < nks)
      wgmma_n<N, TRANS_B>(d, a[kk], wg_desc(slab + kk * kstride, lbo, sbo),
                          kk > 0 || !first);
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) reg_fence(a[kk]);
  reg_fence<N / 2>(d);
}

// ---- the weight ring ----
constexpr int kRingOps = 16;         // ops in one segment repetition

constexpr int kRingMaxStages = 8;
constexpr int kRingSlabs = 80;       // slabs in one segment repetition

struct RingSmem {
  uint64_t full[kRingMaxStages];
  uint64_t empty[kRingMaxStages];
  int issued[kRingMaxStages];
  int op_layer[kRingOps], op_trans[kRingOps];
  int slab_src[kRingSlabs], slab_bytes[kRingSlabs];   // the copies, by slab
};

constexpr int kRingSmemBytes = 1024;  // RingSmem, rounded to keep alignment
static_assert(sizeof(RingSmem) <= kRingSmemBytes, "ring bookkeeping");
constexpr int kSlabBytes = 64 * 64 * 2;   // one block of W

struct WOp {
  int layer, trans;
};

// A product's blocks: output columns in blocks of 64 (cb), the reduction
// in blocks of 64 (kb); one slab each.
struct OpGeom {
  int wo, wr, ncb, nkb;
  __device__ OpGeom(const Lin& L, int trans)
      : wo(trans ? L.k : L.n), wr(trans ? L.n : L.k),
        ncb((wo + 63) >> 6), nkb((wr + 63) >> 6) {}
  // Slab s of the op as (cb, kb).  64-row products hand the column
  // blocks to the two warpgroups in turn, so a pair's slabs interleave
  // (cb 2p, 2p+1 for each kb), an odd last block's follow in kb order;
  // 128-row products (both warpgroups on every slab) go cb-major.
  __device__ void block(int s, bool both, int* cb, int* kb) const {
    const int np = ncb >> 1;
    if (both) {
      *cb = s / nkb;
      *kb = s % nkb;
    } else if (s < np * 2 * nkb) {
      const int rem = s % (2 * nkb);
      *cb = 2 * (s / (2 * nkb)) + (rem & 1);
      *kb = rem >> 1;
    } else {
      *cb = ncb - 1;
      *kb = s - np * 2 * nkb;
    }
  }
};

template <int STAGES>
struct WRing {
  static_assert(STAGES <= kRingMaxStages, "ring shape");
  RingSmem* sm;
  unsigned char* buf;        // STAGES x kSlabBytes, 128-byte aligned
  const bf16* W;             // tiled weights (global)
  const Net* net;
  int next;                  // global index of the next slab consumed
  int base, total, per_rep, nops, op;   // the current segment
  bool both;                 // its products run over more than 64 rows
  int wait_phase;            // phase-clock counter of the slab waits

  __device__ static int slabs(const Lin& L, int trans) {
    const OpGeom g(L, trans);
    return g.ncb * g.nkb;
  }

  // Once per block, before any segment; the caller syncs after.
  __device__ void init(RingSmem* s, unsigned char* b, const bf16* w,
                       const Net* n, int wait_clock) {
    wait_phase = wait_clock;
    sm = s;
    buf = b;
    W = w;
    net = n;
    next = 0;
    if (threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i) {
        mbar_init(&sm->full[i], 1);
        mbar_init(&sm->empty[i], 8);   // eight warps' worth of releases
        sm->issued[i] = -1;
      }
      fence_mbar_init();
    }
  }

  // Slab g (global index) into its stage, one bulk copy: one thread.
  __device__ void issue(int g) {
    const int j = g - base;
    if (j >= total) return;
    const int k = j % per_rep;
    uint64_t* bar = &sm->full[g % STAGES];
    *(volatile int*)&sm->issued[g % STAGES] = g;
    mbar_expect_tx(bar, (uint32_t)sm->slab_bytes[k]);
    bulk_g2s(buf + (g % STAGES) * kSlabBytes, W + sm->slab_src[k],
             (uint32_t)sm->slab_bytes[k], bar);
  }

  // Announce a segment: `ops` repeated `reps` times, every product over
  // `rows` rows.  Every thread calls it after a block barrier that follows
  // the last product of the previous segment; it ends with a block
  // barrier.
  __device__ void begin(const WOp* ops, int n_ops, int reps, int rows) {
    per_rep = 0;
    for (int o = 0; o < n_ops; ++o)
      per_rep += slabs(net->l[ops[o].layer], ops[o].trans);
    base = next;
    total = per_rep * reps;
    nops = n_ops;
    op = 0;
    both = rows > 64;
    if (threadIdx.x == 0) {
      if (per_rep > kRingSlabs) __trap();
      // each slab's copy: W's block [n0, n0 + bn) x [k0, k0 + bk), stored
      // contiguously by ops/agg.py tile_weights
      int k = 0;
      for (int o = 0; o < n_ops; ++o) {
        const int trans = ops[o].trans;
        const Lin L = net->l[ops[o].layer];
        const OpGeom geo(L, trans);
        sm->op_layer[o] = ops[o].layer;
        sm->op_trans[o] = trans;
        for (int s = 0; s < geo.ncb * geo.nkb; ++s, ++k) {
          int cb, kb;
          geo.block(s, both, &cb, &kb);
          const int bw = min(64, geo.wo - 64 * cb);
          const int bk = min(64, geo.wr - 64 * kb);
          const int n0 = trans ? 64 * kb : 64 * cb, bn = trans ? bk : bw;
          const int k0 = trans ? 64 * cb : 64 * kb, bkk = trans ? bw : bk;
          sm->slab_src[k] = L.w + n0 * L.k + bn * k0;
          sm->slab_bytes[k] = 2 * bn * bkk;
        }
      }
      fence_proxy_async_smem();   // the last segment's reads, synced
      for (int i = 0; i < STAGES && i < total; ++i) issue(base + i);
    }
    __syncthreads();
  }

  // The next op of the segment over `rows` rows (a multiple of 16, <= 128;
  // the segment's) of X (row stride ldx): forward (bias B, or none) or
  // transposed.  ep(row, col, value) for every row < rows and every padded
  // output column.  Over 64 rows the warpgroups take the column blocks in
  // turn; over 128 rows both take every slab, one row tile each.  Ends
  // without a block barrier.
  template <typename EP>
  __device__ void consume(int layer, int trans, const bf16* X, int ldx,
                          int rows, const float* B, EP ep) {
    if (sm->op_layer[op] != layer || sm->op_trans[op] != trans ||
        both != (rows > 64))
      __trap();
    const Lin L = net->l[layer];
    const OpGeom geo(L, trans);
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    const int wq = (threadIdx.x >> 5) & 3;
    const int row0 = both ? 64 * wg : 0;
    const uint32_t xrow = sm_u32(X + (size_t)(row0 + wq * 16 + (lane & 15)) *
                                         ldx + (lane >> 4) * 8);
    // A warpgroup waits on and releases only the slabs it multiplies, in
    // order (see the ring's note).
    const int owners = both ? 8 : 4;
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    for (int j = 0; j < geo.ncb * geo.nkb; ++j) {
      int cb, kb;
      geo.block(j, both, &cb, &kb);
      if (!both && (cb & 1) != wg) continue;
      const int g = next + j, stage = g % STAGES;
      const long long t0 = clock64();
      const volatile int* idx = &sm->issued[stage];
      while (*idx != g)
        if (clock64() - t0 > (1ll << 32)) __trap();
      mbar_wait(&sm->full[stage], (uint32_t)((g / STAGES) & 1));
#ifdef AGG_PHASE_CLOCKS
      if (threadIdx.x == 0)
        atomicAdd(&g_phase_cycles[wait_phase],
                  (unsigned long long)(clock64() - t0));
#endif
      const int bw = min(64, geo.wo - 64 * cb);
      const int bk = min(64, geo.wr - 64 * kb);
      // forward: k8 stride 128 (leading), n8 stride 16 bk; transposed:
      // n8 (reduction) stride 16 bw (leading), k8 stride 128
      const uint32_t slab = sm_u32(buf + stage * kSlabBytes);
      const uint32_t lbo = trans ? 16 * bw : 128, sbo = trans ? 128 : 16 * bk;
      const uint32_t kst = trans ? 32 * bw : 256;
      const uint32_t xa = xrow + kb * 128;
      const int nks = bk >> 4;
      const bool kb0 = kb == 0;          // the block's first slab
#ifdef AGG_PHASE_CLOCKS
      const long long t1 = clock64();
#endif
      if (trans) {
        switch (bw) {
          case 64: wg_block<64, 1>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
          case 48: wg_block<48, 1>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
          case 32: wg_block<32, 1>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
          default: wg_block<16, 1>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
        }
      } else {
        switch (bw) {
          case 64: wg_block<64, 0>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
          case 48: wg_block<48, 0>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
          case 32: wg_block<32, 0>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
          default: wg_block<16, 0>(d, xa, slab, nks, lbo, sbo, kst, kb0); break;
        }
      }
#ifdef AGG_PHASE_CLOCKS
      if (threadIdx.x == 0)
        atomicAdd(&g_phase_cycles[wait_phase - 1],
                  (unsigned long long)(clock64() - t1));
#endif
      // Release: the warp's products have completed (wg_block waits for
      // them).  Every owner warp arrives on the stage's empty barrier (8 /
      // owners each); the first owner warp waits for the fill's phase,
      // fences the async proxy and refills the stage.
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&sm->empty[stage], 8 / owners);
        if ((threadIdx.x >> 5) == (both ? 0 : 4 * wg)) {
          mbar_wait(&sm->empty[stage], (uint32_t)((g / STAGES) & 1));
          fence_proxy_async_smem();
          issue(g + STAGES);
        }
      }
      if (kb < geo.nkb - 1) continue;
#ifdef AGG_PHASE_CLOCKS
      const long long t2 = clock64();
#endif
      // the block's epilogue; its biases first, so that no load waits
      // behind a store
      const int r = row0 + wq * 16 + (lane >> 2);
      float bias[16];
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int c = 64 * cb + h * 8 + 2 * (lane & 3);
        const bool on = B && 8 * h < bw;
        bias[2 * h] = on ? __ldg(B + L.b + c) : 0.f;
        bias[2 * h + 1] = on ? __ldg(B + L.b + c + 1) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        if (8 * h >= bw) break;
        const int c = 64 * cb + h * 8 + 2 * (lane & 3);
        const float b0 = bias[2 * h], b1 = bias[2 * h + 1];
        if (r < rows) {
          ep(r, c, d[4 * h] + b0);
          ep(r, c + 1, d[4 * h + 1] + b1);
        }
        if (r + 8 < rows) {
          ep(r + 8, c, d[4 * h + 2] + b0);
          ep(r + 8, c + 1, d[4 * h + 3] + b1);
        }
      }
#ifdef AGG_PHASE_CLOCKS
      if (threadIdx.x == 0)
        atomicAdd(&g_phase_cycles[wait_phase - 2],
                  (unsigned long long)(clock64() - t2));
#endif
    }
    next += geo.ncb * geo.nkb;
    op = op + 1 == nops ? 0 : op + 1;
  }
};

}  // namespace agg
