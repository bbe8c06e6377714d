// Check of csrc/sm90_common.cuh on the card: the weight ring and its wgmma
// products (forward and transposed, 48 / 64 / 80 / 128 rows, 3 and 4
// stages, three repetitions of a six-product segment) against a host
// reference.  Each configuration runs twice: one block with a block
// barrier after every product, and 264 blocks with none, where one
// warpgroup sleeps before every other product so that the warpgroups
// drift apart inside the segment (the ring alone keeps them in order).
// Prints one line per configuration; exit code 0 when all agree.  Needs an sm_90a card and nvcc:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O1 \
//       -o build/ring_test scripts/ring_test.cu && build/ring_test
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <cmath>
#include <cstring>
#include "../dynibar_tpu_torch/csrc/sm90_common.cuh"
using namespace agg;

constexpr int NL = 3;
struct TArgs {
  Net net;
  const bf16* W;
  const float* B;
  const bf16* X[NL];
  const bf16* D[NL];
  float* out;
  int rows, reps, sync;
};
__host__ __device__ constexpr int ldx_of(int l) {
  return l == 0 ? 88 : l == 1 ? 280 : 72;
}
__host__ __device__ constexpr int ldd_of(int l) {
  return l == 0 ? 56 : l == 1 ? 152 : 40;
}
__host__ __device__ constexpr int xoff(int l) {
  return l == 0 ? 0 : l == 1 ? 128 * 88 : 128 * (88 + 280);
}
__host__ __device__ constexpr int doff(int l) {
  return l == 0 ? 0 : l == 1 ? 128 * 56 : 128 * (56 + 152);
}
constexpr int XTOT = 128 * (88 + 280 + 72), DTOT = 128 * (56 + 152 + 40);
constexpr int OPS = 6;

template <int STAGES>
__global__ void __launch_bounds__(256, 1) kern(TArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  RingSmem* rs = (RingSmem*)(smem + STAGES * kSlabBytes);
  bf16* xs = (bf16*)(smem + STAGES * kSlabBytes + kRingSmemBytes);
  bf16* ds = xs + XTOT;
  for (int l = 0; l < NL; ++l) {
    for (int e = threadIdx.x; e < 128 * ldx_of(l); e += 256)
      xs[xoff(l) + e] = a.X[l][e];
    for (int e = threadIdx.x; e < 128 * ldd_of(l); e += 256)
      ds[doff(l) + e] = a.D[l][e];
  }
  WRing<STAGES> r;
  r.init(rs, ring, a.W, &a.net, 0);
  __syncthreads();
  const WOp ops[OPS] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {2, 1}};
  r.begin(ops, OPS, a.reps, a.rows);
  for (int rep = 0; rep < a.reps; ++rep)
    for (int o = 0; o < OPS; ++o) {
      const int l = ops[o].layer, t = ops[o].trans;
      float* out = a.out + ((size_t)rep * OPS + o) * 128 * 288;
      if (!a.sync && (threadIdx.x >> 7) == ((rep * OPS + o) & 1))
        __nanosleep(2000 + 500 * (blockIdx.x & 7));
      r.consume(l, t, t ? ds + doff(l) : xs + xoff(l),
                t ? ldd_of(l) : ldx_of(l), a.rows, t ? nullptr : a.B,
                [&](int rr, int c, float x) { out[rr * 288 + c] = x; });
      if (a.sync) __syncthreads();
    }
}

static float b2f_h(uint16_t b) {
  uint32_t u = (uint32_t)b << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static uint16_t f2b_h(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return u >> 16;
}

int main() {
  int dims[NL][2] = {{48, 80}, {144, 272}, {32, 64}};
  Net net{}; int woff = 0, boff = 0;
  for (int l = 0; l < NL; ++l) {
    net.l[l] = Lin{woff, boff, dims[l][1], dims[l][0]};
    woff += dims[l][0] * dims[l][1];
    boff += dims[l][0];
  }
  srand(1);
  auto rnd = [] { return (float)rand() / RAND_MAX * 2.f - 1.f; };
  std::vector<uint16_t> Wrow(woff), Wt(woff); std::vector<float> B(boff);
  for (auto& w : Wrow) w = f2b_h(rnd());
  for (auto& b : B) b = rnd();
  for (int l = 0; l < NL; ++l) {
    int N = dims[l][0], K = dims[l][1];
    for (int n = 0; n < N; ++n) for (int k = 0; k < K; ++k) {
      // tile_weights: 64x64 blocks one after the other, core matrices
      // row-major inside a block
      const int bn = N - (n & ~63) < 64 ? N - (n & ~63) : 64;
      const int bk = K - (k & ~63) < 64 ? K - (k & ~63) : 64;
      size_t t = (size_t)(n & ~63) * K + (size_t)bn * (k & ~63) +
                 (((n & 63) >> 3) * (bk / 8) + ((k & 63) >> 3)) * 64 +
                 (n & 7) * 8 + (k & 7);
      Wt[net.l[l].w + t] = Wrow[net.l[l].w + (size_t)n * K + k];
    }
  }
  std::vector<uint16_t> X[NL], D[NL];
  for (int l = 0; l < NL; ++l) {
    X[l].resize(128 * ldx_of(l)); D[l].resize(128 * ldd_of(l));
    for (auto& x : X[l]) x = f2b_h(rnd());
    for (auto& x : D[l]) x = f2b_h(rnd());
  }
  TArgs a{}; a.net = net;
  bf16* dW; float* dB; cudaMalloc(&dW, woff * 2); cudaMalloc(&dB, boff * 4);
  cudaMemcpy(dW, Wt.data(), woff * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, B.data(), boff * 4, cudaMemcpyHostToDevice);
  a.W = dW; a.B = dB;
  for (int l = 0; l < NL; ++l) {
    bf16 *x, *d;
      cudaMalloc(&x, X[l].size() * 2);
      cudaMalloc(&d, D[l].size() * 2);
    cudaMemcpy(x, X[l].data(), X[l].size() * 2, cudaMemcpyHostToDevice);
    cudaMemcpy(d, D[l].data(), D[l].size() * 2, cudaMemcpyHostToDevice);
    a.X[l] = x; a.D[l] = d;
  }
  const int reps = 3;
  size_t outn = (size_t)reps * OPS * 128 * 288;
  cudaMalloc(&a.out, outn * 4);
  int bad_total = 0;
  for (int sync : {1, 0}) for (int stages : {3, 4})
  for (int rows : {64, 48, 128, 80}) {
    // every block computes the same products and writes the same values
    const int blocks = sync ? 1 : 264;
    a.rows = rows; a.reps = reps; a.sync = sync;
    cudaMemset(a.out, 0, outn * 4);
    size_t sm = stages * kSlabBytes + kRingSmemBytes + (XTOT + DTOT) * 2;
    cudaError_t e;
    if (stages == 3) {
      cudaFuncSetAttribute(kern<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
      kern<3><<<blocks, 256, sm>>>(a);
    }
    else {
      cudaFuncSetAttribute(kern<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
      kern<4><<<blocks, 256, sm>>>(a);
    }
    e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    if (e != cudaSuccess) { printf("ring_test: CUDA error %s (sync %d stages %d rows %d)\n", cudaGetErrorString(e), sync, stages, rows); return 1; }
    std::vector<float> out(outn);
      cudaMemcpy(out.data(), a.out, outn * 4, cudaMemcpyDeviceToHost);
    double maxerr[OPS] = {0};
    int ops[OPS][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {2, 1}};
    for (int rep = 0; rep < reps; ++rep) for (int o = 0; o < OPS; ++o) {
      int l = ops[o][0], t = ops[o][1], N = dims[l][0], K = dims[l][1];
      int ncol = t ? K : N, nred = t ? N : K;
      for (int rr = 0; rr < rows; ++rr) for (int c = 0; c < ncol; ++c) {
        double ref = t ? 0.0 : B[net.l[l].b + c];
        for (int q = 0; q < nred; ++q) {
          const float xa = t ? b2f_h(D[l][rr * ldd_of(l) + q])
                             : b2f_h(X[l][rr * ldx_of(l) + q]);
          const float w = t ? b2f_h(Wrow[net.l[l].w + (size_t)q * K + c])
                            : b2f_h(Wrow[net.l[l].w + (size_t)c * K + q]);
          ref += (double)xa * w;
        }
        double got = out[((size_t)rep * OPS + o) * 128 * 288 + rr * 288 + c];
        maxerr[o] = fmax(maxerr[o], fabs(got - ref));
      }
    }
    int bad = 0;
    for (int o = 0; o < OPS; ++o) bad += maxerr[o] > 1e-2;
    bad_total += bad;
    printf("ring_test %s stages %d rows %3d: max abs err per op",
           sync ? "synced " : "drifting", stages, rows);
    for (int o = 0; o < OPS; ++o) printf(" %.3g", maxerr[o]);
    printf("%s\n", bad ? "  MISMATCH" : "  ok");
  }
  return bad_total ? 2 : 0;
}
