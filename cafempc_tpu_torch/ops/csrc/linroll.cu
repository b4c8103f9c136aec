// Fused linear rollout dx_{k+1} = M_k dx_k + c_k, one warp per scenario.
//
// Replaces the TPU kernel cafempc_tpu/ops/fused_linroll.py::
// fused_linear_rollout (_linroll_kernel, pallas_call at fused_linroll.py:73).
// Semantics and shapes: see cafempc_tpu_torch/ops/linroll.py, whose
// linroll_reference is the plain PyTorch twin this kernel is tested against.
// Shapes: 1 <= xs <= 40 (lane r owns rows r and r + 32) with rows of xs
// values a multiple of 16 bytes (the unit of a bulk copy), one kernel
// instantiation per width; any B >= 1, N >= 1.  The wrapper refuses other
// widths and copies an operand that does not start 16-byte aligned.
//
// What bounds it: per knot one xs x xs matvec per scenario that depends on
// the previous knot, so each scenario is a chain of N short steps; the M
// stream (B*N*xs*xs values) is read once.  At B = 256, N = 112, xs = 24 in
// f32 that is 72 MB, 0.0214 ms at the HBM rate.  A kernel that loads M_k
// from device memory when knot k starts waits a full round trip per knot
// (the ported kernel: 0.171 ms on an H100).  With the operands in shared
// memory ahead of the chain, the chain itself is what is left, and every
// instruction on it counts: clock64() per knot (f32, xs = 24, stages of
// one knot, PERF.md) gave ~100 cycles to the mbarrier wait, ~200 to the
// two bulk copies and their expect-tx, and ~425 to a dot product whose
// loop length was known only at run time.  So:
//  * a ring of kStages stages in shared memory, each holding a group of up
//    to kMaxGroup knots' M_k and c_k (as many as fit in kStageBytes),
//    filled by two TMA bulk copies that complete on the stage's mbarrier;
//    lane 0 starts the copies of group g + kStages once the warp has read
//    group g, so the next group is in flight while one is computed, and the
//    wait and the copies are paid once per group, not per knot;
//  * the chain in one warp with no block barrier: lane r reads its row of
//    M_k from the stage by 16-byte loads, and dx_k from a ping-pong buffer
//    in which all lanes read the same addresses (broadcasts, no shuffles);
//    one __syncwarp per knot; one kernel per width, so the dot product is
//    unrolled and its loads issue together;
//  * the lanes walk their rows' 16-byte chunks from staggered starts: lane
//    r starts at chunk (r mod 8) / (8 / gcd(chunks per row, 8)), so the 8
//    lanes of a quarter-warp's 16-byte load hit 8 different 4-bank groups
//    (rows of 96 bytes in f32 at xs = 24 would otherwise put lanes r and
//    r + 4 on one group, and 192-byte f64 rows four lanes);
//  * dx_{k+1} is written to device memory as one row per knot, coalesced.
// Measured on an H100 80GB HBM3 at 700 W: 0.029 ms at B = 256, N = 112,
// xs = 24 in f32 (1.34x the byte bound), 0.053 ms in f64, and 0.028 ms at
// the runtime's B = 1 in f64; what is left is the chain, ~300 cycles a
// knot (the loop's address work and the latency of the dx loads).
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace {

using namespace tma;

constexpr int kMaxXs = 40;          // rows r and r + 32 on lane r
constexpr int kStages = 2;          // stages in the ring
constexpr int kStageBytes = 40960;  // at most this many bytes of knots a stage
constexpr int kMaxGroup = 8;        // at most this many knots a stage
constexpr int kSmemDefault = 48 * 1024;  // above it a kernel must opt in

// The layout for rows of XS values: a stage is [GROUP][XS][XS] M, then
// [GROUP][XS] c; the ring, then dx by knot parity, then the stages'
// mbarriers.  Every array starts 16-byte aligned (XS values are a multiple
// of 16 bytes).
template <typename T, int XS>
struct Shape {
  static constexpr int V = 16 / sizeof(T);  // values per 16 bytes
  static constexpr int NQ = XS / V;         // 16-byte chunks per row
  static constexpr int KNOT = XS * XS + XS;
  static constexpr int FIT = kStageBytes / (KNOT * (int)sizeof(T));
  static constexpr int GROUP = FIT < 1 ? 1 : (FIT > kMaxGroup ? kMaxGroup : FIT);
  static constexpr int STAGE = GROUP * KNOT;
  static constexpr size_t SMEM = sizeof(T) * ((size_t)kStages * STAGE + 2 * XS)
                                 + kStages * sizeof(uint64_t);
  static_assert(XS % V == 0 && XS <= kMaxXs, "rows of 16-byte multiples");
};

__device__ __forceinline__ float hsum(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}
__device__ __forceinline__ double hsum(const double (&a)[2]) {
  return a[0] + a[1];
}

template <typename T, int XS>
__global__ void __launch_bounds__(32) linroll_kernel(
    int N, const T* __restrict__ M, const T* __restrict__ c,
    const T* __restrict__ dx0, T* __restrict__ out) {
  using S = Shape<T, XS>;
  constexpr int V = S::V, NQ = S::NQ, G = S::GROUP;
  constexpr bool kTwo = XS > 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][S::STAGE]
  T* dx = ring + kStages * S::STAGE;         // [2][XS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dx + 2 * XS);  // [kStages]
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const T* Mb = M + b * N * XS * XS;
  const T* cb = c + b * N * XS;
  T* ob = out + b * N * XS;
  const int n_groups = (N + G - 1) / G;

  // knots g * G ... of M and c into stage g % kStages (one lane)
  auto fetch = [&](int g) {
    const int s = g % kStages, k0 = g * G;
    const int n = N - k0 < G ? N - k0 : G;
    T* st = ring + s * S::STAGE;
    mbar_expect_tx(bars + s, n * S::KNOT * sizeof(T));
    bulk_copy(st, Mb + (size_t)k0 * XS * XS, n * XS * XS, bars + s);
    bulk_copy(st + G * XS * XS, cb + (size_t)k0 * XS, n * XS, bars + s);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    for (int g = 0; g < n_groups && g < kStages; ++g) fetch(g);
  }
  for (int i = lane; i < XS; i += 32) dx[i] = dx0[b * XS + i];
  __syncwarp();

  constexpr int kLow = NQ & -NQ;
  constexpr int kGcd = kLow < 8 ? kLow : 8;  // gcd(NQ, 8)
  const int rot = (lane & 7) / (8 / kGcd);
  const bool one = lane < XS, two = kTwo && lane + 32 < XS;
  const int r0 = (one ? lane : 0) * XS, r1 = (two ? lane + 32 : 0) * XS;
  int s = 0;
  unsigned parity = 0;
  for (int k = 0; k < N; ++k) {
    const int j = k % G;  // knot k is knot j of its group, in stage s
    if (j == 0) mbar_wait(bars + s, parity);
    const T* Mk = ring + s * S::STAGE + j * XS * XS;
    const T* ck = ring + s * S::STAGE + G * XS * XS + j * XS;
    const T* cur = dx + (k & 1) * XS;
    T* nxt = dx + ((k & 1) ^ 1) * XS;
    // two sets of accumulators halve the dependent chain of FMAs
    T a0[2][V], a1[2][V];
#pragma unroll
    for (int u = 0; u < V; ++u) a0[0][u] = a0[1][u] = a1[0][u] = a1[1][u] = T(0);
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      const int q = t + rot < NQ ? t + rot : t + rot - NQ;
      T d[V], m[V];
      ld16(d, cur + q * V);
      ld16(m, Mk + r0 + q * V);
#pragma unroll
      for (int u = 0; u < V; ++u) a0[t & 1][u] += m[u] * d[u];
      if (two) {
        ld16(m, Mk + r1 + q * V);
#pragma unroll
        for (int u = 0; u < V; ++u) a1[t & 1][u] += m[u] * d[u];
      }
    }
    if (one) {
      const T v = ck[lane] + (hsum(a0[0]) + hsum(a0[1]));
      nxt[lane] = v;
      ob[(size_t)k * XS + lane] = v;
    }
    if (two) {
      const T v = ck[lane + 32] + (hsum(a1[0]) + hsum(a1[1]));
      nxt[lane + 32] = v;
      ob[(size_t)k * XS + lane + 32] = v;
    }
    __syncwarp();  // stage s and dx_k are read, dx_{k+1} is written
    if (j == G - 1 || k == N - 1) {
      // knot k ends its group: refill the group's stage
      if (lane == 0 && k / G + kStages < n_groups) fetch(k / G + kStages);
      if (++s == kStages) {
        s = 0;
        parity ^= 1;
      }
    }
  }
}

template <typename T, int XS>
int launch_xs(int batch, int N, const T* M, const T* c, const T* dx0, T* out,
              cudaStream_t stream) {
  constexpr size_t smem = Shape<T, XS>::SMEM;
  if constexpr (smem > (size_t)kSmemDefault) {
    // above 48 KB of dynamic shared memory a kernel must opt in: once per
    // instantiation and device
    static bool opted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !opted[dev]) {
      err = cudaFuncSetAttribute(linroll_kernel<T, XS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) opted[dev] = true;
    }
  }
  linroll_kernel<T, XS><<<batch, 32, smem, stream>>>(N, M, c, dx0, out);
  return (int)cudaGetLastError();
}

// the instantiation for rows of xs values: every multiple of 16 bytes up
// to kMaxXs values
template <typename T, int XS = (int)(16 / sizeof(T))>
int launch_width(int xs, int batch, int N, const T* M, const T* c,
                 const T* dx0, T* out, cudaStream_t stream) {
  if constexpr (XS > kMaxXs) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (xs == XS) return launch_xs<T, XS>(batch, N, M, c, dx0, out, stream);
    return launch_width<T, XS + (int)(16 / sizeof(T))>(xs, batch, N, M, c, dx0, out,
                                                stream);
  }
}

template <typename T>
int launch_linroll(int batch, int N, int xs, const T* M, const T* c,
                   const T* dx0, T* out, cudaStream_t stream) {
  // bulk copies move rows of a multiple of 16 bytes from 16-byte aligned
  // operands
  const size_t addr = reinterpret_cast<size_t>(M) | reinterpret_cast<size_t>(c);
  if (xs < 1 || xs > kMaxXs || N < 1 || (xs * sizeof(T)) % 16 != 0 ||
      addr % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  return launch_width<T>(xs, batch, N, M, c, dx0, out, stream);
}

}  // namespace

extern "C" int cafempc_linroll_f32(int batch, int N, int xs, const float* M,
                                   const float* c, const float* dx0,
                                   float* out, void* stream) {
  return launch_linroll<float>(batch, N, xs, M, c, dx0, out,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int cafempc_linroll_f64(int batch, int N, int xs, const double* M,
                                   const double* c, const double* dx0,
                                   double* out, void* stream) {
  return launch_linroll<double>(batch, N, xs, M, c, dx0, out,
                                static_cast<cudaStream_t>(stream));
}
