// Fused HS-DDP Riccati backward sweep, one CTA of 8 warps per scenario.
//
// Replaces the TPU kernel cafempc_tpu/ops/fused_sweep.py::
// fused_backward_sweep (_sweep_kernel, pallas_call at fused_sweep.py:288).
// Semantics and shapes: see cafempc_tpu_torch/ops/sweep.py, whose
// sweep_reference is the plain PyTorch twin this kernel is tested against.
// Shapes: 1 <= us <= 32 (a warp's lanes hold the rows of Quu) and
// 1 <= xs <= 40 (the f64 working set then still fits one block's shared
// memory), with rows of xs and of us values a multiple of 16 bytes (the
// unit of a bulk copy); any B >= 1, N >= 1.  The wrapper refuses other
// widths and copies an operand that does not start 16-byte aligned.
//
// What bounds it: the recursion is sequential in the N knots, so each
// scenario is one chain of small dense products (xs = us = 24 on the HKD
// path: six 24x24x24 products plus the Cholesky and its solves, ~0.2 MFLOP
// per knot).  Per knot it reads 5 matrices from device memory and writes 4
// back: at B = 256, N = 112 in f32 that is ~0.61 GB and ~5.7 GFLOP per
// sweep, 0.18 ms at the HBM rate and 0.09 ms at the f32 FMA peak.  B = 256
// CTAs fit in one wave (two per SM), so the time is N times the latency of
// one knot's dependent chain, not bandwidth or FLOPs.  On the H100 each
// shuffle costs a warp 16-35 cycles of dispatch beyond its latency (measured
// on an H100 80GB HBM3, PERF.md), so the design shortens the chain and
// counts its broadcasts:
//  * the Cholesky of Quu runs in one warp, in registers: lane i holds row i
//    of the trailing matrix and a right-looking elimination updates the
//    rows in registers, with no block barrier inside the factorization.
//    Each step publishes its column of L and the next pivot in shared
//    memory, and after a __syncwarp the lanes read the column back as
//    16-byte broadcast loads, in four tiers that load the live columns
//    rounded up to 8: a few loads a step where shuffles would take one per
//    entry;
//  * the 1 + xs right-hand sides [Qu | Qux] are spread over the 8 warps
//    (rows on the lanes, columns interleaved within a warp), and forward and
//    back substitution run as us + us shuffle steps with no block barrier
//    (measured slower: the solves folded into the Cholesky warp, or their
//    forward pass run beside the factorization in warps 1-7);
//  * each knot's operands (A, B, lx, lu, lxx, luu, lux, defect) are copied
//    into a second shared-memory buffer while the previous knot computes,
//    so no device-memory load sits on the chain: one bulk copy (TMA) per
//    operand, started by one lane of one warp each, completing on the
//    buffer's mbarrier;
//  * the products run as register tiles in "transposed-left" form (both
//    operands read row by row from shared memory): H'^T A and H'^T B in one
//    pass, Qxx, Qux and Quu in the next; Qxx and the new H are computed as
//    symmetric tile pairs, so their symmetrization needs no extra barrier,
//    and each pair of the new H is shared by two threads, one per half of
//    its sum.  A dynamics knot has 5 block barriers, a transform knot 2;
//  * the carry H is written to device memory at the next knot, a row per
//    warp, where the tile pairs would scatter it.
// Rows are padded to odd strides where a lane-per-row access would hit one
// bank.  f32 FMAs on the CUDA cores, no tensor cores: lower matmul precision
// changes the solver's path.
//
// PSD rule (must match the Pallas kernel, not LAPACK): the pivot
// d_j = Quu_jj - 1e-9 - sum_m L_jm^2 (accumulated in m order) is ok only if
// d_j > 0, and column j is scaled by rsqrt(max(d_j, 1e-30)), so
// L_jj = (Quu_jj - sum_m L_jm^2) * rsqrt(d_j): the numerator and the pivot
// are two accumulators.  Which scenarios are flagged drives the solver's
// regularization retries.
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace {

using namespace tma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxXs = 40;
constexpr int kMaxUs = 32;
// right-hand side columns per warp in the solves: the kernel is built for
// 4 (xs <= 31) and for kMaxCols
constexpr int kMaxCols = (1 + kMaxXs + kWarps - 1) / kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// row stride: odd, so that lane i reading row i hits bank (i * stride) mod 32
__host__ __device__ constexpr int odd(int n) { return n | 1; }

// n elements at offset o, then 4 of slack; offsets are multiples of 4
// elements, so every array starts 16-byte aligned
__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += (n + 4 + 3) & ~3;
  return at;
}

// The n x n matrix S (row stride lds) to device memory, row by warp:
// coalesced stores.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const T* S, int lds,
                                           int n, int warp, int lane) {
  for (int i = warp; i < n; i += kWarps)
    for (int j = lane; j < n; j += 32) dst[i * n + j] = S[i * lds + j];
}

// Shared-memory layout, in elements of T; every array is followed by 4
// elements of slack, since a register tile at the ragged edge reads (and
// discards) up to 2 elements past its array's last row.
struct Layout {
  int ldx, ldc, ldu, ldq, ldX;  // strides: [xs,.], [xs,xs+us], Quu, Qux, X
  int G, H, Gn, HAB, Qxu, Qs, Quu, Qux, L, invd, X, Cb, buf;
  int A, B, lx, lu, lxx, luu, lux, d, buf_size, total;

  __host__ __device__ Layout(int xs, int us) {
    const int nc = xs + us;
    ldx = odd(xs);
    ldc = (nc + 3) & ~3;
    ldu = odd(us);
    ldq = odd(xs);
    ldX = odd(1 + xs);
    int o = 0;
    G = take(o, xs);
    H = take(o, xs * ldx);
    Gn = take(o, xs);
    HAB = take(o, xs * ldc);
    Qxu = take(o, nc);
    Qs = take(o, xs * ldx);
    Quu = take(o, us * ldu);
    Qux = take(o, us * ldq);
    L = take(o, (us + 1) * ldu);  // row us: scratch for lanes >= us
    invd = take(o, us);
    X = take(o, us * ldX);
    Cb = take(o, 128);  // [2][64] a Cholesky column, by step parity
    const int base = o;
    o = 0;
    A = take(o, xs * xs);
    B = take(o, xs * us);
    lx = take(o, xs);
    lu = take(o, us);
    lxx = take(o, xs * xs);
    luu = take(o, us * us);
    lux = take(o, us * xs);
    d = take(o, xs);
    buf_size = o;
    buf = base;
    total = base + 2 * buf_size;
  }
};

template <typename T>
size_t sweep_smem_bytes(int xs, int us) {
  // the data, then the two buffers' mbarriers
  return sizeof(T) * (size_t)Layout(xs, us).total + 2 * sizeof(uint64_t);
}

// acc[ii][jj] += sum_{l < K} P[l * ldp + i0 + ii] * Q[l * ldq + j0 + jj]:
// one register tile of a product whose operands are both read row by row.
template <int TI, int TJ, typename T>
__device__ __forceinline__ void tile_tn(T (&acc)[TI][TJ], int K, const T* P,
                                        int ldp, int i0, const T* Q, int ldq,
                                        int j0) {
#pragma unroll 4
  for (int l = 0; l < K; ++l) {
    T p[TI], q[TJ];
#pragma unroll
    for (int ii = 0; ii < TI; ++ii) p[ii] = P[l * ldp + i0 + ii];
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) q[jj] = Q[l * ldq + j0 + jj];
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) acc[ii][jj] += p[ii] * q[jj];
  }
}

template <int TI, int TJ, typename T>
__device__ __forceinline__ void zero(T (&acc)[TI][TJ]) {
#pragma unroll
  for (int ii = 0; ii < TI; ++ii)
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) acc[ii][jj] = T(0);
}

// Block pair p of the lower triangle (I >= J) of an nb x nb block grid.
__device__ __forceinline__ void pair_blocks(int p, int& I, int& J) {
  int i = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  while (i * (i + 1) / 2 > p) --i;
  I = i;
  J = p - i * (i + 1) / 2;
}

// The 2x2 blocks (I, J) and (J, I) of C = P^T Q over K rows, in one pass:
// c[ii][jj] = C[2I+ii][2J+jj], t[ii][jj] = C[2J+jj][2I+ii] (on a diagonal
// block the two hold the same sums in the same order).
template <typename T>
__device__ __forceinline__ void pair_tn(T (&c)[2][2], T (&t)[2][2], int I,
                                        int J, int K, const T* P, int ldp,
                                        const T* Q, int ldq) {
  zero(c);
  zero(t);
#pragma unroll 4
  for (int l = 0; l < K; ++l) {
    const T* p = P + l * ldp;
    const T* q = Q + l * ldq;
    const T pi[2] = {p[2 * I], p[2 * I + 1]}, pj[2] = {p[2 * J], p[2 * J + 1]};
    const T qi[2] = {q[2 * I], q[2 * I + 1]}, qj[2] = {q[2 * J], q[2 * J + 1]};
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        c[ii][jj] += pi[ii] * qj[jj];
        t[ii][jj] += pj[jj] * qi[ii];
      }
  }
}

// Step j of the Cholesky warp's elimination: lane i holds row i of the
// trailing matrix shifted one column per step (a[t] is entry (i, j + t)),
// and the kT entries right of the pivot column are updated with the
// column's entries.  The column goes through shared memory: every lane
// stores its L_ij at cb[32 + i - j] (cb alternates between two 64-entry
// buffers by step), and after a __syncwarp every lane reads entries
// j + 1 .. j + kT back as 16-byte broadcast loads: a few loads in place of
// kT shuffles, each of which costs the warp 16-35 cycles of dispatch.
// kT >= us - 1 - j: columns past the matrix are never updated once they
// are dead.
template <int kT, typename T>
__device__ __forceinline__ void chol_step(T (&a)[kMaxUs], T& dd, T& piv,
                                          T& lii, bool& okw, T* Lrow, T* cb,
                                          int j, int lane) {
  okw = okw && (piv > T(0));
  const T lij = a[0] * rsqrt_t(piv > T(1e-30) ? piv : T(1e-30));
  Lrow[j] = lij;
  lii = lane == j ? lij : lii;
  dd -= lij * lij;
  cb += (j & 1) * 64;
  cb[32 + lane - j] = lij;
  if (lane == j + 1) cb[0] = dd;  // the next pivot: slot 0 is no lane's
  __syncwarp();
  piv = cb[0];
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int t0 = 0; t0 <= kT; t0 += V) {
    T c[V];
    ld16(c, cb + 32 + t0);
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (t0 + u >= 1 && t0 + u <= kT)
        a[t0 + u - 1] = a[t0 + u] - lij * c[u];
  }
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads, 2) sweep_kernel(
    int N, int xs, int us,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux, const T* __restrict__ phixT,
    const T* __restrict__ phixxT, const T* __restrict__ defect,
    const int* __restrict__ w, const T* __restrict__ reg,
    T* __restrict__ G_out, T* __restrict__ H_out, T* __restrict__ K_out,
    T* __restrict__ dU_out, T* __restrict__ Qu_out, T* __restrict__ Quu_out,
    T* __restrict__ Qux_out, T* __restrict__ ok_out, T* __restrict__ dv_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Layout lay(xs, us);
  const int xx = xs * xs, xu = xs * us, uu = us * us, nc = xs + us;
  const int ldx = lay.ldx, ldc = lay.ldc, ldu = lay.ldu, ldq = lay.ldq,
            ldX = lay.ldX;
  T* G = sm + lay.G;      // [xs]          value gradient carry
  T* H = sm + lay.H;      // [xs, ldx]     value Hessian carry
  T* Gn = sm + lay.Gn;    // [xs]          G' + H' d
  T* HAB = sm + lay.HAB;  // [xs, ldc]     H'^T [A | B]
  T* Qxu = sm + lay.Qxu;  // [xs + us]     Qx, then Qu
  T* Qs = sm + lay.Qs;    // [xs, ldx]     Qxx, regularized and symmetrized
  T* Quu = sm + lay.Quu;  // [us, ldu]     regularized
  T* Qux = sm + lay.Qux;  // [us, ldq]
  T* L = sm + lay.L;      // [us, ldu]     Cholesky factor (lower)
  T* invd = sm + lay.invd;  // [us]        1 / L_ii
  T* X = sm + lay.X;      // [us, ldX]     (L L^T)^-1 [Qu | Qux]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.total);  // [2]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T r = reg[b];
  bool ok = true;  // held by thread 0 (lane 0 of the Cholesky warp)
  T dv = T(0);     // held by thread 0

  // operands of knot k into buffer k & 1, as they lie in device memory:
  // lane 0 of warp q starts one bulk copy of operand q, completing on the
  // buffer's mbarrier (thread 0 has set the phase's byte count before the
  // barrier that precedes the copies)
  const unsigned tx_bytes =
      sizeof(T) * (2 * xx + 2 * xu + uu + 2 * xs + us);
  auto prefetch = [&](int k) {
    if (lane != 0) return;
    T* o = sm + lay.buf + (k & 1) * lay.buf_size;
    const size_t bk = (size_t)b * N + k;
    const T* dk = defect + ((size_t)b * (N + 1) + k + 1) * xs;
    uint64_t* bar = bars + (k & 1);
    switch (warp) {
      case 0: bulk_copy(o + lay.A, A + bk * xx, xx, bar); break;
      case 1: bulk_copy(o + lay.B, Bm + bk * xu, xu, bar); break;
      case 2: bulk_copy(o + lay.lxx, lxx + bk * xx, xx, bar); break;
      case 3: bulk_copy(o + lay.lux, lux + bk * xu, xu, bar); break;
      case 4: bulk_copy(o + lay.luu, luu + bk * uu, uu, bar); break;
      case 5: bulk_copy(o + lay.lx, lx + bk * xs, xs, bar); break;
      case 6: bulk_copy(o + lay.lu, lu + bk * us, us, bar); break;
      default: bulk_copy(o + lay.d, dk, xs, bar); break;
    }
  };

  for (int i = tid; i < xs; i += kThreads) G[i] = phixT[(size_t)b * xs + i];
  for (int e = tid; e < xx; e += kThreads)
    H[(e / xs) * ldx + e % xs] = phixxT[(size_t)b * xx + e];
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_expect_tx(bars + ((N - 1) & 1), tx_bytes);
  }
  __syncthreads();
  prefetch(N - 1);
  int w_next = w[N - 1];

  for (int k = N - 1; k >= 0; --k) {
    // buffer k & 1 is used by every other knot: this is its use
    // (N - 1 - k) / 2, which waits for that phase's parity
    mbar_wait(bars + (k & 1), ((N - 1 - k) >> 1) & 1);
    if (tid == 0 && k > 0)
      mbar_expect_tx(bars + ((k - 1) & 1), tx_bytes);
    __syncthreads();  // barrier 1: knot k's operands and the carry are in
    const bool wk = w_next > 0;
    if (k > 0) {
      prefetch(k - 1);
      w_next = w[k - 1];
    }
    const T* op = sm + lay.buf + (k & 1) * lay.buf_size;
    const T* Ak = op + lay.A;  // [xs, xs]
    const T* Bk = op + lay.B;  // [xs, us]
    const int ncols = wk ? xs : nc;  // a transform step needs no H'B
    const size_t bk = (size_t)b * N + k;
    T* Gk = G_out + bk * xs;
    // the carry H is knot k + 1's output: stored here, row by row
    if (k < N - 1) store_rows(H_out + (bk + 1) * xx, H, ldx, xs, warp, lane);

    // ---- stage 1: HAB = H'^T [A | B] as 2x3 tiles over A's columns, then
    // over B's (a transform step needs no H'B), and Gn = G' + H' d
    {
      const int ta = cdiv(xs, 3), na = cdiv(xs, 2) * ta;
      const int tb = cdiv(us, 3), nb = wk ? 0 : cdiv(xs, 2) * tb;
      const T* d = op + lay.d;
      for (int t = tid; t < na + nb + xs; t += kThreads) {
        if (t < na) {
          const int c0 = (t % ta) * 3, i0 = (t / ta) * 2;
          T acc[2][3];
          zero(acc);
          tile_tn(acc, xs, H, ldx, i0, Ak, xs, c0);
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int jj = 0; jj < 3; ++jj)
              if (i0 + ii < xs && c0 + jj < xs)
                HAB[(i0 + ii) * ldc + c0 + jj] = acc[ii][jj];
        } else if (t < na + nb) {
          const int s = t - na, c0 = (s % tb) * 3, i0 = (s / tb) * 2;
          T acc[2][3];
          zero(acc);
          tile_tn(acc, xs, H, ldx, i0, Bk, us, c0);
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int jj = 0; jj < 3; ++jj)
              if (i0 + ii < xs && c0 + jj < us)
                HAB[(i0 + ii) * ldc + xs + c0 + jj] = acc[ii][jj];
        } else {
          const int i = t - na - nb;
          T s = T(0);
          for (int j = 0; j < xs; ++j) s += H[i * ldx + j] * d[j];
          Gn[i] = G[i] + s;
        }
      }
    }
    __syncthreads();  // barrier 2

    // ---- stage 2: the Q-expansion.  Items: Qxx as symmetric 2x2 block
    // pairs, Qux and Quu as 3x3 tiles (dynamics steps only), then
    // [Qx | Qu] = [lx | lu] + [A | B]^T Gn.  Its base (before reg) is the
    // transform step's update, written straight into the carry.
    {
      const int nb = cdiv(xs, 2), npair = nb * (nb + 1) / 2;
      const int tu = cdiv(us, 3);
      const int nux = wk ? 0 : tu * cdiv(xs, 3);
      const int nuu = wk ? 0 : tu * tu;
      const T* lxxk = op + lay.lxx;
      for (int t = tid; t < npair + nux + nuu + ncols; t += kThreads) {
        if (t < npair) {
          int I, J;
          pair_blocks(t, I, J);
          T c[2][2], tr[2][2];
          pair_tn(c, tr, I, J, xs, Ak, xs, HAB, ldc);
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int i = 2 * I + ii, j = 2 * J + jj;
              if (i >= xs || j >= xs || (I == J && j > i)) continue;
              const T bij = lxxk[i * xs + j] + c[ii][jj];
              const T bji = lxxk[j * xs + i] + tr[ii][jj];
              if (wk) {
                H[i * ldx + j] = bij;
                H[j * ldx + i] = bji;
              } else {
                const T dg = (i == j) ? r : T(0);
                const T q = T(0.5) * ((bij + dg) + (bji + dg));
                Qs[i * ldx + j] = q;
                Qs[j * ldx + i] = q;
              }
            }
        } else if (t < npair + nux) {
          const int s = t - npair;
          const int u0 = (s % tu) * 3, j0 = (s / tu) * 3;
          T acc[3][3];
          zero(acc);
          tile_tn(acc, xs, Bk, us, u0, HAB, ldc, j0);
          const T* luxk = op + lay.lux;
#pragma unroll
          for (int ii = 0; ii < 3; ++ii)
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
              const int u = u0 + ii, j = j0 + jj;
              if (u < us && j < xs)
                Qux[u * ldq + j] = luxk[u * xs + j] + acc[ii][jj];
            }
        } else if (t < npair + nux + nuu) {
          const int s = t - npair - nux;
          const int u0 = (s % tu) * 3, v0 = (s / tu) * 3;
          T acc[3][3];
          zero(acc);
          tile_tn(acc, xs, Bk, us, u0, HAB, ldc, xs + v0);
          const T* luuk = op + lay.luu;
#pragma unroll
          for (int ii = 0; ii < 3; ++ii)
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
              const int u = u0 + ii, v = v0 + jj;
              if (u < us && v < us)
                Quu[u * ldu + v] = (luuk[u * us + v] + acc[ii][jj])
                                   + (u == v ? r : T(0));
            }
        } else {
          const int c = t - npair - nux - nuu;
          T s = T(0);
          if (c < xs)
            for (int l = 0; l < xs; ++l) s += Ak[l * xs + c] * Gn[l];
          else
            for (int l = 0; l < xs; ++l) s += Bk[l * us + c - xs] * Gn[l];
          const T q = (c < xs ? op[lay.lx + c] : op[lay.lu + c - xs]) + s;
          if (wk) {
            G[c] = q;
            Gk[c] = q;
          } else {
            Qxu[c] = q;
          }
        }
      }
    }

    T* Kk = K_out + bk * xu;
    T* dUk = dU_out + bk * us;
    T* Quk = Qu_out + bk * us;
    T* Quuk = Quu_out + bk * uu;
    T* Quxk = Qux_out + bk * xu;
    if (wk) {
      // transform step: K = dU = Qu = Qux = 0, Quu = I
      for (int e = tid; e < xu; e += kThreads) {
        Kk[e] = T(0);
        Quxk[e] = T(0);
      }
      for (int i = tid; i < us; i += kThreads) {
        dUk[i] = T(0);
        Quk[i] = T(0);
      }
      for (int e = tid; e < uu; e += kThreads)
        Quuk[e] = (e / us == e % us) ? T(1) : T(0);
      continue;
    }
    __syncthreads();  // barrier 3

    // ---- stage 3: warp 0 factors Quu; the other warps store Qu, Quu, Qux
    if (warp == 0) {
      // Lane i holds row i of the trailing matrix, shifted one column per
      // step so that a[t] is entry (i, j + t) at step j: the loop body is
      // small and indexes registers only at compile time.  Entries of
      // lanes >= us, right of the diagonal, and a lane's pivot after its
      // own step are updated too, with no branch, and never read.
      T a[kMaxUs];
      const int row = lane < us ? lane : 0;
#pragma unroll
      for (int t = 0; t < kMaxUs; ++t)
        a[t] = t < us ? Quu[row * ldu + t] : T(0);
      T dd = Quu[row * ldu + row] - T(1e-9);
      T piv = Quu[0] - T(1e-9);  // lane 0's dd
      T lii = T(1);
      bool okw = true;
      T* Lrow = L + (lane < us ? lane : us) * ldu;
      T* Cb = sm + lay.Cb;
      // the steps in four tiers by the live columns left (us - 1 - j),
      // so that each broadcasts at most 8 columns it does not need
      int j = 0;
#pragma unroll 1
      for (; j < us - 24; ++j) chol_step<31>(a, dd, piv, lii, okw, Lrow, Cb, j, lane);
#pragma unroll 1
      for (; j < us - 16; ++j) chol_step<23>(a, dd, piv, lii, okw, Lrow, Cb, j, lane);
#pragma unroll 1
      for (; j < us - 8; ++j) chol_step<15>(a, dd, piv, lii, okw, Lrow, Cb, j, lane);
#pragma unroll 1
      for (; j < us; ++j) chol_step<7>(a, dd, piv, lii, okw, Lrow, Cb, j, lane);
      if (lane < us) invd[lane] = T(1) / lii;
      if (lane == 0) ok = ok && okw;
    } else {
      for (int i = tid - 32; i < us; i += kThreads - 32) Quk[i] = Qxu[xs + i];
      for (int u = warp - 1; u < us; u += kWarps - 1) {
        for (int v = lane; v < us; v += 32) Quuk[u * us + v] = Quu[u * ldu + v];
        for (int j = lane; j < xs; j += 32) Quxk[u * xs + j] = Qux[u * ldq + j];
      }
    }
    __syncthreads();  // barrier 4

    // ---- stage 4: (L L^T) X = [Qu | Qux]; warp w takes the columns
    // w, w + 8, ...; lane i holds row i; shuffles broadcast x_j
    {
      const int nr = 1 + xs;
      T v[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = warp + q * kWarps;
        v[q] = T(0);
        if (c < nr && lane < us)
          v[q] = (c == 0) ? Qxu[xs + lane] : Qux[lane * ldq + c - 1];
      }
      // the next step's L entry and 1 / L_jj are loaded one step ahead
      const int row = lane < us ? lane : 0;
      T inv = invd[0], lij = L[row * ldu];
      for (int j = 0; j < us; ++j) {
        const T inv_n = invd[j + 1], lij_n = L[row * ldu + j + 1];
        const T l = lane > j && lane < us ? lij : T(0);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {  // lanes < j: l = 0
          const T y = __shfl_sync(kFull, v[q], j) * inv;
          const T upd = v[q] - l * y;
          v[q] = lane == j ? y : upd;
        }
        inv = inv_n;
        lij = lij_n;
      }
      inv = invd[us - 1];
      T lji = L[(us - 1) * ldu + lane];
      for (int j = us - 1; j >= 0; --j) {
        const int jn = j > 0 ? j - 1 : 0;
        const T inv_n = invd[jn], lji_n = L[jn * ldu + lane];
        const T l = lane < j ? lji : T(0);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {  // lanes > j: l = 0
          const T x = __shfl_sync(kFull, v[q], j) * inv;
          const T upd = v[q] - l * x;
          v[q] = lane == j ? x : upd;
        }
        inv = inv_n;
        lji = lji_n;
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = warp + q * kWarps;
        if (c < nr && lane < us) X[lane * ldX + c] = v[q];
      }
      if (warp == 0) {  // dV += Qu . dU = -Qu . X[:, 0]
        T s = (lane < us) ? Qxu[xs + lane] * v[0] : T(0);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(kFull, s, off);
        if (lane == 0) dv -= s;
      }
    }
    __syncthreads();  // barrier 5

    // ---- stage 5: value update H = sym(Qxx + Qux^T K) as 2x2 block
    // pairs, G = Qx + Qux^T dU; outputs K = -X[:, 1:], dU = -X[:, 0].
    // Two neighbouring threads share a block pair, one for each half of
    // the us rows, and join their sums by a shuffle.
    {
      const int nb = cdiv(xs, 2), npair = nb * (nb + 1) / 2;
      const int hu = us / 2;
      for (int t = tid; t < 2 * npair + xs; t += kThreads) {
        if (t < 2 * npair) {
          int I, J;
          pair_blocks(t >> 1, I, J);
          const int l0 = (t & 1) ? hu : 0;
          T c[2][2], tr[2][2];
          pair_tn(c, tr, I, J, (t & 1) ? us - hu : hu, Qux + l0 * ldq, ldq,
                  X + l0 * ldX + 1, ldX);
          const unsigned pair_mask = 3u << (lane & ~1);
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              c[ii][jj] += __shfl_xor_sync(pair_mask, c[ii][jj], 1);
              tr[ii][jj] += __shfl_xor_sync(pair_mask, tr[ii][jj], 1);
            }
          if (t & 1) continue;
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int i = 2 * I + ii, j = 2 * J + jj;
              if (i >= xs || j >= xs || (I == J && j > i)) continue;
              const T h = T(0.5) * ((Qs[i * ldx + j] - c[ii][jj])
                                    + (Qs[j * ldx + i] - tr[ii][jj]));
              H[i * ldx + j] = h;
              H[j * ldx + i] = h;
            }
        } else {
          const int i = t - 2 * npair;
          T s = T(0);
          for (int l = 0; l < us; ++l) s += Qux[l * ldq + i] * X[l * ldX];
          const T g = Qxu[i] - s;
          G[i] = g;
          Gk[i] = g;
        }
      }
      for (int u = warp; u < us; u += kWarps)
        for (int j = lane; j < xs; j += 32) Kk[u * xs + j] = -X[u * ldX + 1 + j];
      for (int i = tid; i < us; i += kThreads) dUk[i] = -X[i * ldX];
    }
  }
  __syncthreads();
  store_rows(H_out + (size_t)b * N * xx, H, ldx, xs, warp, lane);
  if (tid == 0) {
    ok_out[b] = ok ? T(1) : T(0);
    dv_out[2 * b] = dv;
    dv_out[2 * b + 1] = -dv;
  }
}

template <typename T>
int launch_sweep(int batch, int N, int xs, int us, const T* A, const T* Bm,
                 const T* lx, const T* lu, const T* lxx, const T* luu,
                 const T* lux, const T* phixT, const T* phixxT,
                 const T* defect, const int* w, const T* reg, T* G, T* H,
                 T* K, T* dU, T* Qu, T* Quu, T* Qux, T* ok, T* dv,
                 cudaStream_t stream) {
  // bulk copies move rows of a multiple of 16 bytes from 16-byte aligned
  // operands
  const size_t addr = reinterpret_cast<size_t>(A) | reinterpret_cast<size_t>(Bm) |
                      reinterpret_cast<size_t>(lx) | reinterpret_cast<size_t>(lu) |
                      reinterpret_cast<size_t>(lxx) | reinterpret_cast<size_t>(luu) |
                      reinterpret_cast<size_t>(lux) | reinterpret_cast<size_t>(defect);
  if (xs < 1 || xs > kMaxXs || us < 1 || us > kMaxUs || N < 1 ||
      (xs * sizeof(T)) % 16 != 0 || (us * sizeof(T)) % 16 != 0 || addr % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = sweep_smem_bytes<T>(xs, us);
  // the right-hand sides' columns per warp, as a compile-time count
  auto kernel = (1 + xs <= 4 * kWarps) ? sweep_kernel<T, 4>
                                       : sweep_kernel<T, kMaxCols>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, stream>>>(
      N, xs, us, A, Bm, lx, lu, lxx, luu, lux, phixT, phixxT, defect, w, reg,
      G, H, K, dU, Qu, Quu, Qux, ok, dv);
  return (int)cudaGetLastError();
}

}  // namespace

#define CAFEMPC_SWEEP_ENTRY(NAME, T)                                        \
  extern "C" int NAME(int batch, int N, int xs, int us, const T* A,         \
                      const T* Bm, const T* lx, const T* lu, const T* lxx,  \
                      const T* luu, const T* lux, const T* phixT,           \
                      const T* phixxT, const T* defect, const int* w,       \
                      const T* reg, T* G, T* H, T* K, T* dU, T* Qu, T* Quu, \
                      T* Qux, T* ok, T* dv, void* stream) {                 \
    return launch_sweep<T>(batch, N, xs, us, A, Bm, lx, lu, lxx, luu, lux,  \
                           phixT, phixxT, defect, w, reg, G, H, K, dU, Qu,  \
                           Quu, Qux, ok, dv,                                \
                           static_cast<cudaStream_t>(stream));              \
  }

CAFEMPC_SWEEP_ENTRY(cafempc_sweep_f32, float)
CAFEMPC_SWEEP_ENTRY(cafempc_sweep_f64, double)
