// Fused HS-DDP Riccati backward sweep, one CTA per scenario.
//
// Replaces the TPU kernel cafempc_tpu/ops/fused_sweep.py::
// fused_backward_sweep (_sweep_kernel, pallas_call at fused_sweep.py:288).
// Semantics and shapes: see cafempc_tpu_torch/ops/sweep.py, whose
// sweep_reference is the plain PyTorch twin this kernel is tested against.
//
// What bounds it: the recursion is sequential in the N knots, so each
// scenario is one chain of small dense products (xs = us = 24 on the HKD
// path: six 24x24x24 products plus the Cholesky and its solves, ~0.2 MFLOP
// per knot) with a barrier between each dependent stage.  Per knot it
// reads 5 matrices from device memory and writes 4 back: at B = 256,
// N = 112 in f32 that is ~0.61 GB and ~5.7 GFLOP per sweep, 0.18 ms at the
// HBM rate and 0.09 ms at the f32 FMA peak, so the kernel is bound by the
// latency of the dependent chain, not by HBM bandwidth or FLOPs.  The
// longest links of that chain are the triangular solves (one thread per
// right-hand side, 24 dependent steps each way) and the column-by-column
// Cholesky (not yet timed stage by stage).  The design keeps everything
// the chain re-reads on chip: the (G, H) value carry and every per-knot
// block (A, B, H'A, H'B, the Q blocks, the Cholesky factor and the solve
// workspace) live in shared memory (28 KB in f32) for the whole walk, one
// thread per matrix entry computes the products, and the Cholesky goes
// column by column with __syncthreads() between columns.  B = 256 CTAs
// of 256 threads all fit at once on the 132 SMs, about two per SM.
//
// PSD rule (must match the Pallas kernel, not LAPACK): the pivot
// d_j = Quu_jj - 1e-9 - sum_k L_jk^2 is ok only if d_j > 0, and column j is
// scaled by rsqrt(max(d_j, 1e-30)), so L_jj = (Quu_jj - sum_k L_jk^2) *
// rsqrt(d_j).  Which scenarios are flagged drives the solver's
// regularization retries.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
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
  __shared__ int ok_step;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int xx = xs * xs, xu = xs * us, uu = us * us, nr = 1 + xs;
  T* G = sm;                 // [xs]      value gradient carry
  T* H = G + xs;             // [xs,xs]   value Hessian carry
  T* sA = H + xx;            // [xs,xs]   A_k
  T* sB = sA + xx;           // [xs,us]   B_k
  T* d = sB + xu;            // [xs]      defect_{k+1}
  T* Gn = d + xs;            // [xs]      G' + H' d
  T* HA = Gn + xs;           // [xs,xs]   H'^T A
  T* HB = HA + xx;           // [xs,us]   H'^T B
  T* Qx = HB + xu;           // [xs]
  T* Qxxb = Qx + xs;         // [xs,xs]   lxx + A^T H' A (before reg)
  T* Qxx = Qxxb + xx;        // [xs,xs]   regularized, symmetrized
  T* Qu = Qxx + xx;          // [us]
  T* Quu = Qu + us;          // [us,us]
  T* Qux = Quu + uu;         // [us,xs]
  T* L = Qux + xu;           // [us,us]   Cholesky factor (lower)
  T* X = L + uu;             // [nr,us]   solve workspace, one column per rhs
  T* Hd = X + nr * us;       // [xs,xs]   unsymmetrized H_dyn

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T r = reg[b];
  bool ok = true;
  T dv = T(0);

  for (int i = tid; i < xs; i += nt) G[i] = phixT[(size_t)b * xs + i];
  for (int e = tid; e < xx; e += nt) H[e] = phixxT[(size_t)b * xx + e];

  for (int k = N - 1; k >= 0; --k) {
    const size_t bk = (size_t)b * N + k;
    const bool wk = w[k] > 0;
    const T* Ak = A + bk * xx;
    const T* Bk = Bm + bk * xu;
    const T* dk = defect + ((size_t)b * (N + 1) + k + 1) * xs;
    for (int e = tid; e < xx; e += nt) sA[e] = Ak[e];
    for (int e = tid; e < xu; e += nt) sB[e] = Bk[e];
    for (int i = tid; i < xs; i += nt) d[i] = dk[i];
    if (tid == 0) ok_step = 1;
    __syncthreads();

    // defect-corrected gradient and the H' products
    for (int i = tid; i < xs; i += nt) {
      T s = G[i];
      for (int j = 0; j < xs; ++j) s += H[i * xs + j] * d[j];
      Gn[i] = s;
    }
    for (int e = tid; e < xx; e += nt) {
      const int i = e / xs, j = e % xs;
      T s = T(0);
      for (int l = 0; l < xs; ++l) s += H[l * xs + i] * sA[l * xs + j];
      HA[e] = s;
    }
    if (!wk) {
      for (int e = tid; e < xu; e += nt) {
        const int i = e / us, j = e % us;
        T s = T(0);
        for (int l = 0; l < xs; ++l) s += H[l * xs + i] * sB[l * us + j];
        HB[e] = s;
      }
    }
    __syncthreads();

    // Q-expansion; its base (before reg) is the transform-step update
    const T* lxk = lx + bk * xs;
    const T* lxxk = lxx + bk * xx;
    for (int i = tid; i < xs; i += nt) {
      T s = lxk[i];
      for (int l = 0; l < xs; ++l) s += sA[l * xs + i] * Gn[l];
      Qx[i] = s;
    }
    for (int e = tid; e < xx; e += nt) {
      const int i = e / xs, j = e % xs;
      T s = lxxk[e];
      for (int l = 0; l < xs; ++l) s += sA[l * xs + i] * HA[l * xs + j];
      Qxxb[e] = s;
    }
    if (!wk) {
      const T* luk = lu + bk * us;
      const T* luuk = luu + bk * uu;
      const T* luxk = lux + bk * xu;
      for (int i = tid; i < us; i += nt) {
        T s = luk[i];
        for (int l = 0; l < xs; ++l) s += sB[l * us + i] * Gn[l];
        Qu[i] = s;
      }
      for (int e = tid; e < uu; e += nt) {
        const int i = e / us, j = e % us;
        T s = luuk[e];
        for (int l = 0; l < xs; ++l) s += sB[l * us + i] * HB[l * us + j];
        Quu[e] = s + (i == j ? r : T(0));
      }
      for (int e = tid; e < xu; e += nt) {
        const int i = e / xs, j = e % xs;
        T s = luxk[e];
        for (int l = 0; l < xs; ++l) s += sB[l * us + i] * HA[l * xs + j];
        Qux[e] = s;
      }
    }
    __syncthreads();

    T* Gk = G_out + bk * xs;
    T* Hk = H_out + bk * xx;
    T* Kk = K_out + bk * xu;
    T* dUk = dU_out + bk * us;
    T* Quk = Qu_out + bk * us;
    T* Quuk = Quu_out + bk * uu;
    T* Quxk = Qux_out + bk * xu;

    if (wk) {
      // transform step: G = phix + A^T Gn, H = phixx + A^T H' A
      for (int i = tid; i < xs; i += nt) { G[i] = Qx[i]; Gk[i] = Qx[i]; }
      for (int e = tid; e < xx; e += nt) { H[e] = Qxxb[e]; Hk[e] = Qxxb[e]; }
      for (int e = tid; e < xu; e += nt) { Kk[e] = T(0); Quxk[e] = T(0); }
      for (int i = tid; i < us; i += nt) { dUk[i] = T(0); Quk[i] = T(0); }
      for (int e = tid; e < uu; e += nt)
        Quuk[e] = (e / us == e % us) ? T(1) : T(0);
      __syncthreads();
      continue;
    }

    for (int e = tid; e < xx; e += nt) {
      const int i = e / xs, j = e % xs;
      const T dg = (i == j) ? r : T(0);
      Qxx[e] = T(0.5) * ((Qxxb[e] + dg) + (Qxxb[j * xs + i] + dg));
    }

    // Cholesky of Quu, column by column (lower triangle of Quu is read)
    for (int j = 0; j < us; ++j) {
      for (int i = j + tid; i < us; i += nt) {
        T dd = Quu[j * us + j] - T(1e-9);
        T v = Quu[i * us + j];
        for (int m = 0; m < j; ++m) {
          dd -= L[j * us + m] * L[j * us + m];
          v -= L[i * us + m] * L[j * us + m];
        }
        if (i == j && !(dd > T(0))) ok_step = 0;
        L[i * us + j] = v * rsqrt_t(dd > T(1e-30) ? dd : T(1e-30));
      }
      __syncthreads();
    }

    // (L L^T) X = [Qu | Qux]: one thread per right-hand side column
    for (int c = tid; c < nr; c += nt) {
      T* x = X + c * us;
      for (int i = 0; i < us; ++i) {
        T v = (c == 0) ? Qu[i] : Qux[i * xs + (c - 1)];
        for (int m = 0; m < i; ++m) v -= L[i * us + m] * x[m];
        x[i] = v / L[i * us + i];
      }
      for (int i = us - 1; i >= 0; --i) {
        T v = x[i];
        for (int m = i + 1; m < us; ++m) v -= L[m * us + i] * x[m];
        x[i] = v / L[i * us + i];
      }
    }
    __syncthreads();

    // gains dU = -X[:,0], K = -X[:,1:]; value update; outputs
    for (int i = tid; i < xs; i += nt) {
      T s = Qx[i];
      for (int j = 0; j < us; ++j) s -= Qux[j * xs + i] * X[j];
      G[i] = s;
      Gk[i] = s;
    }
    for (int e = tid; e < xx; e += nt) {
      const int i = e / xs, j = e % xs;
      T s = Qxx[e];
      const T* Kc = X + (1 + j) * us;
      for (int l = 0; l < us; ++l) s -= Qux[l * xs + i] * Kc[l];
      Hd[e] = s;
    }
    for (int e = tid; e < xu; e += nt) {
      const int i = e / xs, j = e % xs;
      Kk[e] = -X[(1 + j) * us + i];
      Quxk[e] = Qux[e];
    }
    for (int i = tid; i < us; i += nt) { dUk[i] = -X[i]; Quk[i] = Qu[i]; }
    for (int e = tid; e < uu; e += nt) Quuk[e] = Quu[e];
    if (tid == 0) {
      T s = T(0);
      for (int i = 0; i < us; ++i) s -= Qu[i] * X[i];
      dv += s;
      ok = ok && (ok_step != 0);
    }
    __syncthreads();
    for (int e = tid; e < xx; e += nt) {
      const int i = e / xs, j = e % xs;
      const T h = T(0.5) * (Hd[e] + Hd[j * xs + i]);
      H[e] = h;
      Hk[e] = h;
    }
    __syncthreads();
  }
  if (tid == 0) {
    ok_out[b] = ok ? T(1) : T(0);
    dv_out[2 * b] = dv;
    dv_out[2 * b + 1] = -dv;
  }
}

template <typename T>
size_t sweep_smem_bytes(int xs, int us) {
  const size_t xx = (size_t)xs * xs, xu = (size_t)xs * us,
               uu = (size_t)us * us;
  return sizeof(T) * (4 * (size_t)xs + 6 * xx + 3 * xu + 2 * uu + us +
                      (size_t)(1 + xs) * us);
}

template <typename T>
int launch_sweep(int batch, int N, int xs, int us, const T* A, const T* Bm,
                 const T* lx, const T* lu, const T* lxx, const T* luu,
                 const T* lux, const T* phixT, const T* phixxT,
                 const T* defect, const int* w, const T* reg, T* G, T* H,
                 T* K, T* dU, T* Qu, T* Quu, T* Qux, T* ok, T* dv,
                 cudaStream_t stream) {
  if (batch == 0) return 0;
  const size_t smem = sweep_smem_bytes<T>(xs, us);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<T><<<batch, kThreads, smem, stream>>>(
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
