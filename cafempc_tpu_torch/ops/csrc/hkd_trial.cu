// Fused HKD line-search trial: one CTA per scenario, four lanes per knot
// (one per leg).
//
// Replaces the TPU kernel cafempc_tpu/ops/fused_hkd_trial.py::
// fused_hkd_trial (_trial_kernel, pallas_call at fused_hkd_trial.py:416).
// Semantics and shapes: see cafempc_tpu_torch/ops/hkd_trial.py, whose
// hkd_trial_reference is the plain PyTorch twin this kernel is tested
// against.
//
// The Pallas kernel walks the knots in order and carries the simulated
// state from knot to knot.  That carry is a one-knot shift:
// Xsim[k+1] = step(X[k], U[k]) with X[k] = Xbar[k] + eps dX[k] known
// before the kernel starts, so here every knot is independent.  What
// bounds it: per scenario ~113 knots of a few thousand instructions of
// model math (a dozen sine / cosine pairs and 20 barrier logarithms per
// knot) and ~200 values of reads and writes per knot; at B = 256 that is
// ~60 MB of traffic in f32 (~0.01 ms of HBM bandwidth), so the kernel is
// bound by the latency of its per-knot chain in its one wave of 256 CTAs.
// The design shortens the chain and feeds it more warps:
//   * the CTA stages its scenario's X = Xbar + eps dX and U = Ubar +
//     eps dUK in shared memory with coalesced 16-byte loads (and writes X
//     and U out in the same pass), so knot k reads X[k-1], U[k-1] there;
//   * four lanes per knot, lane l owning leg l: its six state components
//     (3l..3l+2 and the leg's qdummy 12+3l..14+3l) of Xsim, the defect and
//     the tracking sums, its foot-placement terms, its 5 friction facets
//     with their barrier logs, and its leg's FK and touchdown height; the
//     step of knot k-1 needs the whole state and all four forces, and its
//     lanes compute that common part side by side;
//   * Xsim goes to shared memory and leaves, with the defect, by coalesced
//     16-byte stores after one block barrier;
//   * the seven per-scenario sums and extrema are warp shuffles, then one
//     shared-memory step across the warps.
// A 512-thread CTA covers 128 knots; longer plans stride over the knots.
// The extrema keep the reference's comparisons (x > m ? x : m), which drop
// a NaN, so a blown-up trial's NaN never hides in maxp, maxt or the norm.
#include <cuda_runtime.h>

#include "hkd_common.cuh"

namespace {

using namespace hkd;

constexpr int MAX_THREADS = 512;
constexpr int NRED = 7;   // reduced values per scenario
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a CTA can have

// The state component that lane `leg` of a knot owns as its m-th (m < 6).
__device__ __forceinline__ int owned(int leg, int m) {
  return m < 3 ? 3 * leg + m : 9 + 3 * leg + m;
}

// The lane's six components of one HKD step of table row `row` from state
// x and control u: the forward Euler dynamics (models/hkd.py::dynamics) or,
// on a reset step, the reset map with the row's touchdown / lift-off masks
// (reset_map_td_lo).
template <typename T>
__device__ void hkd_step(const T* x, const T* u, const T* row, int leg,
                         T xn[6]) {
  const T* eul = x;
  const T* pos = x + 3;
  const T* om = x + 6;
  const T* qd = x + 12;
  T sy, cy, sp, cp, sr, cr;
  sin_cos(eul[0], &sy, &cy);
  sin_cos(eul[1], &sp, &cp);
  sin_cos(eul[2], &sr, &cr);
  T R[3][3], dRy[3][3], dRp[3][3], dRr[3][3];
  rot_derivs(sy, cy, sp, cp, sr, cr, R, dRy, dRp, dRr);
  if (row[col::RESET] > T(0)) {
    for (int m = 0; m < 3; ++m) xn[m] = x[3 * leg + m];
    T p[3];
    leg_fk<T>(leg, qd + 3 * leg, p, nullptr);
    const T td = row[col::TD4 + leg], lo = row[col::LO4 + leg];
    const T keep = T(1) - td - lo;
    for (int i = 0; i < 3; ++i) {
      const T pf = i < 2 ? pos[i] + (R[i][0] * p[0] + R[i][1] * p[1]
                                     + R[i][2] * p[2])
                         : T(0);
      xn[3 + i] = td * pf + lo * T(qleg_default(i)) + keep * qd[3 * leg + i];
    }
    return;
  }
  const T dt = row[col::DT];
  T f[4][3], ftot[3] = {T(0), T(0), T(0)}, tau[3] = {T(0), T(0), T(0)};
  for (int l = 0; l < 4; ++l) {
    for (int i = 0; i < 3; ++i) {
      f[l][i] = u[3 * l + i] * row[col::C3 + 3 * l + i];
      ftot[i] += f[l][i];
    }
    // torque arm with the foot height zeroed (feet on the ground plane)
    const T arm[3] = {qd[3 * l] - pos[0], qd[3 * l + 1] - pos[1], -pos[2]};
    tau[0] += arm[1] * f[l][2] - arm[2] * f[l][1];
    tau[1] += arm[2] * f[l][0] - arm[0] * f[l][2];
    tau[2] += arm[0] * f[l][1] - arm[1] * f[l][0];
  }
  T Iw[3], xdot[12];
  for (int i = 0; i < 3; ++i) Iw[i] = T(inertia(i)) * om[i];
  const T wxIw[3] = {om[1] * Iw[2] - om[2] * Iw[1],
                     om[2] * Iw[0] - om[0] * Iw[2],
                     om[0] * Iw[1] - om[1] * Iw[0]};
  xdot[0] = sr / cp * om[1] + cr / cp * om[2];
  xdot[1] = cr * om[1] - sr * om[2];
  xdot[2] = om[0] + sp * sr / cp * om[1] + sp * cr / cp * om[2];
  for (int i = 0; i < 3; ++i) {
    xdot[3 + i] = x[9 + i];
    const T tau_b = R[0][i] * tau[0] + R[1][i] * tau[1] + R[2][i] * tau[2];
    xdot[6 + i] = (tau_b - wxIw[i]) / T(inertia(i));
    xdot[9 + i] = ftot[i] / T(MASS) + (i == 2 ? -T(GRAVITY) : T(0));
  }
  // the lane's three of the first twelve (selects, so xdot stays in
  // registers), then its leg's three swing-foot components
  for (int m = 0; m < 3; ++m) {
    const T d = leg == 0 ? xdot[m]
                         : (leg == 1 ? xdot[3 + m]
                                     : (leg == 2 ? xdot[6 + m] : xdot[9 + m]));
    xn[m] = x[3 * leg + m] + dt * d;
  }
  for (int m = 0; m < 3; ++m) {
    const int j = 3 * leg + m;
    xn[3 + m] = x[12 + j] + dt * (u[12 + j] * row[col::SWING3 + j]);
  }
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return b > a ? b : a; }

// v[0..2] summed, v[3] and v[5] min, v[4] and v[6] max over the warp
template <typename T>
__device__ __forceinline__ void warp_reduce(T v[NRED]) {
  for (int off = 16; off > 0; off >>= 1) {
    T o[NRED];
    for (int q = 0; q < NRED; ++q)
      o[q] = __shfl_xor_sync(0xffffffffu, v[q], off);
    for (int q = 0; q < 3; ++q) v[q] += o[q];
    v[3] = tmin(v[3], o[3]);   // maxp
    v[4] = tmax(v[4], o[4]);   // maxt
    v[5] = tmin(v[5], o[5]);   // finite flag
    v[6] = tmax(v[6], o[6]);   // max state norm
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2) hkd_trial_kernel(
    int N, T mu, const T* __restrict__ eps, const T* __restrict__ x0,
    const T* __restrict__ Xbar, const T* __restrict__ dX,
    const T* __restrict__ Ubar, const T* __restrict__ dUK,
    const T* __restrict__ reb_delta, const T* __restrict__ reb_eps,
    const T* __restrict__ reb_act, const T* __restrict__ al_lam,
    const T* __restrict__ al_sig, const T* __restrict__ al_act,
    const T* __restrict__ table, T* __restrict__ X_out,
    T* __restrict__ U_out, T* __restrict__ Xsim_out,
    T* __restrict__ Defect_out, T* __restrict__ g_out,
    T* __restrict__ h_out, T* __restrict__ cq_out, T* __restrict__ cost_out,
    T* __restrict__ feas_out, T* __restrict__ maxp_out,
    T* __restrict__ maxt_out, T* __restrict__ ok_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Pack<T>::N;
  const int NK = N + 1;
  T* sX = reinterpret_cast<T*>(smem_raw);   // [NK, 24]
  T* sU = sX + NK * 24;                      // [N, 24]
  T* sXsim = sU + N * 24;                    // [NK, 24]
  T* red = sXsim + NK * 24;                  // [warps, NRED]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const T e = eps[b];
  const size_t xo = (size_t)b * NK * 24, uo = (size_t)b * N * 24;

  // stage X and U (rows of 24 values: 16-byte multiples, 16-byte aligned)
  for (int i = t * V; i < NK * 24; i += nt * V) {
    const Pack<T> xb = Pack<T>::load(Xbar + xo + i);
    const Pack<T> dx = Pack<T>::load(dX + xo + i);
    Pack<T> xv;
    for (int m = 0; m < V; ++m) xv.a[m] = xb.a[m] + e * dx.a[m];
    xv.store(sX + i);
    xv.store(X_out + xo + i);
  }
  for (int i = t * V; i < N * 24; i += nt * V) {
    const Pack<T> ub = Pack<T>::load(Ubar + uo + i);
    const Pack<T> du = Pack<T>::load(dUK + uo + i);
    Pack<T> uv;
    for (int m = 0; m < V; ++m) uv.a[m] = ub.a[m] + e * du.a[m];
    uv.store(sU + i);
    uv.store(U_out + uo + i);
  }
  __syncthreads();

  // per-lane partials: cq, penalty cost, maxp (min), maxt (max), finite
  // flag (min), max state norm (max)
  T cq = T(0), pen = T(0), maxp = T(0), maxt = T(0), fin = T(1), m2 = T(0);
  const int leg = t & 3;
  const unsigned group = 0xfu << (t & 28);   // the knot's four lanes
  for (int k = t >> 2; k < NK; k += nt >> 2) {
    const T* row = table + (size_t)k * col::NCOLS;
    const T* xk = sX + k * 24;
    // Xsim[k]: x0 at k = 0, else the step of knot k-1 if that step is
    // active, else X[k] (selects, so a non-finite step never leaks)
    T xs[6];
    if (k == 0) {
      for (int m = 0; m < 6; ++m) xs[m] = x0[(size_t)b * 24 + owned(leg, m)];
    } else if (row[col::PREV_ACT] > T(0)) {
      hkd_step(sX + (k - 1) * 24, sU + (k - 1) * 24, row - col::NCOLS, leg,
               xs);
    } else {
      for (int m = 0; m < 6; ++m) xs[m] = xk[owned(leg, m)];
    }
    T s2 = T(0);
    for (int m = 0; m < 6; ++m) {
      sXsim[k * 24 + owned(leg, m)] = xs[m];
      if (!isfinite(xs[m])) fin = T(0);
      s2 += xs[m] * xs[m];
    }
    s2 += __shfl_xor_sync(group, s2, 1);
    s2 += __shfl_xor_sync(group, s2, 2);
    const T nrm = row[col::KACT] * s2;
    m2 = nrm > m2 ? nrm : m2;

    // the leg's feet relative to the CoM
    T prel[3];
    for (int m = 0; m < 3; ++m) prel[m] = xk[12 + 3 * leg + m] - xk[3 + m];

    if (k < N) {
      // running cost (masked by run_m dt) and the ReB friction penalty
      const T* uk = sU + k * 24;
      const size_t bu = (size_t)b * N + k;
      const T run = row[col::RUN], dt = row[col::DT];
      T l = T(0), lu = T(0), lf = T(0);
      for (int m = 0; m < 6; ++m) {
        const int i = owned(leg, m);
        const T dx = xk[i] - row[col::XREF_S + i];
        const T du = uk[i] - row[col::UREF_S + i];
        l += row[col::QW + i] * dx * dx;
        lu += row[col::RW + i] * du * du;
      }
      for (int m = 0; m < 3; ++m) {
        const int j = 3 * leg + m;
        const T d = prel[m] - row[col::PRELREF_R + j];
        lf += row[col::QFOOT_R + j] * d * d;
      }
      cq += run * dt * (T(0.5) * l + T(0.5) * lu + T(0.5) * lf);
      T g[5], reb = T(0);
      facets(uk + 3 * leg, mu, g);
      for (int f = 0; f < 5; ++f) {
        const size_t i = bu * 20 + 5 * leg + f;
        g_out[i] = g[f];
        if (reb_act[i] > T(0)) {
          const T delta = reb_delta[i];
          const T barr =
              g[f] > delta
                  ? -log(g[f])
                  : T(0.5) * ((g[f] - T(2) * delta) / delta
                                  * ((g[f] - T(2) * delta) / delta)
                              - T(1))
                        - log(delta);
          reb += reb_eps[i] * barr;
          if (run > T(0)) maxp = g[f] < maxp ? g[f] : maxp;
        }
      }
      pen += run * dt * reb;
    }

    // terminal cost and the AL touchdown-height penalty (masked by term_m)
    const T term = row[col::TERM];
    T phi = T(0), phf = T(0);
    for (int m = 0; m < 6; ++m) {
      const int i = owned(leg, m);
      const T d = xk[i] - row[col::XREF_K + i];
      phi += row[col::QF_T + i] * d * d;
    }
    for (int m = 0; m < 3; ++m) {
      const int j = 3 * leg + m;
      const T d = prel[m] - row[col::PRELREF_T + j];
      phf += row[col::QFOOT_T + j] * d * d;
    }
    cq += term * (T(0.5) * phi + T(10) * phf);
    T sp, cp, sr, cr;
    sin_cos(xk[1], &sp, &cp);
    sin_cos(xk[2], &sr, &cr);
    const T r2[3] = {-sp, cp * sr, cp * cr};
    T p[3];
    leg_fk<T>(leg, xk + 12 + 3 * leg, p, nullptr);
    const T h = xk[5] + (r2[0] * p[0] + r2[1] * p[1] + r2[2] * p[2]);
    const size_t i = ((size_t)b * NK + k) * 4 + leg;
    h_out[i] = h;
    if (al_act[i] > T(0)) {
      pen += term * (T(0.5) * al_sig[i] * h * h + al_lam[i] * h);
      const T ah = fabs(h);
      if (term > T(0)) maxt = ah > maxt ? ah : maxt;
    }
  }
  __syncthreads();

  // Xsim and the defect out, and the sum of squared defects
  T feas = T(0);
  for (int i = t * V; i < NK * 24; i += nt * V) {
    const T kact = table[(size_t)(i / 24) * col::NCOLS + col::KACT];
    const Pack<T> xs = Pack<T>::load(sXsim + i);
    const Pack<T> xv = Pack<T>::load(sX + i);
    Pack<T> d;
    for (int m = 0; m < V; ++m) {
      d.a[m] = kact * (xs.a[m] - xv.a[m]);
      feas += d.a[m] * d.a[m];
    }
    xs.store(Xsim_out + xo + i);
    d.store(Defect_out + xo + i);
  }

  T v[NRED] = {cq, pen, feas, maxp, maxt, fin, m2};
  warp_reduce(v);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0)
    for (int q = 0; q < NRED; ++q) red[warp * NRED + q] = v[q];
  __syncthreads();
  if (warp == 0) {
    const T idle[NRED] = {T(0), T(0), T(0), T(0), T(0), T(1), T(0)};
    for (int q = 0; q < NRED; ++q)
      v[q] = lane < nt / 32 ? red[lane * NRED + q] : idle[q];
    warp_reduce(v);
    if (lane == 0) {
      cq_out[b] = v[0];
      cost_out[b] = v[0] + v[1];
      feas_out[b] = sqrt(v[2]);
      maxp_out[b] = v[3];
      maxt_out[b] = v[4];
      ok_out[b] = (v[5] > T(0.5) && v[6] < T(1e12)) ? T(1) : T(0);
    }
  }
}

// Dynamic shared memory of one CTA: X, U, Xsim and the reduction scratch.
template <typename T>
size_t trial_smem(int N, int threads) {
  return (size_t)(2 * (N + 1) * 24 + N * 24 + threads / 32 * NRED)
         * sizeof(T);
}

template <typename T>
int launch_hkd_trial(int batch, int N, double mu, const T* const* in,
                     T* const* out, cudaStream_t stream) {
  if (batch == 0) return 0;
  // four lanes per knot, whole warps, at most 512 (longer plans stride)
  const int threads = ((4 * (N + 1) + 31) / 32 * 32) < MAX_THREADS
                          ? (4 * (N + 1) + 31) / 32 * 32
                          : MAX_THREADS;
  const size_t smem = trial_smem<T>(N, threads);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in: once per
  // instantiation and device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(hkd_trial_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  hkd_trial_kernel<T><<<batch, threads, smem, stream>>>(
      N, T(mu), in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
      in[8], in[9], in[10], in[11], in[12], out[0], out[1], out[2], out[3],
      out[4], out[5], out[6], out[7], out[8], out[9], out[10], out[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// Operands, all contiguous: eps [B], x0 [B,24], Xbar, dX [B,N+1,24],
// Ubar, dUK [B,N,24], reb_delta, reb_eps, reb_act [B,N,20], al_lam,
// al_sig, al_act [B,N+1,4], table [N+1,NCOLS]; outputs X, Xsim, Defect
// [B,N+1,24], U [B,N,24], g [B,N,20], h [B,N+1,4], cq, cost, feas, maxp,
// maxt, ok [B].  Xbar, dX, Ubar, dUK and X, U, Xsim, Defect must start on
// a 16-byte boundary.
#define HKD_TRIAL_ENTRY(NAME, T)                                            \
  extern "C" int NAME(int batch, int N, double mu, const T* eps,           \
                      const T* x0, const T* Xbar, const T* dX,              \
                      const T* Ubar, const T* dUK, const T* reb_delta,      \
                      const T* reb_eps, const T* reb_act, const T* al_lam,  \
                      const T* al_sig, const T* al_act, const T* table,     \
                      T* X, T* U, T* Xsim, T* Defect, T* g, T* h, T* cq,    \
                      T* cost, T* feas, T* maxp, T* maxt, T* ok,            \
                      void* stream) {                                       \
    const T* in[13] = {eps,     x0,      Xbar,   dX,     Ubar,              \
                       dUK,     reb_delta, reb_eps, reb_act, al_lam,        \
                       al_sig,  al_act,  table};                            \
    T* out[12] = {X, U, Xsim, Defect, g, h, cq, cost, feas, maxp, maxt, ok}; \
    return launch_hkd_trial<T>(batch, N, mu, in, out,                       \
                               static_cast<cudaStream_t>(stream));          \
  }

HKD_TRIAL_ENTRY(cafempc_hkd_trial_f32, float)
HKD_TRIAL_ENTRY(cafempc_hkd_trial_f64, double)
