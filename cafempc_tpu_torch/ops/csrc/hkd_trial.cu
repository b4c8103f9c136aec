// Fused HKD line-search trial: one CTA per scenario, one thread per knot.
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
// before the kernel starts, so here every knot is independent: thread k
// recomputes X[k-1], U[k-1] and steps them.  What bounds it: per scenario
// ~113 knots of ~1 kFLOP of model math and ~200 values of reads and
// writes; at B = 256 that is ~60 MB of traffic in f32 and the kernel is
// bound by the latency of its one wave of 256 CTAs.  Per-scenario sums
// and extrema are block reductions in shared memory.
#include <cuda_runtime.h>

#include "hkd_common.cuh"

namespace {

using namespace hkd;

// One HKD step of table row `row` from state x and control u: the forward
// Euler dynamics (models/hkd.py::dynamics) or, on a reset step, the reset
// map with the row's touchdown / lift-off masks (reset_map_td_lo).
template <typename T>
__device__ void hkd_step(const T* x, const T* u, const T* row, T* xn) {
  const T* eul = x;
  const T* pos = x + 3;
  const T* om = x + 6;
  const T* qd = x + 12;
  T R[3][3], dRy[3][3], dRp[3][3], dRr[3][3];
  rot_derivs(eul, R, dRy, dRp, dRr);
  if (row[col::RESET] > T(0)) {
    for (int i = 0; i < 12; ++i) xn[i] = x[i];
    for (int l = 0; l < 4; ++l) {
      T p[3];
      leg_fk<T>(l, qd + 3 * l, p, nullptr);
      const T td = row[col::TD4 + l], lo = row[col::LO4 + l];
      const T keep = T(1) - td - lo;
      for (int i = 0; i < 3; ++i) {
        const T pf = i < 2 ? pos[i] + (R[i][0] * p[0] + R[i][1] * p[1]
                                       + R[i][2] * p[2])
                           : T(0);
        xn[12 + 3 * l + i] = td * pf + lo * T(qleg_default(i))
                             + keep * qd[3 * l + i];
      }
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
  T Iw[3], xdot[24];
  for (int i = 0; i < 3; ++i) Iw[i] = T(inertia(i)) * om[i];
  const T wxIw[3] = {om[1] * Iw[2] - om[2] * Iw[1],
                     om[2] * Iw[0] - om[0] * Iw[2],
                     om[0] * Iw[1] - om[1] * Iw[0]};
  const T sp = sin(eul[1]), cp = cos(eul[1]);
  const T sr = sin(eul[2]), cr = cos(eul[2]);
  xdot[0] = sr / cp * om[1] + cr / cp * om[2];
  xdot[1] = cr * om[1] - sr * om[2];
  xdot[2] = om[0] + sp * sr / cp * om[1] + sp * cr / cp * om[2];
  for (int i = 0; i < 3; ++i) {
    xdot[3 + i] = x[9 + i];
    const T tau_b = R[0][i] * tau[0] + R[1][i] * tau[1] + R[2][i] * tau[2];
    xdot[6 + i] = (tau_b - wxIw[i]) / T(inertia(i));
    xdot[9 + i] = ftot[i] / T(MASS) + (i == 2 ? -T(GRAVITY) : T(0));
  }
  for (int j = 0; j < 12; ++j) xdot[12 + j] = u[12 + j] * row[col::SWING3 + j];
  for (int i = 0; i < 24; ++i) xn[i] = x[i] + dt * xdot[i];
}

template <typename T>
__global__ void hkd_trial_kernel(
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
  // 7 per-thread partials: cq, penalty cost, sum of squared defects,
  // maxp (min), maxt (max), finite flag (min), max state norm (max)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const int NK = N + 1;
  const int b = blockIdx.x;
  const T e = eps[b];
  T cq = T(0), pen = T(0), feas = T(0), maxp = T(0), maxt = T(0),
    fin = T(1), m2 = T(0);

  for (int k = threadIdx.x; k < NK; k += blockDim.x) {
    const T* row = table + (size_t)k * col::NCOLS;
    const size_t bk = (size_t)b * NK + k;
    T xk[24], uk[24], xsim[24];
    for (int i = 0; i < 24; ++i) {
      xk[i] = Xbar[bk * 24 + i] + e * dX[bk * 24 + i];
      X_out[bk * 24 + i] = xk[i];
    }
    // Xsim[k]: x0 at k = 0, else the step of knot k-1 if that step is
    // active, else X[k] (selects, so a non-finite step never leaks)
    if (k == 0) {
      for (int i = 0; i < 24; ++i) xsim[i] = x0[(size_t)b * 24 + i];
    } else if (row[col::PREV_ACT] > T(0)) {
      const size_t bp = (size_t)b * NK + (k - 1);
      const size_t bu = (size_t)b * N + (k - 1);
      T xp[24], up[24];
      for (int i = 0; i < 24; ++i) {
        xp[i] = Xbar[bp * 24 + i] + e * dX[bp * 24 + i];
        up[i] = Ubar[bu * 24 + i] + e * dUK[bu * 24 + i];
      }
      hkd_step(xp, up, row - col::NCOLS, xsim);
    } else {
      for (int i = 0; i < 24; ++i) xsim[i] = xk[i];
    }
    const T kact = row[col::KACT];
    T nrm = T(0);
    for (int i = 0; i < 24; ++i) {
      const T d = kact * (xsim[i] - xk[i]);
      Xsim_out[bk * 24 + i] = xsim[i];
      Defect_out[bk * 24 + i] = d;
      feas += d * d;
      if (!isfinite(xsim[i])) fin = T(0);
      nrm += xsim[i] * xsim[i];
    }
    nrm = kact * nrm;
    m2 = nrm > m2 ? nrm : m2;

    // foot positions relative to the CoM
    T prel[12];
    for (int j = 0; j < 12; ++j) prel[j] = xk[12 + j] - xk[3 + j % 3];

    if (k < N) {
      // running cost (masked by run_m dt) and the ReB friction penalty
      const size_t bu = (size_t)b * N + k;
      const T run = row[col::RUN], dt = row[col::DT];
      T l = T(0), lu = T(0), lf = T(0);
      for (int i = 0; i < 24; ++i) {
        uk[i] = Ubar[bu * 24 + i] + e * dUK[bu * 24 + i];
        U_out[bu * 24 + i] = uk[i];
        const T dx = xk[i] - row[col::XREF_S + i];
        const T du = uk[i] - row[col::UREF_S + i];
        l += row[col::QW + i] * dx * dx;
        lu += row[col::RW + i] * du * du;
      }
      for (int j = 0; j < 12; ++j) {
        const T d = prel[j] - row[col::PRELREF_R + j];
        lf += row[col::QFOOT_R + j] * d * d;
      }
      cq += run * dt * (T(0.5) * l + T(0.5) * lu + T(0.5) * lf);
      T reb = T(0);
      for (int l4 = 0; l4 < 4; ++l4) {
        T g[5];
        facets(uk + 3 * l4, mu, g);
        for (int f = 0; f < 5; ++f) {
          const size_t i = bu * 20 + 5 * l4 + f;
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
      }
      pen += run * dt * reb;
    }

    // terminal cost and the AL touchdown-height penalty (masked by term_m)
    const T term = row[col::TERM];
    T phi = T(0), phf = T(0);
    for (int i = 0; i < 24; ++i) {
      const T d = xk[i] - row[col::XREF_K + i];
      phi += row[col::QF_T + i] * d * d;
    }
    for (int j = 0; j < 12; ++j) {
      const T d = prel[j] - row[col::PRELREF_T + j];
      phf += row[col::QFOOT_T + j] * d * d;
    }
    cq += term * (T(0.5) * phi + T(10) * phf);
    const T sp = sin(xk[1]), cp = cos(xk[1]);
    const T sr = sin(xk[2]), cr = cos(xk[2]);
    const T r2[3] = {-sp, cp * sr, cp * cr};
    T al = T(0);
    for (int l4 = 0; l4 < 4; ++l4) {
      T p[3];
      leg_fk<T>(l4, xk + 12 + 3 * l4, p, nullptr);
      const T h = xk[5] + (r2[0] * p[0] + r2[1] * p[1] + r2[2] * p[2]);
      const size_t i = bk * 4 + l4;
      h_out[i] = h;
      if (al_act[i] > T(0)) {
        al += T(0.5) * al_sig[i] * h * h + al_lam[i] * h;
        const T ah = fabs(h);
        if (term > T(0)) maxt = ah > maxt ? ah : maxt;
      }
    }
    pen += term * al;
  }

  const int nt = blockDim.x;
  const int t = threadIdx.x;
  T vals[7] = {cq, pen, feas, maxp, maxt, fin, m2};
  for (int q = 0; q < 7; ++q) red[q * nt + t] = vals[q];
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (t < s) {
      for (int q = 0; q < 3; ++q) red[q * nt + t] += red[q * nt + t + s];
      T* a = red + 3 * nt;  // maxp: min
      a[t] = a[t + s] < a[t] ? a[t + s] : a[t];
      a = red + 4 * nt;     // maxt: max
      a[t] = a[t + s] > a[t] ? a[t + s] : a[t];
      a = red + 5 * nt;     // finite flag: min
      a[t] = a[t + s] < a[t] ? a[t + s] : a[t];
      a = red + 6 * nt;     // max state norm: max
      a[t] = a[t + s] > a[t] ? a[t + s] : a[t];
    }
    __syncthreads();
  }
  if (t == 0) {
    cq_out[b] = red[0];
    cost_out[b] = red[0] + red[nt];
    feas_out[b] = sqrt(red[2 * nt]);
    maxp_out[b] = red[3 * nt];
    maxt_out[b] = red[4 * nt];
    ok_out[b] = (red[5 * nt] > T(0.5) && red[6 * nt] < T(1e12)) ? T(1) : T(0);
  }
}

template <typename T>
int launch_hkd_trial(int batch, int N, double mu, const T* const* in,
                     T* const* out, cudaStream_t stream) {
  if (batch == 0) return 0;
  // a power of two for the tree reduction; longer plans stride the knots
  int threads = 32;
  while (threads < N + 1 && threads < 512) threads *= 2;
  hkd_trial_kernel<T><<<batch, threads, 7 * threads * sizeof(T), stream>>>(
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
// maxt, ok [B].
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
