// Fused HKD LQ approximation: one warp per (scenario, knot).
//
// Replaces the TPU kernel cafempc_tpu/ops/fused_hkd_lq.py::fused_hkd_lq
// (_lq_kernel, pallas_call at fused_hkd_lq.py:521).  Semantics and shapes:
// see cafempc_tpu_torch/ops/hkd_lq.py, whose hkd_lq_reference is the plain
// PyTorch twin this kernel is tested against.
//
// There is no carry between knots (the Pallas grid walks k only to cut its
// blocks), so every (b, k) is independent.  What bounds it: output writes.
// Per knot it writes five dense 24 x 24 matrices and three 24-vectors; at
// B = 256, N = 112 that is ~85 M values (~340 MB in f32, ~0.1 ms of HBM
// bandwidth), against ~2 kFLOP of model math per knot.  The matrices are
// sparse (A is the identity plus ~60 entries), so the design never holds a
// dense matrix in registers: the warp zeroes five 24 x 24 tiles (+ their
// vectors) in shared memory, lanes 0-4 each scatter the nonzeros of one
// output (A; B; lxx, lx; luu, lu; phixx, phix), and the whole warp copies
// the tiles out with coalesced stores, applying each output's mask scale.
#include <cuda_runtime.h>

#include "hkd_common.cuh"

namespace {

using namespace hkd;

constexpr int TILE = 24 * 24 + 24;   // matrix + vector
constexpr int NTILES = 5;

// A: the dynamics Jacobian I + dt Fx (models/hkd.py::dynamics_partials),
// or on a reset step the reset-map Jacobian (reset_map_partial_td_lo).
template <typename T>
__device__ void fill_A(const T* x, const T* u, const T* row, T* A) {
  const T* eul = x;
  const T* pos = x + 3;
  const T* om = x + 6;
  const T* qd = x + 12;
  T R[3][3], dR[3][3][3];
  rot_derivs(eul, R, dR[0], dR[1], dR[2]);
  if (row[col::RESET] > T(0)) {
    for (int i = 0; i < 12; ++i) A[i * 24 + i] = T(1);
    for (int l = 0; l < 4; ++l) {
      T p[3], J[3][3];
      leg_fk(l, qd + 3 * l, p, J);
      const T td = row[col::TD4 + l], lo = row[col::LO4 + l];
      const T keep = T(1) - td - lo;
      const int r0 = 12 + 3 * l;
      for (int i = 0; i < 2; ++i) {   // the z row is masked
        T* Ar = A + (r0 + i) * 24;
        for (int e = 0; e < 3; ++e)
          Ar[e] = td * (dR[e][i][0] * p[0] + dR[e][i][1] * p[1]
                        + dR[e][i][2] * p[2]);
        Ar[3 + i] = td;
        for (int j = 0; j < 3; ++j)
          Ar[r0 + j] = td * (R[i][0] * J[0][j] + R[i][1] * J[1][j]
                             + R[i][2] * J[2][j]);
      }
      for (int i = 0; i < 3; ++i) A[(r0 + i) * 24 + r0 + i] += keep;
    }
    return;
  }
  const T dt = row[col::DT];
  const T sp = sin(eul[1]), cp = cos(eul[1]);
  const T sr = sin(eul[2]), cr = cos(eul[2]);
  const T cp2 = cp * cp;
  // Euler-rate rows: d(W omega)/d(pitch, roll) and W
  const T W[3][3] = {{T(0), sr / cp, cr / cp},
                     {T(0), cr, -sr},
                     {T(1), sp * sr / cp, sp * cr / cp}};
  const T dWp[3][3] = {{T(0), sr * sp / cp2, cr * sp / cp2},
                       {T(0), T(0), T(0)},
                       {T(0), sr / cp2, cr / cp2}};
  const T dWr[3][3] = {{T(0), cr / cp, -sr / cp},
                       {T(0), -sr, -cr},
                       {T(0), sp * cr / cp, -sp * sr / cp}};
  for (int i = 0; i < 3; ++i) {
    A[i * 24 + 1] = dt * (dWp[i][0] * om[0] + dWp[i][1] * om[1]
                          + dWp[i][2] * om[2]);
    A[i * 24 + 2] = dt * (dWr[i][0] * om[0] + dWr[i][1] * om[1]
                          + dWr[i][2] * om[2]);
    for (int j = 0; j < 3; ++j) A[i * 24 + 6 + j] = dt * W[i][j];
    A[(3 + i) * 24 + 9 + i] = dt;
  }
  // angular-acceleration rows
  T f[4][3], ftot[3] = {T(0), T(0), T(0)}, tau[3] = {T(0), T(0), T(0)};
  for (int l = 0; l < 4; ++l) {
    for (int i = 0; i < 3; ++i) {
      f[l][i] = u[3 * l + i] * row[col::C3 + 3 * l + i];
      ftot[i] += f[l][i];
    }
    const T arm[3] = {qd[3 * l] - pos[0], qd[3 * l + 1] - pos[1], -pos[2]};
    tau[0] += arm[1] * f[l][2] - arm[2] * f[l][1];
    tau[1] += arm[2] * f[l][0] - arm[0] * f[l][2];
    tau[2] += arm[0] * f[l][1] - arm[1] * f[l][0];
  }
  const T Iw[3] = {T(INERTIA0) * om[0], T(INERTIA1) * om[1],
                   T(INERTIA2) * om[2]};
  const T skIw[3][3] = {{T(0), -Iw[2], Iw[1]},
                        {Iw[2], T(0), -Iw[0]},
                        {-Iw[1], Iw[0], T(0)}};
  const T skw[3][3] = {{T(0), -om[2], om[1]},
                       {om[2], T(0), -om[0]},
                       {-om[1], om[0], T(0)}};
  const T skf[3][3] = {{T(0), -ftot[2], ftot[1]},
                       {ftot[2], T(0), -ftot[0]},
                       {-ftot[1], ftot[0], T(0)}};
  for (int i = 0; i < 3; ++i) {
    const T iinv = T(1) / T(inertia(i));
    T* Ar = A + (6 + i) * 24;
    for (int e = 0; e < 3; ++e)        // d/d(yaw, pitch, roll)
      Ar[e] = dt * (iinv * (dR[e][0][i] * tau[0] + dR[e][1][i] * tau[1]
                            + dR[e][2][i] * tau[2]));
    for (int j = 0; j < 3; ++j) {
      Ar[3 + j] = dt * (iinv * (R[0][i] * skf[0][j] + R[1][i] * skf[1][j]
                                + R[2][i] * skf[2][j]));
      Ar[6 + j] = dt * (iinv * (skIw[i][j] - skw[i][j] * T(inertia(j))));
    }
    for (int l = 0; l < 4; ++l) {
      const T sk[3][3] = {{T(0), -f[l][2], f[l][1]},
                          {f[l][2], T(0), -f[l][0]},
                          {-f[l][1], f[l][0], T(0)}};
      for (int j = 0; j < 2; ++j)      // the foot-height column is masked
        Ar[12 + 3 * l + j] =
            dt * (iinv * -(R[0][i] * sk[0][j] + R[1][i] * sk[1][j]
                           + R[2][i] * sk[2][j]));
    }
  }
  for (int i = 0; i < 24; ++i) A[i * 24 + i] += T(1);
}

// B = dt Fu, zero on a reset step.
template <typename T>
__device__ void fill_B(const T* x, const T* row, T* Bm) {
  if (row[col::RESET] > T(0)) return;
  const T dt = row[col::DT];
  const T* pos = x + 3;
  const T* qd = x + 12;
  T R[3][3], dR[3][3][3];
  rot_derivs(x, R, dR[0], dR[1], dR[2]);
  for (int l = 0; l < 4; ++l) {
    const T c = row[col::C3 + 3 * l];
    const T a[3] = {qd[3 * l] - pos[0], qd[3 * l + 1] - pos[1], -pos[2]};
    const T sk[3][3] = {{T(0), -a[2], a[1]},
                        {a[2], T(0), -a[0]},
                        {-a[1], a[0], T(0)}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Bm[(6 + i) * 24 + 3 * l + j] =
            dt * (T(1) / T(inertia(i))
                  * ((R[0][i] * sk[0][j] + R[1][i] * sk[1][j]
                      + R[2][i] * sk[2][j]) * c));
    for (int i = 0; i < 3; ++i)
      Bm[(9 + i) * 24 + 3 * l + i] = dt * (row[col::C3 + 3 * l + i]
                                           / T(MASS));
  }
  for (int j = 0; j < 12; ++j)
    Bm[(12 + j) * 24 + 12 + j] = dt * row[col::SWING3 + j];
}

// lxx, lx: state tracking plus the foot-placement regularization on the
// stance legs (HKDCost.h:8-100), before the run_m dt scale.
template <typename T>
__device__ void fill_lx(const T* x, const T* row, T* H, T* g) {
  for (int i = 0; i < 24; ++i) {
    g[i] = row[col::QW + i] * (x[i] - row[col::XREF_S + i]);
    H[i * 24 + i] = row[col::QW + i];
  }
  for (int j = 0; j < 12; ++j) {
    const int a = 3 + j % 3, q = 12 + j;
    const T c = row[col::C3 + j], w = row[col::QFOOT_R + j];
    const T d = (x[q] - x[a]) - row[col::PRELREF_R + j];
    const T v = c * (w * d);
    const T h = c * w * c;
    g[q] += v;
    g[a] -= v;
    H[q * 24 + q] += h;
    H[q * 24 + a] -= h;
    H[a * 24 + q] -= h;
    H[a * 24 + a] += h;
  }
}

// luu, lu: control tracking plus the Gauss-Newton terms of the ReB
// friction-pyramid barrier (constant facet Jacobian).
template <typename T>
__device__ void fill_lu(const T* u, const T* row, const T* delta,
                        const T* reps, const T* ract, T mu, T* H, T* g) {
  for (int i = 0; i < 24; ++i) {
    g[i] = row[col::RW + i] * (u[i] - row[col::UREF_S + i]);
    H[i * 24 + i] = row[col::RW + i];
  }
  for (int l = 0; l < 4; ++l) {
    T gv[5], w1[5], w2[5];
    facets(u + 3 * l, mu, gv);
    for (int f = 0; f < 5; ++f) {
      const int i = 5 * l + f;
      w1[f] = T(0);
      w2[f] = T(0);
      if (ract[i] > T(0)) {   // selects, so an inactive g never divides
        const T dl = delta[i];
        const T d1 = gv[f] > dl ? -T(1) / gv[f] : (gv[f] - T(2) * dl)
                                                      / (dl * dl);
        const T d2 = gv[f] > dl ? T(1) / (gv[f] * gv[f]) : T(1) / (dl * dl);
        w1[f] = reps[i] * d1;
        w2[f] = reps[i] * d2;
      }
    }
    const int x = 3 * l, y = x + 1, z = x + 2;
    g[x] += -w1[1] + w1[2];
    g[y] += -w1[3] + w1[4];
    g[z] += w1[0] + mu * (w1[1] + w1[2] + w1[3] + w1[4]);
    const T sxz = mu * (-w2[1] + w2[2]);
    const T syz = mu * (-w2[3] + w2[4]);
    H[x * 24 + x] += w2[1] + w2[2];
    H[y * 24 + y] += w2[3] + w2[4];
    H[z * 24 + z] += w2[0] + mu * mu * (w2[1] + w2[2] + w2[3] + w2[4]);
    H[x * 24 + z] += sxz;
    H[z * 24 + x] += sxz;
    H[y * 24 + z] += syz;
    H[z * 24 + y] += syz;
  }
}

// phixx, phix: terminal tracking, the terminal foot-placement term and the
// AL touchdown-height terms (HKDConstraints.cpp:68-160), before the
// term_m scale.
template <typename T>
__device__ void fill_phi(const T* x, const T* row, const T* lam,
                         const T* sig, const T* aact, T* H, T* g) {
  for (int i = 0; i < 24; ++i) {
    g[i] = row[col::QF_T + i] * (x[i] - row[col::XREF_K + i]);
    H[i * 24 + i] = row[col::QF_T + i];
  }
  for (int j = 0; j < 12; ++j) {
    const int a = 3 + j % 3, q = 12 + j;
    const T w = row[col::QFOOT_T + j];
    const T d = (x[q] - x[a]) - row[col::PRELREF_T + j];
    const T v = T(20) * (w * d), h = T(20) * w;
    g[q] += v;
    g[a] -= v;
    H[q * 24 + q] += h;
    H[q * 24 + a] -= h;
    H[a * 24 + q] -= h;
    H[a * 24 + a] += h;
  }
  T R[3][3], dR[3][3][3];
  rot_derivs(x, R, dR[0], dR[1], dR[2]);
  for (int l = 0; l < 4; ++l) {
    if (!(aact[l] > T(0))) continue;
    T p[3], J[3][3];
    leg_fk(l, x + 12 + 3 * l, p, J);
    const T h = x[5] + (R[2][0] * p[0] + R[2][1] * p[1] + R[2][2] * p[2]);
    const T gw = sig[l] * h + lam[l];
    const T hw = sig[l] * (T(1) + h) + lam[l];
    // the nonzero columns of dh/dx: pitch, roll, pos z, the leg's qdummy
    int c[6] = {1, 2, 5, 12 + 3 * l, 13 + 3 * l, 14 + 3 * l};
    T v[6];
    for (int e = 0; e < 2; ++e)
      v[e] = dR[e + 1][2][0] * p[0] + dR[e + 1][2][1] * p[1]
             + dR[e + 1][2][2] * p[2];
    v[2] = T(1);
    for (int j = 0; j < 3; ++j)
      v[3 + j] = R[2][0] * J[0][j] + R[2][1] * J[1][j] + R[2][2] * J[2][j];
    for (int a = 0; a < 6; ++a) {
      g[c[a]] += gw * v[a];
      for (int b = 0; b < 6; ++b) H[c[a] * 24 + c[b]] += hw * v[a] * v[b];
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_out(const T* tile, T scale, T* mat,
                                         T* vec, int lane) {
  for (int i = lane; i < 576; i += 32) mat[i] = tile[i] * scale;
  if (vec != nullptr)
    for (int i = lane; i < 24; i += 32) vec[i] = tile[576 + i] * scale;
}

template <typename T>
__global__ void __launch_bounds__(32) hkd_lq_kernel(
    int N, T mu, const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ reb_delta, const T* __restrict__ reb_eps,
    const T* __restrict__ reb_act, const T* __restrict__ al_lam,
    const T* __restrict__ al_sig, const T* __restrict__ al_act,
    const T* __restrict__ table, T* __restrict__ A, T* __restrict__ Bm,
    T* __restrict__ lx, T* __restrict__ lu, T* __restrict__ lxx,
    T* __restrict__ luu, T* __restrict__ phix, T* __restrict__ phixx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  const int NK = N + 1;
  const int b = blockIdx.x / NK;
  const int k = blockIdx.x % NK;
  const int lane = threadIdx.x;
  const bool step = k < N;
  for (int i = lane; i < NTILES * TILE; i += 32) tiles[i] = T(0);
  __syncwarp();

  const T* row = table + (size_t)k * col::NCOLS;
  const size_t bk = (size_t)b * NK + k;   // knot index
  const size_t bs = (size_t)b * N + k;    // step index (k < N)
  const T* x = X + bk * 24;
  if (step && lane == 0) fill_A(x, U + bs * 24, row, tiles);
  if (step && lane == 1) fill_B(x, row, tiles + TILE);
  if (step && lane == 2)
    fill_lx(x, row, tiles + 2 * TILE, tiles + 2 * TILE + 576);
  if (step && lane == 3)
    fill_lu(U + bs * 24, row, reb_delta + bs * 20, reb_eps + bs * 20,
            reb_act + bs * 20, mu, tiles + 3 * TILE, tiles + 3 * TILE + 576);
  if (lane == 4)
    fill_phi(x, row, al_lam + bk * 4, al_sig + bk * 4, al_act + bk * 4,
             tiles + 4 * TILE, tiles + 4 * TILE + 576);
  __syncwarp();

  if (step) {
    const T act = row[col::ACT];
    const T rm = row[col::RUN] * row[col::DT];
    copy_out(tiles, act, A + bs * 576, (T*)nullptr, lane);
    copy_out(tiles + TILE, act, Bm + bs * 576, (T*)nullptr, lane);
    copy_out(tiles + 2 * TILE, rm, lxx + bs * 576, lx + bs * 24, lane);
    copy_out(tiles + 3 * TILE, rm, luu + bs * 576, lu + bs * 24, lane);
  }
  copy_out(tiles + 4 * TILE, row[col::TERM], phixx + bk * 576, phix + bk * 24,
           lane);
}

template <typename T>
int launch_hkd_lq(int batch, int N, double mu, const T* const* in,
                  T* const* out, cudaStream_t stream) {
  if (batch == 0) return 0;
  const int blocks = batch * (N + 1);
  hkd_lq_kernel<T><<<blocks, 32, NTILES * TILE * sizeof(T), stream>>>(
      N, T(mu), in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
      in[8], out[0], out[1], out[2], out[3], out[4], out[5], out[6], out[7]);
  return (int)cudaGetLastError();
}

}  // namespace

// Operands, all contiguous: X [B,N+1,24], U [B,N,24], reb_delta, reb_eps,
// reb_act [B,N,20], al_lam, al_sig, al_act [B,N+1,4], table [N+1,NCOLS];
// outputs A, B, lxx, luu [B,N,24,24], lx, lu [B,N,24], phix [B,N+1,24],
// phixx [B,N+1,24,24].
#define HKD_LQ_ENTRY(NAME, T)                                                \
  extern "C" int NAME(int batch, int N, double mu, const T* X, const T* U,  \
                      const T* reb_delta, const T* reb_eps,                 \
                      const T* reb_act, const T* al_lam, const T* al_sig,   \
                      const T* al_act, const T* table, T* A, T* Bm, T* lx,  \
                      T* lu, T* lxx, T* luu, T* phix, T* phixx,             \
                      void* stream) {                                       \
    const T* in[9] = {X,      U,      reb_delta, reb_eps, reb_act,          \
                      al_lam, al_sig, al_act,    table};                    \
    T* out[8] = {A, Bm, lx, lu, lxx, luu, phix, phixx};                     \
    return launch_hkd_lq<T>(batch, N, mu, in, out,                          \
                            static_cast<cudaStream_t>(stream));             \
  }

HKD_LQ_ENTRY(cafempc_hkd_lq_f32, float)
HKD_LQ_ENTRY(cafempc_hkd_lq_f64, double)
