// Fused HKD LQ approximation: one CTA of five warps per (scenario, knot),
// one warp per output.
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
// bandwidth), against a few thousand instructions of model math per knot.
// The matrices are sparse (A is the identity plus ~60 entries), so the
// design never holds a dense matrix in registers.  The CTA first stages
// the knot's inputs (table row, x, u, penalty terms) in shared memory in
// one round trip, behind the kernel's only block barrier.  Then warp w
// owns output w (A; B; lxx, lx; luu, lu; phixx, phix): it zeroes its
// 24 x 24 tile and vector in shared memory with 16-byte stores, scatters
// the nonzeros with its lanes split over the legs, rows or entries (so the
// five fills run side by side in five warps, not one after another in
// one), and streams the tile out with 16-byte stores, scaling by the
// output's mask.  Only __syncwarp orders a warp's steps from there, so a
// warp's stores overlap the other warps' fills and the other CTAs' work
// (160-thread CTAs, 13 KB of shared memory in f32, 27 KB in f64; registers
// cap the resident CTAs, see min_blocks).  Alone, the stores take about
// the byte bound and the fills longer, so the fills' latency is what the
// staging and the residency cut.  Where two contributions add onto one
// entry, one lane adds them in the order of the reference loops.
#include <cuda_runtime.h>

#include "hkd_common.cuh"

namespace {

using namespace hkd;

constexpr int TILE = 24 * 24 + 24;   // matrix + vector
constexpr int NTILES = 5;            // outputs per knot, one warp each
constexpr int THREADS = 32 * NTILES;
// a knot's inputs in shared memory: its table row, x, u, the ReB delta,
// eps, act and the AL lam, sig, act
constexpr int NIN = col::NCOLS + 24 + 24 + 3 * 20 + 3 * 4;

// Resident CTAs per SM the compiler must allow for: the kernel is bound
// by the latency of its per-knot fills, so more CTAs in flight pay for a
// few spilled registers (8 CTAs, 48 registers in f32: ~16% faster than
// without a bound at 72 registers; 4 CTAs, 96 registers in f64: ~10%
// faster than at 126).
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 8 : 4; }

// column j of a 3 x 3 matrix (j from a lane, so selects, not indexing)
template <typename T>
__device__ __forceinline__ void column(const T M[3][3], int j, T c[3]) {
  for (int i = 0; i < 3; ++i)
    c[i] = j == 0 ? M[i][0] : (j == 1 ? M[i][1] : M[i][2]);
}

// A: the dynamics Jacobian I + dt Fx (models/hkd.py::dynamics_partials),
// or on a reset step the reset-map Jacobian (reset_map_partial_td_lo).
template <typename T>
__device__ void fill_A(const T* x, const T* u, const T* row, T* A,
                       int lane) {
  const T* eul = x;
  const T* pos = x + 3;
  const T* om = x + 6;
  const T* qd = x + 12;
  T R[3][3], dR[3][3][3];
  rot_derivs(eul, R, dR[0], dR[1], dR[2]);
  if (row[col::RESET] > T(0)) {
    if (lane < 12) A[lane * 24 + lane] = T(1);
    if (lane < 4) {   // one leg per lane: its rows 12 + 3l .. 14 + 3l
      const int l = lane;
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
  T sp, cp, sr, cr;
  sin_cos(eul[1], &sp, &cp);
  sin_cos(eul[2], &sr, &cr);
  if (lane == 0) {
    // Euler-rate rows: d(W omega)/d(pitch, roll) and W (one division)
    const T icp = T(1) / cp;
    const T icp2 = icp * icp;
    const T W[3][3] = {{T(0), sr * icp, cr * icp},
                       {T(0), cr, -sr},
                       {T(1), sp * sr * icp, sp * cr * icp}};
    const T dWp[3][3] = {{T(0), sr * sp * icp2, cr * sp * icp2},
                         {T(0), T(0), T(0)},
                         {T(0), sr * icp2, cr * icp2}};
    const T dWr[3][3] = {{T(0), cr * icp, -sr * icp},
                         {T(0), -sr, -cr},
                         {T(0), sp * cr * icp, -sp * sr * icp}};
    for (int i = 0; i < 3; ++i) {
      A[i * 24 + 1] = dt * (dWp[i][0] * om[0] + dWp[i][1] * om[1]
                            + dWp[i][2] * om[2]);
      A[i * 24 + 2] = dt * (dWr[i][0] * om[0] + dWr[i][1] * om[1]
                            + dWr[i][2] * om[2]);
      for (int j = 0; j < 3; ++j) A[i * 24 + 6 + j] = dt * W[i][j];
      A[(3 + i) * 24 + 9 + i] = dt;
    }
  }
  // angular-acceleration rows 6 + i
  if (lane < 3) {   // lane i: the body-state columns of row 6 + i
    const int i = lane;
    T ftot[3] = {T(0), T(0), T(0)}, tau[3] = {T(0), T(0), T(0)};
    for (int l = 0; l < 4; ++l) {
      T f[3];
      for (int c = 0; c < 3; ++c) {
        f[c] = u[3 * l + c] * row[col::C3 + 3 * l + c];
        ftot[c] += f[c];
      }
      const T arm[3] = {qd[3 * l] - pos[0], qd[3 * l + 1] - pos[1], -pos[2]};
      tau[0] += arm[1] * f[2] - arm[2] * f[1];
      tau[1] += arm[2] * f[0] - arm[0] * f[2];
      tau[2] += arm[0] * f[1] - arm[1] * f[0];
    }
    const T Ii = T(i == 0 ? INERTIA0 : (i == 1 ? INERTIA1 : INERTIA2));
    const T iinv = T(1) / Ii;
    T Ri[3];
    column(R, i, Ri);
    T* Ar = A + (6 + i) * 24;
    for (int e = 0; e < 3; ++e) {      // d/d(yaw, pitch, roll)
      T dRi[3];
      column(dR[e], i, dRi);
      Ar[e] = dt * (iinv * (dRi[0] * tau[0] + dRi[1] * tau[1]
                            + dRi[2] * tau[2]));
    }
    const T skf[3][3] = {{T(0), -ftot[2], ftot[1]},
                         {ftot[2], T(0), -ftot[0]},
                         {-ftot[1], ftot[0], T(0)}};
    // row i of skew(I omega) and of skew(omega)
    const T Iw[3] = {T(INERTIA0) * om[0], T(INERTIA1) * om[1],
                     T(INERTIA2) * om[2]};
    const T skIw[3][3] = {{T(0), -Iw[2], Iw[1]},
                          {Iw[2], T(0), -Iw[0]},
                          {-Iw[1], Iw[0], T(0)}};
    const T skw[3][3] = {{T(0), -om[2], om[1]},
                         {om[2], T(0), -om[0]},
                         {-om[1], om[0], T(0)}};
    for (int j = 0; j < 3; ++j) {
      Ar[3 + j] = dt * (iinv * (Ri[0] * skf[0][j] + Ri[1] * skf[1][j]
                                + Ri[2] * skf[2][j]));
      const T skIw_ij = i == 0 ? skIw[0][j] : (i == 1 ? skIw[1][j]
                                                      : skIw[2][j]);
      const T skw_ij = i == 0 ? skw[0][j] : (i == 1 ? skw[1][j] : skw[2][j]);
      Ar[6 + j] = dt * (iinv * (skIw_ij - skw_ij * T(inertia(j))));
    }
  }
  if (lane < 8) {   // lane 2l + j: column 12 + 3l + j of rows 6-8
    const int l = lane >> 1, j = lane & 1;   // the foot-height column is masked
    T f[3];
    for (int c = 0; c < 3; ++c) f[c] = u[3 * l + c] * row[col::C3 + 3 * l + c];
    // column j of skew(f)
    const T s0 = j == 0 ? T(0) : -f[2];
    const T s1 = j == 0 ? f[2] : T(0);
    const T s2 = j == 0 ? -f[1] : f[0];
    for (int i = 0; i < 3; ++i) {
      const T iinv = T(1) / T(inertia(i));
      A[(6 + i) * 24 + 12 + 3 * l + j] =
          dt * (iinv * -(R[0][i] * s0 + R[1][i] * s1 + R[2][i] * s2));
    }
  }
  __syncwarp();
  if (lane < 24) A[lane * 24 + lane] += T(1);
}

// B = dt Fu, zero on a reset step.
template <typename T>
__device__ void fill_B(const T* x, const T* row, T* Bm, int lane) {
  if (row[col::RESET] > T(0)) return;
  const T dt = row[col::DT];
  if (lane < 12) Bm[(12 + lane) * 24 + 12 + lane] =
      dt * row[col::SWING3 + lane];
  if (lane >= 12) return;
  // lane 3l + i: leg l's columns of rows 6 + i and 9 + i
  const int l = lane / 3, i = lane - 3 * (lane / 3);
  const T* pos = x + 3;
  const T* qd = x + 12;
  T R[3][3], dR[3][3][3];
  rot_derivs(x, R, dR[0], dR[1], dR[2]);
  T Ri[3];
  column(R, i, Ri);
  const T c = row[col::C3 + 3 * l];
  const T a[3] = {qd[3 * l] - pos[0], qd[3 * l + 1] - pos[1], -pos[2]};
  const T sk[3][3] = {{T(0), -a[2], a[1]},
                      {a[2], T(0), -a[0]},
                      {-a[1], a[0], T(0)}};
  const T Ii = T(i == 0 ? INERTIA0 : (i == 1 ? INERTIA1 : INERTIA2));
  for (int j = 0; j < 3; ++j)
    Bm[(6 + i) * 24 + 3 * l + j] =
        dt * (T(1) / Ii
              * ((Ri[0] * sk[0][j] + Ri[1] * sk[1][j] + Ri[2] * sk[2][j])
                 * c));
  Bm[(9 + i) * 24 + 3 * l + i] = dt * (row[col::C3 + 3 * l + i] / T(MASS));
}

// The tracking diagonal and the foot-placement terms of lx / phix (lane i
// of 24 owns entry i): g = w (x - ref), H_ii = w, then for each foot
// coordinate j (q = 12 + j, a = 3 + j % 3) g_q += v, g_a -= v,
// H_qq += h, H_qa -= h, H_aq -= h, H_aa += h.  Lane q adds its own foot's
// terms; lane a adds the four feet's terms in the reference's order.
template <typename T, typename Foot>
__device__ __forceinline__ void track_and_feet(const T* x, const T* w,
                                               const T* ref, Foot foot,
                                               T* H, T* g, int lane) {
  if (lane >= 24) return;
  const int i = lane;
  T gi = w[i] * (x[i] - ref[i]);
  T hii = w[i];
  if (i >= 12) {
    const int j = i - 12, a = 3 + j % 3;
    T v, h;
    foot(j, v, h);
    gi += v;
    hii += h;
    H[i * 24 + a] -= h;
    H[a * 24 + i] -= h;
  } else if (i >= 3 && i < 6) {
    for (int j = i - 3; j < 12; j += 3) {
      T v, h;
      foot(j, v, h);
      gi -= v;
      hii += h;
    }
  }
  g[i] = gi;
  H[i * 24 + i] = hii;
}

// lxx, lx: state tracking plus the foot-placement regularization on the
// stance legs (HKDCost.h:8-100), before the run_m dt scale.
template <typename T>
__device__ void fill_lx(const T* x, const T* row, T* H, T* g, int lane) {
  auto foot = [&](int j, T& v, T& h) {
    const int a = 3 + j % 3, q = 12 + j;
    const T c = row[col::C3 + j], w = row[col::QFOOT_R + j];
    const T d = (x[q] - x[a]) - row[col::PRELREF_R + j];
    v = c * (w * d);
    h = c * w * c;
  };
  track_and_feet(x, row + col::QW, row + col::XREF_S, foot, H, g, lane);
}

// luu, lu: control tracking plus the Gauss-Newton terms of the ReB
// friction-pyramid barrier (constant facet Jacobian); one leg per lane.
template <typename T>
__device__ void fill_lu(const T* u, const T* row, const T* delta,
                        const T* reps, const T* ract, T mu, T* H, T* g,
                        int lane) {
  if (lane < 24) {
    g[lane] = row[col::RW + lane] * (u[lane] - row[col::UREF_S + lane]);
    H[lane * 24 + lane] = row[col::RW + lane];
  }
  __syncwarp();
  if (lane >= 4) return;
  const int l = lane;
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

// phixx, phix: terminal tracking, the terminal foot-placement term and the
// AL touchdown-height terms (HKDConstraints.cpp:68-160), before the
// term_m scale.
template <typename T>
__device__ void fill_phi(const T* x, const T* row, const T* lam,
                         const T* sig, const T* aact, T* H, T* g, int lane) {
  auto foot = [&](int j, T& v, T& h) {
    const int a = 3 + j % 3, q = 12 + j;
    const T w = row[col::QFOOT_T + j];
    const T d = (x[q] - x[a]) - row[col::PRELREF_T + j];
    v = T(20) * (w * d);
    h = T(20) * w;
  };
  track_and_feet(x, row + col::QF_T, row + col::XREF_K, foot, H, g, lane);
  __syncwarp();
  // AL terms, lane l < 4 for leg l.  dh/dx is nonzero at pitch, roll,
  // pos z (columns shared by the legs) and the leg's three qdummy columns.
  T act = T(0), gw = T(0), hw = T(0), v[6] = {T(0), T(0), T(0), T(0), T(0),
                                             T(0)};
  if (lane < 4 && aact[lane] > T(0)) {
    const int l = lane;
    T R[3][3], dR[3][3][3];
    rot_derivs(x, R, dR[0], dR[1], dR[2]);
    T p[3], J[3][3];
    leg_fk(l, x + 12 + 3 * l, p, J);
    const T h = x[5] + (R[2][0] * p[0] + R[2][1] * p[1] + R[2][2] * p[2]);
    act = T(1);
    gw = sig[l] * h + lam[l];
    hw = sig[l] * (T(1) + h) + lam[l];
    for (int e = 0; e < 2; ++e)
      v[e] = dR[e + 1][2][0] * p[0] + dR[e + 1][2][1] * p[1]
             + dR[e + 1][2][2] * p[2];
    v[2] = T(1);
    for (int j = 0; j < 3; ++j)
      v[3 + j] = R[2][0] * J[0][j] + R[2][1] * J[1][j] + R[2][2] * J[2][j];
    // the entries that only this leg touches
    const int c[6] = {1, 2, 5, 12 + 3 * l, 13 + 3 * l, 14 + 3 * l};
    for (int a = 0; a < 6; ++a) {
      if (a >= 3) g[c[a]] += gw * v[a];
      for (int b = 0; b < 6; ++b)
        if (a >= 3 || b >= 3) H[c[a] * 24 + c[b]] += hw * v[a] * v[b];
    }
  }
  // the entries of the shared columns {1, 2, 5}: lane 3a + b adds H_ab
  // (lanes 9-11 g_a) over the legs in order, as the reference does
  for (int l = 0; l < 4; ++l) {
    const T al = __shfl_sync(0xffffffffu, act, l);
    const T gwl = __shfl_sync(0xffffffffu, gw, l);
    const T hwl = __shfl_sync(0xffffffffu, hw, l);
    const T w0 = __shfl_sync(0xffffffffu, v[0], l);
    const T w1 = __shfl_sync(0xffffffffu, v[1], l);
    const T w2 = __shfl_sync(0xffffffffu, v[2], l);
    if (al > T(0) && lane < 12) {
      const int a = lane < 9 ? lane / 3 : lane - 9;
      const int ca = a == 0 ? 1 : (a == 1 ? 2 : 5);
      const T va = a == 0 ? w0 : (a == 1 ? w1 : w2);
      if (lane < 9) {
        const int b = lane - 3 * a;
        const int cb = b == 0 ? 1 : (b == 1 ? 2 : 5);
        const T vb = b == 0 ? w0 : (b == 1 ? w1 : w2);
        H[ca * 24 + cb] += hwl * va * vb;
      } else {
        g[ca] += gwl * va;
      }
    }
  }
}

// The warp's tile (and vector) to the output, times its mask, in 16-byte
// streaming stores; the outputs are fresh allocations, so 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy_out(const T* tile, T scale, T* mat,
                                         T* vec, int lane) {
  constexpr int V = Pack<T>::N;
  for (int i = lane * V; i < 576; i += 32 * V) {
    Pack<T> p = Pack<T>::load(tile + i);
    for (int m = 0; m < V; ++m) p.a[m] *= scale;
    p.store_stream(mat + i);
  }
  if (vec != nullptr && lane * V < 24) {
    Pack<T> p = Pack<T>::load(tile + 576 + lane * V);
    for (int m = 0; m < V; ++m) p.a[m] *= scale;
    p.store_stream(vec + lane * V);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, min_blocks<T>()) hkd_lq_kernel(
    int N, T mu, const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ reb_delta, const T* __restrict__ reb_eps,
    const T* __restrict__ reb_act, const T* __restrict__ al_lam,
    const T* __restrict__ al_sig, const T* __restrict__ al_act,
    const T* __restrict__ table, T* __restrict__ A, T* __restrict__ Bm,
    T* __restrict__ lx, T* __restrict__ lu, T* __restrict__ lxx,
    T* __restrict__ luu, T* __restrict__ phix, T* __restrict__ phixx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NK = N + 1;
  const int b = blockIdx.x / NK;
  const int k = blockIdx.x % NK;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool step = k < N;
  const size_t bk = (size_t)b * NK + k;   // knot index
  const size_t bs = (size_t)b * N + k;    // step index (k < N)
  T* tile = reinterpret_cast<T*>(smem_raw) + w * TILE;
  constexpr int V = Pack<T>::N;
  Pack<T> zero;
  for (int m = 0; m < V; ++m) zero.a[m] = T(0);
  for (int i = lane * V; i < TILE; i += 32 * V) zero.store(tile + i);

  // the knot's inputs, staged by the whole CTA in one round trip: the
  // fills then read shared memory, not a chain of global loads
  T* row = reinterpret_cast<T*>(smem_raw) + NTILES * TILE;
  T* x = row + col::NCOLS;
  T* u = x + 24;
  T* reb = u + 24;   // delta, eps, act [3, 20]
  T* al = reb + 60;  // lam, sig, act [3, 4]
  for (int i = threadIdx.x; i < NIN; i += THREADS) {
    T v = T(0);
    if (i < col::NCOLS) {
      v = table[(size_t)k * col::NCOLS + i];
    } else if (i < col::NCOLS + 24) {
      v = X[bk * 24 + (i - col::NCOLS)];
    } else if (i < col::NCOLS + 108) {   // U and the ReB terms: steps only
      const int j = i - col::NCOLS - 24;
      if (step)
        v = j < 24 ? U[bs * 24 + j]
                   : (j < 44 ? reb_delta
                             : (j < 64 ? reb_eps : reb_act))[bs * 20
                                                             + (j - 24) % 20];
    } else {
      const int j = i - col::NCOLS - 108;
      v = (j < 4 ? al_lam : (j < 8 ? al_sig : al_act))[bk * 4 + j % 4];
    }
    row[i] = v;
  }
  __syncthreads();
  if (!step && w < 4) return;   // the terminal knot has phix, phixx only

  T* vec = tile + 576;
  T scale;
  T* mat_out;
  T* vec_out;
  switch (w) {
    case 0:
      fill_A(x, u, row, tile, lane);
      scale = row[col::ACT], mat_out = A + bs * 576, vec_out = nullptr;
      break;
    case 1:
      fill_B(x, row, tile, lane);
      scale = row[col::ACT], mat_out = Bm + bs * 576, vec_out = nullptr;
      break;
    case 2:
      fill_lx(x, row, tile, vec, lane);
      scale = row[col::RUN] * row[col::DT], mat_out = lxx + bs * 576;
      vec_out = lx + bs * 24;
      break;
    case 3:
      fill_lu(u, row, reb, reb + 20, reb + 40, mu, tile, vec, lane);
      scale = row[col::RUN] * row[col::DT], mat_out = luu + bs * 576;
      vec_out = lu + bs * 24;
      break;
    default:
      fill_phi(x, row, al, al + 4, al + 8, tile, vec, lane);
      scale = row[col::TERM], mat_out = phixx + bk * 576;
      vec_out = phix + bk * 24;
      break;
  }
  __syncwarp();
  copy_out(tile, scale, mat_out, vec_out, lane);
}

template <typename T>
int launch_hkd_lq(int batch, int N, double mu, const T* const* in,
                  T* const* out, cudaStream_t stream) {
  if (batch == 0) return 0;
  const int blocks = batch * (N + 1);
  const size_t smem = (NTILES * TILE + NIN) * sizeof(T);
  hkd_lq_kernel<T><<<blocks, THREADS, smem, stream>>>(
      N, T(mu), in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
      in[8], out[0], out[1], out[2], out[3], out[4], out[5], out[6], out[7]);
  return (int)cudaGetLastError();
}

}  // namespace

// Operands, all contiguous: X [B,N+1,24], U [B,N,24], reb_delta, reb_eps,
// reb_act [B,N,20], al_lam, al_sig, al_act [B,N+1,4], table [N+1,NCOLS];
// outputs A, B, lxx, luu [B,N,24,24], lx, lu [B,N,24], phix [B,N+1,24],
// phixx [B,N+1,24,24], each starting on a 16-byte boundary.
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
