// The HKD quadruped model in closed form for one knot, shared by the fused
// HKD LQ (hkd_lq.cu) and line-search trial (hkd_trial.cu) kernels.
//
// Constants are those of cafempc_tpu_torch/models/hkd.py; the column
// layout of the per-knot constant table is that of
// cafempc_tpu_torch/ops/hkd_table.py.  Both kernels are compared with
// plain PyTorch twins that read the model and the layout from those Python
// modules, so a drift shows as a disagreement.
#pragma once
#include <cuda_runtime.h>

namespace hkd {

constexpr double MASS = 8.912;
constexpr double GRAVITY = 9.81;
constexpr double INERTIA0 = 0.02746078;
constexpr double INERTIA1 = 0.2425157968;
constexpr double INERTIA2 = 0.2651935768;
constexpr double L1 = 0.062;   // abad link
constexpr double L2 = 0.209;   // thigh
constexpr double L3 = 0.195;   // shank
constexpr double QLEG_DEFAULT0 = 0.0;
constexpr double QLEG_DEFAULT1 = -0.8;
constexpr double QLEG_DEFAULT2 = 1.7;

// legs FR, FL, HR, HL
__device__ __forceinline__ double hip_x(int l) { return l < 2 ? 0.19 : -0.19; }
__device__ __forceinline__ double hip_y(int l) {
  return (l & 1) ? 0.049 : -0.049;
}
__device__ __forceinline__ double side_sign(int l) {
  return (l & 1) ? 1.0 : -1.0;
}
__device__ __forceinline__ double inertia(int i) {
  return i == 0 ? INERTIA0 : (i == 1 ? INERTIA1 : INERTIA2);
}
__device__ __forceinline__ double qleg_default(int i) {
  return i == 0 ? QLEG_DEFAULT0 : (i == 1 ? QLEG_DEFAULT1 : QLEG_DEFAULT2);
}

// columns of the per-knot table (ops/hkd_table.py)
namespace col {
constexpr int XREF_S = 0, UREF_S = 24, QW = 48, RW = 72, QFOOT_R = 96,
              PRELREF_R = 108, C3 = 120, SWING3 = 132, TD4 = 144, LO4 = 148,
              DT = 152, RUN = 153, RESET = 154, ACT = 155, XREF_K = 156,
              QF_T = 180, QFOOT_T = 204, PRELREF_T = 216, PREV_ACT = 228,
              KACT = 229, TERM = 230, NCOLS = 231;
}  // namespace col

// sine and cosine of one angle in one call (the accurate library
// functions; the kernels are built without fast math)
__device__ __forceinline__ void sin_cos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ void sin_cos(double a, double* s, double* c) {
  sincos(a, s, c);
}

// 16 bytes of T as one vector load or store: 4 floats or 2 doubles.  The
// pointer must be 16-byte aligned.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  float a[4];
  __device__ __forceinline__ static Pack load(const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return {{v.x, v.y, v.z, v.w}};
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
  // a store that streams past the caches (the output is read once, later)
  __device__ __forceinline__ void store_stream(float* p) const {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  }
};
template <>
struct Pack<double> {
  static constexpr int N = 2;
  double a[2];
  __device__ __forceinline__ static Pack load(const double* p) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    return {{v.x, v.y}};
  }
  __device__ __forceinline__ void store(double* p) const {
    *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
  }
  __device__ __forceinline__ void store_stream(double* p) const {
    __stcs(reinterpret_cast<double2*>(p), make_double2(a[0], a[1]));
  }
};

template <typename T>
__device__ __forceinline__ void matmul3(const T a[3][3], const T b[3][3],
                                        T out[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

// R = Rz(yaw) Ry(pitch) Rx(roll) and its partials wrt (yaw, pitch, roll):
// dR_y = skew(ez) R, dR_p = Rz skew(ey) Ry Rx, dR_r = Rz Ry skew(ex) Rx
// (models/hkd.py::_rot_derivs), from the sines and cosines of the angles
// (the second form takes the angles).
template <typename T>
__device__ void rot_derivs(T sy, T cy, T sp, T cp, T sr, T cr, T R[3][3],
                           T dRy[3][3], T dRp[3][3], T dRr[3][3]) {
  const T z = T(0), o = T(1);
  const T Rz[3][3] = {{cy, -sy, z}, {sy, cy, z}, {z, z, o}};
  const T Ry[3][3] = {{cp, z, sp}, {z, o, z}, {-sp, z, cp}};
  const T Rx[3][3] = {{o, z, z}, {z, cr, -sr}, {z, sr, cr}};
  const T ex[3][3] = {{z, z, z}, {z, z, -o}, {z, o, z}};
  const T ey[3][3] = {{z, z, o}, {z, z, z}, {-o, z, z}};
  const T ez[3][3] = {{z, -o, z}, {o, z, z}, {z, z, z}};
  T t1[3][3], t2[3][3];
  matmul3(Rz, Ry, t1);
  matmul3(t1, Rx, R);
  matmul3(ez, R, dRy);
  matmul3(Rz, ey, t1);
  matmul3(t1, Ry, t2);
  matmul3(t2, Rx, dRp);
  matmul3(Rz, Ry, t1);
  matmul3(t1, ex, t2);
  matmul3(t2, Rx, dRr);
}

template <typename T>
__device__ void rot_derivs(const T* eul, T R[3][3], T dRy[3][3],
                           T dRp[3][3], T dRr[3][3]) {
  T sy, cy, sp, cp, sr, cr;
  sin_cos(eul[0], &sy, &cy);
  sin_cos(eul[1], &sp, &cp);
  sin_cos(eul[2], &sr, &cr);
  rot_derivs(sy, cy, sp, cp, sr, cr, R, dRy, dRp, dRr);
}

// Foot position of leg l in the body frame from its joint angles q[3]
// (models/hkd.py::_legs_fk_local); with J, its Jacobian wrt q
// (_legs_jacobian_local).
template <typename T>
__device__ void leg_fk(int l, const T* q, T p[3], T J[3][3]) {
  T s1, c1, s2, c2, s3, c3;
  sin_cos(q[0], &s1, &c1);
  sin_cos(q[1], &s2, &c2);
  sin_cos(q[2], &s3, &c3);
  const T s23 = s2 * c3 + c2 * s3;
  const T c23 = c2 * c3 - s2 * s3;
  const T sig = T(side_sign(l));
  const T ext = T(L3) * c23 + T(L2) * c2;
  p[0] = T(hip_x(l)) + T(L3) * s23 + T(L2) * s2;
  p[1] = T(hip_y(l)) + sig * T(L1) * c1 + s1 * ext;
  p[2] = sig * T(L1) * s1 - c1 * ext;
  if (J != nullptr) {
    const T dext2 = -T(L3) * s23 - T(L2) * s2;
    const T dext3 = -T(L3) * s23;
    J[0][0] = T(0);
    J[0][1] = ext;
    J[0][2] = T(L3) * c23;
    J[1][0] = -sig * T(L1) * s1 + c1 * ext;
    J[1][1] = s1 * dext2;
    J[1][2] = s1 * dext3;
    J[2][0] = sig * T(L1) * c1 + s1 * ext;
    J[2][1] = -c1 * dext2;
    J[2][2] = -c1 * dext3;
  }
}

// Friction-pyramid values of one leg's force f[3] (HKDConstraints.cpp:17-53):
// [fz, -fx + mu fz, fx + mu fz, -fy + mu fz, fy + mu fz].
template <typename T>
__device__ __forceinline__ void facets(const T* f, T mu, T g[5]) {
  g[0] = f[2];
  g[1] = -f[0] + mu * f[2];
  g[2] = f[0] + mu * f[2];
  g[3] = -f[1] + mu * f[2];
  g[4] = f[1] + mu * f[2];
}

}  // namespace hkd
