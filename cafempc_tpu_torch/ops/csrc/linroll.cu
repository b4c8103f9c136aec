// Fused linear rollout dx_{k+1} = M_k dx_k + c_k, one CTA per scenario.
//
// Replaces the TPU kernel cafempc_tpu/ops/fused_linroll.py::
// fused_linear_rollout (_linroll_kernel, pallas_call at fused_linroll.py:73).
// Semantics and shapes: see cafempc_tpu_torch/ops/linroll.py, whose
// linroll_reference is the plain PyTorch twin this kernel is tested against.
//
// What bounds it: per knot one xs x xs matvec per scenario (1.2 kFLOP at
// xs = 24) that depends on the previous knot, so the walk is a chain of N
// short dependent steps; the M stream (B*N*xs*xs values, 66 MB at B = 256,
// N = 112 in f32) is read once.  The design carries dx in shared memory
// across the whole walk (ping-pong buffers, one barrier per knot) and
// gives each thread one row of M_k dx_k + c_k.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void linroll_kernel(int N, int xs, const T* __restrict__ M,
                               const T* __restrict__ c,
                               const T* __restrict__ dx0,
                               T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + xs;
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < xs; i += blockDim.x)
    cur[i] = dx0[(size_t)b * xs + i];
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    const size_t bk = (size_t)b * N + k;
    const T* Mk = M + bk * xs * xs;
    for (int i = threadIdx.x; i < xs; i += blockDim.x) {
      T s = c[bk * xs + i];
      for (int j = 0; j < xs; ++j) s += Mk[i * xs + j] * cur[j];
      nxt[i] = s;
      out[bk * xs + i] = s;
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T>
int launch_linroll(int batch, int N, int xs, const T* M, const T* c,
                   const T* dx0, T* out, cudaStream_t stream) {
  if (batch == 0) return 0;
  const int threads = ((xs + 31) / 32) * 32;
  linroll_kernel<T><<<batch, threads > 1024 ? 1024 : threads,
                      2 * xs * sizeof(T), stream>>>(N, xs, M, c, dx0, out);
  return (int)cudaGetLastError();
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
