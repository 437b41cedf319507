// Tiled matrix product with fp32 accumulation, for sm_90a (H100).
//
// Replaces repro/kernels/matmul.py matmul (kernel 5, pallas_call at
// matmul.py:63, body _matmul_kernel): out = x @ w for x (M, K) and w
// (K, N), fp32 or bf16 inputs, fp32 accumulation, the result in x's type.
//
// What bounds it on this card: operations at the sizes where it matters
// (2*M*N*K fp32 FMAs on CUDA cores, 67 TFLOP/s, against reading x and w
// and writing out once at 3.35 TB/s); small products are bound by the
// launch.
//
// Design (simple first): one block of 256 threads per 64 x 64 tile of
// out; the TPU's sequential K grid axis is a loop inside the block, in
// steps of 16 staged in shared memory (x's slice transposed, so each
// thread reads its four rows as one float4); each thread keeps a 4 x 4
// tile of sums in registers.  The ragged edges are masked where the TPU
// wrapper padded: loads past M, N or K read 0, stores past M or N are
// skipped.  Every output is one fmaf chain over k in order, so the
// blocking never changes a result.  CUDA-core FMAs: no TF32, no tensor
// cores (their fp32 path is TF32; bf16 products would need a bf16 x bf16
// tensor-core tile, later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
          T* __restrict__ out, int m, int n, int k) {
  // x's slice, transposed; rows padded by 4 floats (kept 16-byte aligned)
  // so the transposing stores spread over the banks.
  __shared__ __align__(16) float xs[kBK][kBM + 4];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x: consecutive threads read consecutive k of a row.
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < m && gk < k) ? to_float(x[(size_t)gm * k + gk])
                                     : 0.f;
    }
    // w: consecutive threads read consecutive columns of a row.
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, cn = i % kBN;
      const int gk = k0 + kk, gn = n0 + cn;
      ws[kk][cn] = (gk < k && gn < n) ? to_float(w[(size_t)gk * n + gn])
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < n) store(out + (size_t)gm * n + gn, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const T* x, const T* w, T* out, int m, int n, int k,
           void* stream) {
  if (m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  mm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (m, n) = x (m, k) @ w (k, n), row-major, on `stream`.  Returns a
// cudaError_t (0 on success).
int mm_f32(const float* x, const float* w, float* out, int m, int n, int k,
           void* stream) {
  return launch(x, w, out, m, n, k, stream);
}

int mm_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
            __nv_bfloat16* out, int m, int n, int k, void* stream) {
  return launch(x, w, out, m, n, k, stream);
}

const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
