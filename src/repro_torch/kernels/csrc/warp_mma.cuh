// Warp-level tensor-core and async-copy helpers for sm_90a (H100), shared
// by flash_attention.cu, matmul.cu and deform_conv_bwd.cu: 16-byte and
// 4-byte cp.async with zero fill, ldmatrix (plain and transposed), the bf16
// m16n8k16 and the tf32 m16n8k8 mma.sync with fp32 accumulation, the
// split-fp32 ("3xTF32") product built on the latter, and the host's
// dynamic-shared-memory opt-in.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * gid +
// tig.  A (16 x 16, row-major): a0 = (gid, 2 tig..+1), a1 = (gid + 8, ..),
// a2 = (gid, 8 + 2 tig..), a3 = (gid + 8, 8 + ..).  B (16 x 8, k x n):
// b0 = (k 2 tig..+1, n gid), b1 = (k 8 + 2 tig.., n gid).  C/D (16 x 8):
// d0, d1 = (gid, 2 tig..+1), d2, d3 = (gid + 8, ..).  A register holding
// two bf16 keeps the lower column in its low half.
//
// mma.m16n8k8 with .tf32 (one 32-bit element a register): A (16 x 8,
// row-major): a0 = (gid, tig), a1 = (gid + 8, tig), a2 = (gid, tig + 4),
// a3 = (gid + 8, tig + 4).  B (8 x 8, k x n): b0 = (k tig, n gid), b1 =
// (k tig + 4, n gid).  C/D as for bf16: d0, d1 = (gid, 2 tig..+1), d2, d3
// = (gid + 8, ..).  The unit reads the 19 high bits of each element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wmma_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 reads nothing and
// writes 16 zero bytes.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronous (src_bytes 0: writes a zero).
// Both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives matrix i's fragment (lane: row lane / 4,
// columns 2 (lane % 4)..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed (lane: column lane / 4, rows
// 2 (lane % 4)..+1 of the stored matrix).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b on the tensor cores: bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores: tf32 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + r: hi = tf32(x) and lo = tf32(x - hi), each rounded to
// nearest (ties away from zero, as cvt.rna.tf32.f32) on the 13 low
// mantissa bits by integer arithmetic; |r| <= 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d += a . b at about fp32 accuracy ("3xTF32"): a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the small terms first; a_lo b_lo (~2^-22 |a b|) is dropped.
// Every product of two tf32 values is exact in fp32.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b_hi0, uint32_t b_hi1,
                                           uint32_t b_lo0, uint32_t b_lo1) {
  mma_tf32(d, a_lo, b_hi0, b_hi1);
  mma_tf32(d, a_hi, b_lo0, b_lo1);
  mma_tf32(d, a_hi, b_hi0, b_hi1);
}

// Two fp32 values rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Host: lets `kernel` take `bytes` of dynamic shared memory on the
// current device, once per kernel and device (`done` is the caller's
// static mask of devices already set), so a launch costs no extra driver
// call after the first.
template <typename Kernel>
inline int allow_smem(Kernel* kernel, size_t bytes,
                      unsigned long long* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit & *done) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) *done |= bit;
  return (int)e;
}

}  // namespace wmma_sm90
