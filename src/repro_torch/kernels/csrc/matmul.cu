// Tiled matrix product with fp32 accumulation, for sm_90a (H100).
//
// Replaces repro/kernels/matmul.py matmul (kernel 5, pallas_call at
// matmul.py:63, body _matmul_kernel): out = x @ w for x (M, K) and w
// (K, N), fp32 or bf16 inputs, fp32 accumulation, the result in x's type.
//
// What bounds it on this card: operations at the sizes where it matters
// (2*M*N*K: fp32 FMAs on CUDA cores, 67 TFLOP/s; bf16 products on the
// tensor cores, 989 TFLOP/s; against reading x and w and writing out once
// at 3.35 TB/s); small products are bound by the launch.
//
// fp32 (mm_f32_kernel): CUDA-core fmaf (the tensor cores' fp32 path is
// TF32).  256 threads per 128 x 128 tile of out, each keeping an 8 x 8
// tile of sums in registers, split 2 x (4 x 4) (rows ty*4 + {0, 64},
// columns tx*4 + {0, 64}) so that every shared-memory read is a float4 and
// a warp's 16 column reads cover 256 contiguous bytes: 4 float4 loads feed
// 64 FMAs.  k steps of 16, double-buffered in shared memory.  x's slice is
// stored k-major (rows of BM + 4 floats), so a thread's 8 rows at one k
// are two float4s; cp.async copies bytes as they lie and cannot transpose,
// so step t + 1's x is read with 16-byte loads into registers while step
// t computes and stored transposed after it, and w's slice (already k x
// n) comes with 16-byte cp.async.  Registers are capped at 128 a thread,
// two blocks an SM (on the card this beat an m-major x slice filled by
// cp.async at one block an SM).  Outputs of fewer than 132 such tiles take
// the same kernel at 64 x 64 (a 4 x 4 tile a thread), so small products
// still reach the SMs.  Every output is one fmaf chain over k in order,
// so neither the blocking nor the tile size changes a result.
//
// bf16 (mm_bf16_kernel): bf16 mma.sync m16n8k16 with fp32 accumulation.
// 128 x 128 x 32 block tiles, 8 warps of 64 x 32; x's fragments come from
// ldmatrix, w's from ldmatrix.trans (w is (K, N) row-major, so its k x n
// tiles are transposed into the .col B operand); a 3-stage cp.async ring
// (rows padded by 16 bytes against bank conflicts).  The sums are rounded
// once to bf16, as the JAX kernel's acc.astype(o_ref.dtype).
//
// Both: loads past M, N or K read 0 and stores past M or N are skipped.
// 16-byte loads need 16-byte rows and base pointers (K and N multiples of
// 4 fp32 or 8 bf16); other shapes and misaligned views take the same
// kernel with element-wise loads into the same layout (the VEC template
// flag, chosen by the caller).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace wmma_sm90;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFK = 16;            // k per step

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int R>
struct F32Tile {
  static constexpr int BM = 64 * R, BN = 64 * R;
  static constexpr int XLD = BM + 4;                  // x k-major rows
  static constexpr int X = kFK * XLD, W = kFK * BN;   // floats per stage
  static constexpr int XV = BM * (kFK / 4) / kThreads;   // x float4 a thread
};

template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int m, int n, int k) {
  using Tile = F32Tile<R>;
  constexpr int BM = Tile::BM, BN = Tile::BN, XLD = Tile::XLD;
  __shared__ __align__(16) float xs[2][Tile::X];
  __shared__ __align__(16) float ws[2][Tile::W];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4 * R][4 * R];
#pragma unroll
  for (int i = 0; i < 4 * R; ++i)
#pragma unroll
    for (int j = 0; j < 4 * R; ++j) acc[i][j] = 0.f;
  float4 xr[Tile::XV];

  auto fetch_x = [&](int k0) {
#pragma unroll
    for (int v = 0; v < Tile::XV; ++v) {
      const int i = threadIdx.x + v * kThreads;
      const int r = i / (kFK / 4), c = (i % (kFK / 4)) * 4;
      xr[v] = (m0 + r < m && k0 + c < k)
                  ? *reinterpret_cast<const float4*>(
                        x + (size_t)(m0 + r) * k + k0 + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put_x = [&](float* dst) {
#pragma unroll
    for (int v = 0; v < Tile::XV; ++v) {
      const int i = threadIdx.x + v * kThreads;
      const int r = i / (kFK / 4), c = (i % (kFK / 4)) * 4;
      dst[(c + 0) * XLD + r] = xr[v].x;
      dst[(c + 1) * XLD + r] = xr[v].y;
      dst[(c + 2) * XLD + r] = xr[v].z;
      dst[(c + 3) * XLD + r] = xr[v].w;
    }
  };
  auto load_x_plain = [&](float* dst, int k0) {
    for (int i = threadIdx.x; i < BM * kFK; i += kThreads) {
      const int r = i % BM, c = i / BM;
      dst[c * XLD + r] = (m0 + r < m && k0 + c < k)
                             ? x[(size_t)(m0 + r) * k + k0 + c] : 0.f;
    }
  };
  auto load_w = [&](float* dst, int k0) {
    if constexpr (VEC) {
#pragma unroll
      for (int it = 0; it < kFK * (BN / 4) / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const bool in = k0 + r < k && n0 + c < n;
        cp_async16(dst + r * BN + c,
                   in ? w + (size_t)(k0 + r) * n + n0 + c : w, in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kFK * BN; i += kThreads) {
        const int r = i / BN, c = i % BN;
        dst[r * BN + c] = (k0 + r < k && n0 + c < n)
                              ? w[(size_t)(k0 + r) * n + n0 + c] : 0.f;
      }
    }
  };

  const int steps = (k + kFK - 1) / kFK;
  if constexpr (VEC) {
    fetch_x(0);
    put_x(xs[0]);
  } else {
    load_x_plain(xs[0], 0);
  }
  load_w(ws[0], 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const bool next = t + 1 < steps;
    if (next) {
      if constexpr (VEC) fetch_x((t + 1) * kFK);   // in flight meanwhile
      load_w(ws[(t + 1) & 1], (t + 1) * kFK);
      cp_async_commit();
    }
    const float* xt = xs[t & 1];
    const float* wt = ws[t & 1];
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float4 a[R], b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = *reinterpret_cast<const float4*>(
            &xt[kk * XLD + r * 64 + ty * 4]);
        b[r] = *reinterpret_cast<const float4*>(
            &wt[kk * BN + r * 64 + tx * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4 * R; ++i) {
        const float av = lane_of(a[i / 4], i % 4);
#pragma unroll
        for (int j = 0; j < 4 * R; ++j)
          acc[i][j] = fmaf(av, lane_of(b[j / 4], j % 4), acc[i][j]);
      }
    }
    if (next) {
      if constexpr (VEC) {
        put_x(xs[(t + 1) & 1]);
      } else {
        load_x_plain(xs[(t + 1) & 1], (t + 1) * kFK);
      }
      cp_async_wait<0>();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4 * R; ++i) {
    const int gm = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (gm >= m) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gn = n0 + r * 64 + tx * 4;
      float* o = out + (size_t)gm * n + gn;
      if (VEC && gn < n) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * r], acc[i][4 * r + 1], acc[i][4 * r + 2],
                        acc[i][4 * r + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < n) o[j] = acc[i][4 * r + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kALD = kBK + 8;      // x rows in shared memory (bf16)
constexpr int kBLD = kBN + 8;      // w rows in shared memory (bf16)
constexpr int kAStage = kBM * kALD, kBStage = kBK * kBLD;
constexpr size_t kBf16Smem = sizeof(bf16) * kStages * (kAStage + kBStage);

template <bool VEC>
__device__ __forceinline__ void bf16_load(bf16* as, bf16* bs,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ w, int m,
                                          int n, int k, int m0, int n0,
                                          int k0) {
  if constexpr (VEC) {
#pragma unroll
    for (int it = 0; it < kBM * (kBK / 8) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool in = m0 + r < m && k0 + c < k;
      cp_async16(as + r * kALD + c,
                 in ? x + (size_t)(m0 + r) * k + k0 + c : x, in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < kBK * (kBN / 8) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool in = k0 + r < k && n0 + c < n;
      cp_async16(bs + r * kBLD + c,
                 in ? w + (size_t)(k0 + r) * n + n0 + c : w, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      as[r * kALD + c] = (m0 + r < m && k0 + c < k)
                             ? x[(size_t)(m0 + r) * k + k0 + c] : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      bs[r * kBLD + c] = (k0 + r < k && n0 + c < n)
                             ? w[(size_t)(k0 + r) * n + n0 + c] : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
mm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);    // [kStages][kBM][kALD]
  bf16* bs = as + kStages * kAStage;                // [kStages][kBK][kBLD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;   // warp tile
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4][4];   // [16-row tile][8-column tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // ldmatrix row addresses: x rows lane % 16, columns 8 (lane / 16); w
  // (transposed) k rows lane % 16, columns 8 (lane / 16).
  const int a_off = (wm + lane % 16) * kALD + 8 * (lane / 16);
  const int b_off = (lane % 16) * kBLD + wn + 8 * (lane / 16);

  const int steps = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      bf16_load<VEC>(as + s * kAStage, bs + s * kBStage, x, w, m, n, k, m0,
                     n0, s * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();   // step t has landed
    __syncthreads();                // and step t - 1's stage is free
    const int next = t + kStages - 1;
    if (next < steps) {
      const int st = next % kStages;
      bf16_load<VEC>(as + st * kAStage, bs + st * kBStage, x, w, m, n, k,
                     m0, n0, next * kBK);
    }
    cp_async_commit();
    const bf16* at = as + (t % kStages) * kAStage;
    const bf16* bt = bs + (t % kStages) * kBStage;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], at + a_off + i * 16 * kALD + ks * 16);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt + b_off + ks * 16 * kBLD + jp * 16);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + i * 16 + gid + 8 * h;
      if (gm >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + wn + j * 8 + 2 * tig;
        bf16* o = out + (size_t)gm * n + gn;
        if (VEC && gn < n) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
              acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (gn < n) o[0] = __float2bfloat16_rn(acc[i][j][2 * h]);
          if (gn + 1 < n) o[1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

int check_shape(int m, int n, int k, int bm) {
  if (m < 1 || n < 1 || k < 1 || (m + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int R, bool VEC>
int launch_f32(const float* x, const float* w, float* out, int m, int n,
               int k, cudaStream_t s) {
  constexpr int B = 64 * R;
  const dim3 grid((n + B - 1) / B, (m + B - 1) / B);
  mm_f32_kernel<R, VEC><<<grid, kThreads, 0, s>>>(x, w, out, m, n, k);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_bf16(const bf16* x, const bf16* w, bf16* out, int m, int n, int k,
                cudaStream_t s) {
  static unsigned long long done = 0;
  if (int e = allow_smem(mm_bf16_kernel<VEC>, kBf16Smem, &done)) return e;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  mm_bf16_kernel<VEC><<<grid, kThreads, kBf16Smem, s>>>(x, w, out, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (m, n) = x (m, k) @ w (k, n), row-major, on `stream`.  tile = 128 or
// 64 (fp32 block tile); vec = 1 for 16-byte loads, which need k and n
// multiples of 4 (fp32) or 8 (bf16) and x, w, out 16-byte aligned (refused
// otherwise), 0 for element-wise loads.  Returns a cudaError_t (0 on
// success).
int mm_f32(const float* x, const float* w, float* out, int m, int n, int k,
           int tile, int vec, void* stream) {
  if (int e = check_shape(m, n, k, tile)) return e;
  if (vec && (k % 4 || n % 4 || !aligned16(x) || !aligned16(w) ||
              !aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 128)
    return vec ? launch_f32<2, true>(x, w, out, m, n, k, s)
               : launch_f32<2, false>(x, w, out, m, n, k, s);
  if (tile == 64)
    return vec ? launch_f32<1, true>(x, w, out, m, n, k, s)
               : launch_f32<1, false>(x, w, out, m, n, k, s);
  return (int)cudaErrorInvalidValue;
}

int mm_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
            __nv_bfloat16* out, int m, int n, int k, int vec, void* stream) {
  if (int e = check_shape(m, n, k, kBM)) return e;
  if (vec && (k % 8 || n % 8 || !aligned16(x) || !aligned16(w) ||
              !aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_bf16<true>(x, w, out, m, n, k, s)
             : launch_bf16<false>(x, w, out, m, n, k, s);
}

const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
