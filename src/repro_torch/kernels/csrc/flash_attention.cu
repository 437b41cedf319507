// Flash attention (online softmax, no score matrix in device memory), for
// sm_90a (H100).
//
// Replaces repro/kernels/flash_attention.py flash_attention_bh (kernel 6,
// pallas_call at flash_attention.py:113, body _flash_kernel) and its GQA
// wrapper flash_attention: for each (batch, query head) and query row,
// softmax(q . K^T * Dh^-1/2 [softcapped, masked]) . V, with fp32 scores,
// running max, normaliser and accumulator, and the output in the inputs'
// type (fp32 or bf16).
//
// What bounds it on this card: operations at the sizes that matter
// (4 * Dh per kept (query, key) pair, on fp32 CUDA cores here, 67 TFLOP/s;
// the bf16 bound is the tensor cores' 989 TFLOP/s) against reading q, k, v
// and writing the output once at 3.35 TB/s.
//
// Design (simple first): one block of 256 threads per (batch * query head,
// 64-row query tile); the TPU's sequential K grid axis is a loop inside the
// block over K/V tiles of 64 rows (32 when Dh > 128), staged in shared
// memory and widened to fp32.  The query tile stays in shared memory, each
// thread keeps a 4-row slice of the accumulator (rows ty + 16 i, columns
// tx + 16 j) and of the score tile in registers; the row max and sum are
// shuffles across the 16 threads of a row.  The update is the TPU
// kernel's, in its order: s = q.k * scale; softcap; mask to -1e30 (finite,
// so a row whose first tile is all masked sums exp(0) terms that the next
// tile's corr = exp(-1e30 - m) = 0 cancels, as on the TPU); m' = max(m,
// rowmax s); p = exp(s - m'); l = l * exp(m - m') + rowsum p; acc = acc *
// exp(m - m') + p . V; out = acc / max(l, 1e-30).  Causal tiles whose first
// key lies past the tile's last query are skipped (the TPU condition
// kb * bk <= qb * bq + bq - 1 with this kernel's tiles).  K/V head h / G is
// read in place: no G-fold broadcast.  Head dims are padded with zeros to
// 16, 32, 64, 128 or 256 in shared memory (exact: the padded products are
// 0).  CUDA-core fmaf, expf and tanhf (no fast math, no tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows per block
constexpr int kRQ = kBQ / 16;     // query rows per thread
constexpr float kNegInf = -1e30f;

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared memory of one block, in floats: the query tile, the K tile (rows
// padded by one float against bank conflicts), the V tile and the tile of
// probabilities.
__host__ __device__ constexpr int smem_floats(int dmax, int bk) {
  return kBQ * (dmax + 1) + bk * (dmax + 1) + bk * dmax + kBQ * (bk + 1);
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
          int kv, int g, int dh, int causal, float softcap, float scale) {
  constexpr int QS = DMAX + 1, KS = DMAX + 1, PS = BK + 1;
  constexpr int CK = BK / 16;     // score columns per thread
  constexpr int CD = DMAX / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [kBQ][QS]
  float* ks = qs + kBQ * QS;      // [BK][KS]
  float* vs = ks + BK * KS;       // [BK][DMAX]
  float* ps = vs + BK * DMAX;     // [kBQ][PS]

  const int heads = kv * g;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads, kvh = h / g;
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Row strides: q/o rows hold every query head, k/v rows every KV head.
  const size_t q_row = (size_t)heads * dh, kv_row = (size_t)kv * dh;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)h * dh;
  T* ob = o + (size_t)b * sq * q_row + (size_t)h * dh;
  const T* kb = k + (size_t)b * sk * kv_row + (size_t)kvh * dh;
  const T* vb = v + (size_t)b * sk * kv_row + (size_t)kvh * dh;

  for (int i = threadIdx.x; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX, s = q0 + r;
    qs[r * QS + c] = (s < sq && c < dh) ? to_float(qb[s * q_row + c]) : 0.f;
  }

  float m[kRQ], l[kRQ], acc[kRQ][CD];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  int k_tiles = (sk + BK - 1) / BK;
  if (causal) k_tiles = min(k_tiles, (q0 + kBQ - 1) / BK + 1);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int i = threadIdx.x; i < BK * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX, s = k0 + r;
      const bool in = s < sk && c < dh;
      ks[r * KS + c] = in ? to_float(kb[s * kv_row + c]) : 0.f;
      vs[r * DMAX + c] = in ? to_float(vb[s * kv_row + c]) : 0.f;
    }
    __syncthreads();

    float sc[kRQ][CK];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float qv[kRQ], kv_[CK];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv_[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qv[i], kv_[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool keep = kj < sk && (!causal || kj <= qi);
        sc[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      // The 16 threads of a row are one half of a warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(sc[i][j] - m_cur);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_cur);
      l[i] = l[i] * corr + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRQ], vv[CD];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = vs[c * DMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int c = tx + 16 * j;
      if (c < dh) store(ob + s * q_row + c, acc[i][j] / li);
    }
  }
}

// Padded head dim and K tile rows for a head dim; 0 when unsupported.
int dmax_for(int dh) {
  if (dh < 1) return 0;
  for (int d = 16; d <= 256; d *= 2)
    if (dh <= d) return d;
  return 0;
}
int bk_for(int dmax) { return dmax > 128 ? 32 : 64; }

template <typename T, int DMAX, int BK>
int launch_t(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int kv, int g, int dh, int causal,
             float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(DMAX, BK);
  cudaError_t e = cudaFuncSetAttribute(
      fa_kernel<T, DMAX, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // grid.y > 65535 (Sq > 4,194,240) is refused by the launch itself.
  const dim3 grid((unsigned)(b * kv * g), (unsigned)((sq + kBQ - 1) / kBQ));
  // 1 / sqrt(dh) in double, rounded once to fp32, as the JAX kernel's
  // Python-float scale is.
  const float scale = (float)(1.0 / sqrt((double)dh));
  fa_kernel<T, DMAX, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, kv, g, dh,
      causal, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int kv, int g, int dh, int causal, float softcap,
           cudaStream_t s) {
  switch (dmax_for(dh)) {
    case 16: return launch_t<T, 16, 64>(q, k, v, o, b, sq, sk, kv, g, dh,
                                        causal, softcap, s);
    case 32: return launch_t<T, 32, 64>(q, k, v, o, b, sq, sk, kv, g, dh,
                                        causal, softcap, s);
    case 64: return launch_t<T, 64, 64>(q, k, v, o, b, sq, sk, kv, g, dh,
                                        causal, softcap, s);
    case 128: return launch_t<T, 128, 64>(q, k, v, o, b, sq, sk, kv, g, dh,
                                          causal, softcap, s);
    case 256: return launch_t<T, 256, 32>(q, k, v, o, b, sq, sk, kv, g, dh,
                                          causal, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`.  q and o: (b, sq, kv * g, dh)
// row-major; k and v: (b, sk, kv, dh); dtype 0 = fp32, 1 = bf16 for all
// four; softcap 0 = none.  Returns a cudaError_t (0 on success).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               int dtype, int b, int sq, int sk, int kv, int g, int dh,
               int causal, float softcap, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kv < 1 || g < 1 || !dmax_for(dh) ||
      softcap < 0.f || (long long)b * kv * g > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, b, sq, sk, kv, g, dh, causal, softcap,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, b, sq, sk, kv, g, dh, causal,
                                 softcap, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block for head dim dh (bytes); 0 if unsupported.
long long fa_smem_bytes(int dh) {
  const int dmax = dmax_for(dh);
  return dmax ? (long long)sizeof(float) * smem_floats(dmax, bk_for(dmax))
              : 0;
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
