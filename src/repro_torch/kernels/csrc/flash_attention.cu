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
// (4 * Dh per kept (query, key) pair: bf16 on the tensor cores, 989
// TFLOP/s; fp32 on CUDA cores, 67 TFLOP/s) against reading q, k, v and
// writing the output once at 3.35 TB/s.  Short query sets are bound by
// how many SMs the grid reaches, hence the split over K below.
//
// Both instances apply the TPU kernel's update in its order: s = q.k *
// scale; softcap (tanhf); mask to -1e30 (finite, so a row whose first tile
// is all masked sums exp(0) terms that the next tile's corr = exp(-1e30 -
// m) = 0 cancels, as on the TPU); m' = max(m, rowmax s); p = expf(s - m');
// l = l * exp(m - m') + rowsum p (fp32 p); acc = acc * exp(m - m') + p . V;
// out = acc / max(l, 1e-30).  Causal tiles whose first key lies past the
// tile's last query are skipped (the TPU condition kb * bk <= qb * bq + bq
// - 1 with this kernel's tiles), tail keys are masked, rows >= Sq are not
// written, and K/V head h / G is read in place (no G-fold broadcast).
// Query tiles are walked from the last, so the long causal rows start
// first.  No fast math.
//
// bf16 (fa_tc_kernel): 4 warps per (batch * query head, 64-row query
// tile), each warp owning 16 query rows.  QK^T and PV run on bf16
// mma.sync m16n8k16 with fp32 accumulation: Q and K fragments come from
// ldmatrix (K's rows are Dh-contiguous, already the .col B operand), V's
// from ldmatrix.trans, and P goes to PV straight from the score
// accumulator's registers, rounded to bf16 (l sums the fp32 p).  K/V
// tiles of 64 rows are staged with 16-byte cp.async into double-buffered
// shared memory (rows padded by 16 bytes, so ldmatrix's eight row
// addresses fall on distinct banks): tile t + 1 loads while tile t
// computes; the query tile loads once and, for Dh <= 128, stays in
// registers.  Where Dh * 2 bytes, a row stride or a base pointer is not a
// multiple of 16, the same kernel loads element by element into the same
// layout.  Dh is padded with zeros to 16, 32, 64, 128 or 256 in shared
// memory, as the fp32 kernel's (exact: the padded products are 0).  Scale, softcap and mask are
// separate passes over the score registers (each under one uniform
// branch), and at Dh <= 64 registers are capped at 128 a thread so four
// blocks share an SM (ptxas then spills a few bytes; on the card the two
// together were faster than one fused pass at three blocks an SM).  A
// warp whose 16 rows all lie past Sq skips the products.
//
// fp32 (fa_kernel): CUDA-core fmaf (tensor cores would be TF32): 256
// threads per (batch * query head, 64-row query tile); K/V tiles of 64
// rows (32 when Dh > 128) staged in shared memory; each thread keeps a
// 4-row slice of the accumulator and of the score tile in registers; the
// row max and sum are shuffles across the 16 threads of a row; Dh padded
// to 16, 32, 64, 128 or 256; a warp whose rows all lie past Sq skips the
// products.
//
// Split over K (flash decoding): when (batch * heads) * query tiles leave
// SMs idle, the wrapper asks for `splits` > 1.  Split i of nu = ceil(Sk /
// 64) 64-key units takes units [i nu / splits, (i + 1) nu / splits) and
// writes its rows' m, l and unnormalised acc (fp32) to scratch; a block
// whose units all lie past its causal limit does nothing.  fa_combine
// then merges the splits in a fixed order, for every row: m = max m_i;
// l = sum l_i exp(m_i - m); o = sum acc_i exp(m_i - m) / max(l, 1e-30).  A
// split whose keys are all masked for a row has m_i = -1e30, so its weight
// is exp(-1e30 - m) = 0; key 0 is kept for every row (causal masking is
// top-left aligned), so m is finite.  No atomics: the result is the same
// on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace wmma_sm90;

constexpr int kThreads = 256;     // fp32 instance
constexpr int kTcThreads = 128;   // bf16 instance: 4 warps
constexpr int kBQ = 64;           // query rows per block (both instances)
constexpr int kRQ = kBQ / 16;     // fp32: query rows per thread
constexpr int kUnit = 64;         // keys per split unit and per bf16 tile
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Where a block's keys start and end, in 64-key units: its split's units,
// clipped to its causal limit (units whose first key is <= the tile's last
// query row).  Empty (u0 >= u1) when the split lies wholly past the limit.
__device__ inline void split_units(int sk, int splits, int split,
                                   int q0, int causal, int* u0, int* u1) {
  const int nu = (sk + kUnit - 1) / kUnit;
  *u0 = (int)((long long)split * nu / splits);
  *u1 = (int)((long long)(split + 1) * nu / splits);
  if (causal) *u1 = min(*u1, (q0 + kBQ - 1) / kUnit + 1);
}

// Scratch of the split path, per split and row r = (b * heads + h) * sq +
// s: the unnormalised acc at part[((split * rows + r) * dh + c)], then m
// at part[splits * rows * dh + split * rows + r] and l rows * splits later.
struct Partials {
  float* part;
  int rows;       // b * heads * sq
  int splits;
  __device__ float* acc(int split, int r, int dh) const {
    return part + ((size_t)split * rows + r) * dh;
  }
  __device__ float* m(int split, int r, int dh) const {
    return part + (size_t)splits * rows * dh + (size_t)split * rows + r;
  }
  __device__ float* l(int split, int r, int dh) const {
    return m(split, r, dh) + (size_t)splits * rows;
  }
};

// ---------------------------------------------------------------------------
// fp32 instance: CUDA cores
// ---------------------------------------------------------------------------

// Shared memory of one block, in floats: the query tile, the K tile (rows
// padded by one float against bank conflicts), the V tile and the tile of
// probabilities.
__host__ __device__ constexpr int smem_floats(int dmax, int bk) {
  return kBQ * (dmax + 1) + bk * (dmax + 1) + bk * dmax + kBQ * (bk + 1);
}

template <int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, Partials pt,
          int sq,
          int sk, int kv, int g, int dh, int causal, float softcap,
          float scale) {
  constexpr int QS = DMAX + 1, KS = DMAX + 1, PS = BK + 1;
  constexpr int CK = BK / 16;     // score columns per thread
  constexpr int CD = DMAX / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [kBQ][QS]
  float* ks = qs + kBQ * QS;      // [BK][KS]
  float* vs = ks + BK * KS;       // [BK][DMAX]
  float* ps = vs + BK * DMAX;     // [kBQ][PS]

  const int heads = kv * g;
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads, kvh = h / g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int u0, u1;
  split_units(sk, pt.splits, blockIdx.z, q0, causal, &u0, &u1);
  if (u0 >= u1) return;
  const int t_begin = u0 * (kUnit / BK);
  const int k_tiles = min((sk + BK - 1) / BK, u1 * (kUnit / BK));
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Row strides: q/o rows hold every query head, k/v rows every KV head.
  const size_t q_row = (size_t)heads * dh, kv_row = (size_t)kv * dh;
  const float* qb = q + (size_t)b * sq * q_row + (size_t)h * dh;
  float* ob = o + (size_t)b * sq * q_row + (size_t)h * dh;
  const float* kb = k + (size_t)b * sk * kv_row + (size_t)kvh * dh;
  const float* vb = v + (size_t)b * sk * kv_row + (size_t)kvh * dh;

  for (int i = threadIdx.x; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX, s = q0 + r;
    qs[r * QS + c] = (s < sq && c < dh) ? qb[s * q_row + c] : 0.f;
  }

  float m[kRQ], l[kRQ], acc[kRQ][CD];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  for (int kt = t_begin; kt < k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int i = threadIdx.x; i < BK * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX, s = k0 + r;
      const bool in = s < sk && c < dh;
      ks[r * KS + c] = in ? kb[s * kv_row + c] : 0.f;
      vs[r * DMAX + c] = in ? vb[s * kv_row + c] : 0.f;
    }
    __syncthreads();

    // A warp's rows are ty + 16 i for its two ty, 2 w and 2 w + 1: when
    // the first lies past Sq the warp only helps load the tiles.
    const bool active = q0 + 2 * (int)(threadIdx.x / 32) < sq;
    if (active) {
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
          for (int j = 0; j < CK; ++j)
            sc[i][j] = fmaf(qv[i], kv_[j], sc[i][j]);
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
    }
    __syncthreads();

    if (active) {
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
          for (int j = 0; j < CD; ++j)
            acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= sq) continue;
    if (pt.splits == 1) {
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int c = tx + 16 * j;
        if (c < dh) ob[s * q_row + c] = acc[i][j] / li;
      }
    } else {
      const int r = bh * sq + s;
      float* pa = pt.acc(blockIdx.z, r, dh);
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const int c = tx + 16 * j;
        if (c < dh) pa[c] = acc[i][j];
      }
      if (tx == 0) {
        *pt.m(blockIdx.z, r, dh) = m[i];
        *pt.l(blockIdx.z, r, dh) = l[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 instance: tensor cores
// ---------------------------------------------------------------------------

// Shared memory of one block, in bf16 elements: the query tile and two
// stages of K and V, 64 rows each of DP + 8 (16 bytes of padding).
__host__ __device__ constexpr int tc_smem_elems(int dp) {
  return 5 * kUnit * (dp + 8);
}

// 64 rows [r0, r0 + 64) of a (rows, stride) bf16 matrix into dst[64][LD],
// zero past `limit` rows and past dh columns; cp.async in 16-byte chunks
// when `vec`, else element by element.
template <int DP>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             size_t stride, int r0, int limit,
                                             int dh, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;   // 16-byte chunks a row; 64 CH / 128 each
#pragma unroll
    for (int it = 0; it < kUnit * CH / kTcThreads; ++it) {
      const int i = threadIdx.x + it * kTcThreads;
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r0 + r < limit && c < dh;
      cp_async16(dst + r * LD + c,
                 in ? src + (size_t)(r0 + r) * stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kUnit * DP; i += kTcThreads) {
      const int r = i / DP, c = i % DP;
      const bool in = r0 + r < limit && c < dh;
      dst[r * LD + c] = in ? src[(size_t)(r0 + r) * stride + c]
                           : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 64 ? 4 : 1)
fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, Partials pt,
             int sq, int sk, int kv, int g, int dh, int causal,
             float softcap, float scale, int vec) {
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;       // k steps of QK^T
  constexpr int ND = DP / 8;        // 8-column tiles of the output
  constexpr bool kQRegs = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* ks = qs + kUnit * LD;                      // [2][64][LD]
  bf16* vs = ks + 2 * kUnit * LD;                  // [2][64][LD]

  const int heads = kv * g;
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads, kvh = h / g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int u0, u1;
  split_units(sk, pt.splits, blockIdx.z, q0, causal, &u0, &u1);
  if (u0 >= u1) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int qw = q0 + 16 * warp;    // the warp's first query row
  const size_t q_row = (size_t)heads * dh, kv_row = (size_t)kv * dh;
  const bf16* qb = q + (size_t)b * sq * q_row + (size_t)h * dh;
  bf16* ob = o + (size_t)b * sq * q_row + (size_t)h * dh;
  const bf16* kb = k + (size_t)b * sk * kv_row + (size_t)kvh * dh;
  const bf16* vb = v + (size_t)b * sk * kv_row + (size_t)kvh * dh;

  tc_load_tile<DP>(qs, qb, q_row, q0, sq, dh, vec);
  tc_load_tile<DP>(ks, kb, kv_row, u0 * kUnit, sk, dh, vec);
  tc_load_tile<DP>(vs, vb, kv_row, u0 * kUnit, sk, dh, vec);
  cp_async_commit();

  float acc[ND][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows gid, gid + 8
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[kQRegs ? KD : 1][4];
  // ldmatrix row addresses: A (Q) rows lane % 16, columns 8 (lane / 16);
  // B from K: keys lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2);
  // B from V (transposed): keys lane % 16, columns 8 (lane / 16).
  const bf16* q_frag = qs + (16 * warp + lane % 16) * LD + 8 * (lane / 16);
  const int k_off = (lane % 8 + 8 * (lane / 16)) * LD + 8 * ((lane / 8) % 2);
  const int v_off = (lane % 16) * LD + 8 * (lane / 16);

  for (int t = u0; t < u1; ++t) {
    const int st = (t - u0) & 1;
    if (t + 1 < u1) {
      bf16* kn = ks + (st ^ 1) * kUnit * LD;
      bf16* vn = vs + (st ^ 1) * kUnit * LD;
      tc_load_tile<DP>(kn, kb, kv_row, (t + 1) * kUnit, sk, dh, vec);
      tc_load_tile<DP>(vn, vb, kv_row, (t + 1) * kUnit, sk, dh, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile t (and the query tile) is in shared memory
    // A warp whose 16 rows all lie past Sq (short query sets) only
    // helps load the tiles.
    if (qw < sq) {
      if (kQRegs && t == u0) {
#pragma unroll
        for (int kd = 0; kd < (kQRegs ? KD : 1); ++kd)
          ldmatrix_x4(qf[kd], q_frag + 16 * kd);
      }
      const bf16* kst = ks + st * kUnit * LD;
      const bf16* vst = vs + st * kUnit * LD;

      // S (16 x 64 per warp) = Q K^T: 8 tiles of 8 keys.
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
        } else {
          ldmatrix_x4(a, q_frag + 16 * kd);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ldmatrix_x4(bb, kst + k_off + 16 * np * LD + 16 * kd);
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // Online softmax, in fp32, for rows gid (e = 0, 1) and gid + 8 (2, 3).
      const int k0 = t * kUnit;
      const bool masked = k0 + kUnit > sk || (causal && k0 + kUnit - 1 > qw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanhf(s[j][e] / softcap) * softcap;
      }
      if (masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * tig + (e & 1);
            const int row = qw + gid + 8 * (e >> 1);
            if (!(key < sk && (!causal || key <= row))) s[j][e] = kNegInf;
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // The four threads of a row are lanes 4 gid .. 4 gid + 3.
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_cur = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_cur);
        m[r] = m_cur;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
      // Each thread keeps its own columns' share of l; the shares are
      // summed across the row's four threads at the end.
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // acc += P V.  P's A fragments for keys 16 kc .. 16 kc + 15 are the
      // score tiles 2 kc and 2 kc + 1, packed to bf16 first so the fp32
      // scores are dead before the products (16 registers, not 32).
      uint32_t pf[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        pf[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pf[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pf[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pf[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vst + v_off + 16 * kc * LD + 16 * dp);
          mma_bf16(acc[2 * dp], pf[kc], bb[0], bb[1]);
          mma_bf16(acc[2 * dp + 1], pf[kc], bb[2], bb[3]);
        }
    }
    __syncthreads();   // every warp is done with stage st
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = qw + gid + 8 * r;
    if (s_row >= sq) continue;
    if (pt.splits == 1) {
      const float li = fmaxf(l[r], 1e-30f);
      bf16* orow = ob + (size_t)s_row * q_row;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = 8 * n + 2 * tig;
        if (c < dh) orow[c] = __float2bfloat16_rn(acc[n][2 * r] / li);
        if (c + 1 < dh)
          orow[c + 1] = __float2bfloat16_rn(acc[n][2 * r + 1] / li);
      }
    } else {
      const int rr = bh * sq + s_row;
      float* pa = pt.acc(blockIdx.z, rr, dh);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = 8 * n + 2 * tig;
        if (c < dh) pa[c] = acc[n][2 * r];
        if (c + 1 < dh) pa[c + 1] = acc[n][2 * r + 1];
      }
      if (tig == 0) {
        *pt.m(blockIdx.z, rr, dh) = m[r];
        *pt.l(blockIdx.z, rr, dh) = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Combine of the splits: one block per output row, splits in order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
fa_combine(Partials pt, T* __restrict__ o, int sq, int sk, int heads, int dh,
           int causal) {
  const int r = blockIdx.x;            // (b * heads + h) * sq + s
  const int bh = r / sq, s = r % sq;
  const int b = bh / heads, h = bh % heads;
  // The splits this row's block ran: those with keys before its causal
  // limit (split_units is non-empty for them).
  int n = 0;
  for (; n < pt.splits; ++n) {
    int u0, u1;
    split_units(sk, pt.splits, n, (s / kBQ) * kBQ, causal, &u0, &u1);
    if (u0 >= u1) break;
  }
  // Unrolled so that the loads of several splits are in flight at once;
  // the sums still run over the splits in order.
  float m = kNegInf;
#pragma unroll 4
  for (int i = 0; i < n; ++i) m = fmaxf(m, *pt.m(i, r, dh));
  float l = 0.f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) l += *pt.l(i, r, dh) * expf(*pt.m(i, r, dh) - m);
  const float li = fmaxf(l, 1e-30f);
  T* orow = o + ((size_t)b * sq + s) * heads * dh + (size_t)h * dh;
  for (int c = threadIdx.x; c < dh; c += kCombineThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i)
      acc += pt.acc(i, r, dh)[c] * expf(*pt.m(i, r, dh) - m);
    store(orow + c, acc / li);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Padded head dims of both instances: 16, 32, 64, 128 or 256.  0 when
// unsupported.
int dmax_for(int dh) {
  if (dh < 1) return 0;
  for (int d = 16; d <= 256; d *= 2)
    if (dh <= d) return d;
  return 0;
}
int bk_for(int dmax) { return dmax > 128 ? 32 : 64; }

struct Args {
  const void *q, *k, *v;
  void* o;
  Partials pt;
  int sq, sk, kv, g, dh, causal;
  float softcap, scale;
  dim3 grid;
  cudaStream_t stream;
};

template <typename T>
int combine(const Args& a) {
  if (a.pt.splits == 1) return 0;
  fa_combine<T><<<(unsigned)a.pt.rows, kCombineThreads, 0, a.stream>>>(
      a.pt, static_cast<T*>(a.o), a.sq, a.sk, a.kv * a.g, a.dh, a.causal);
  return (int)cudaGetLastError();
}

template <int DMAX, int BK>
int launch_f32(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats(DMAX, BK);
  static unsigned long long done = 0;
  if (int e = allow_smem(fa_kernel<DMAX, BK>, smem, &done)) return e;
  fa_kernel<DMAX, BK><<<a.grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.pt, a.sq,
      a.sk, a.kv, a.g, a.dh, a.causal, a.softcap, a.scale);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : combine<float>(a);
}

template <int DP>
int launch_tc(const Args& a) {
  const size_t smem = sizeof(bf16) * tc_smem_elems(DP);
  static unsigned long long done = 0;
  if (int e = allow_smem(fa_tc_kernel<DP>, smem, &done)) return e;
  // cp.async needs 16-byte rows, row strides and base pointers.
  const bool vec = a.dh % 8 == 0 && (uintptr_t)a.q % 16 == 0 &&
                   (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0;
  fa_tc_kernel<DP><<<a.grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.pt, a.sq,
      a.sk, a.kv, a.g, a.dh, a.causal, a.softcap, a.scale, (int)vec);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : combine<bf16>(a);
}

int launch_fp32(const Args& a) {
  switch (dmax_for(a.dh)) {
    case 16: return launch_f32<16, 64>(a);
    case 32: return launch_f32<32, 64>(a);
    case 64: return launch_f32<64, 64>(a);
    case 128: return launch_f32<128, 64>(a);
    case 256: return launch_f32<256, 32>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_bf16(const Args& a) {
  switch (dmax_for(a.dh)) {
    case 16: return launch_tc<16>(a);
    case 32: return launch_tc<32>(a);
    case 64: return launch_tc<64>(a);
    case 128: return launch_tc<128>(a);
    case 256: return launch_tc<256>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`.  q and o: (b, sq, kv * g, dh)
// row-major; k and v: (b, sk, kv, dh); dtype 0 = fp32, 1 = bf16 for all
// four; softcap 0 = none.  splits > 1 runs the split over K and the
// combine; `scratch` then holds splits * b * kv * g * sq * (dh + 2) fp32
// (ignored for one split).  Returns a cudaError_t (0 on success).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               void* scratch, int dtype, int b, int sq, int sk, int kv, int g,
               int dh, int causal, float softcap, int splits, void* stream) {
  const long long heads = (long long)b * kv * g;
  if (b < 1 || sq < 1 || sk < 1 || kv < 1 || g < 1 || dh < 1 || dh > 256 ||
      softcap < 0.f || heads > 0x7fffffffLL || splits < 1 ||
      splits > (sk + kUnit - 1) / kUnit || splits > 65535 ||
      (splits > 1 && (scratch == nullptr || heads * sq > 0x7fffffffLL)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.pt = Partials{static_cast<float*>(scratch), (int)(heads * sq), splits};
  a.sq = sq;
  a.sk = sk;
  a.kv = kv;
  a.g = g;
  a.dh = dh;
  a.causal = causal;
  a.softcap = softcap;
  // 1 / sqrt(dh) in double, rounded once to fp32, as the JAX kernel's
  // Python-float scale is.
  a.scale = (float)(1.0 / sqrt((double)dh));
  // grid.y > 65535 (Sq > 4,194,240) is refused by the launch itself.
  a.grid = dim3((unsigned)heads, (unsigned)((sq + kBQ - 1) / kBQ),
                (unsigned)splits);
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fp32(a);
  if (dtype == 1) return launch_bf16(a);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block for head dim dh and dtype (0 fp32, 1 bf16),
// in bytes; 0 if unsupported.
long long fa_smem_bytes(int dh, int dtype) {
  if (dtype == 0) {
    const int dmax = dmax_for(dh);
    return dmax ? (long long)sizeof(float) * smem_floats(dmax, bk_for(dmax))
                : 0;
  }
  if (dtype == 1) {
    const int dp = dmax_for(dh);
    return dp ? (long long)sizeof(bf16) * tc_smem_elems(dp) : 0;
  }
  return 0;
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
