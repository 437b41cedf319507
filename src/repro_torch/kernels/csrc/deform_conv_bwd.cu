// Fused backward of the bounded deformable convolution, fp32 and bf16, for
// sm_90a.
//
// Replaces the TPU kernel of repro/kernels/deform_conv_bwd.py
// deform_conv_bwd_zerocopy (:241; pallas_call at :304, body
// _bwd_zerocopy_kernel at :88), in both its instances: fp32 inputs, and
// bf16 x_pad, g and w (the offsets fp32 or bf16), whose values the TPU
// kernel converts to fp32 before all its math (:150-170).
//
// What it computes, for the cotangent g of y = deform_conv(x, off, w):
//   P[p, tap, c]  = bilinear(x_pad[c], pos(p, tap))          (recomputed)
//   dw[tap, c, m] = sum_p P[p, tap, c] * g[p, m]
//   dP[p, tap, c] = sum_m g[p, m] * w[tap, c, m]
//   d_off[p, tap] = sum_c dP * (dval/dpos_y, dval/dpos_x), zero where
//                   |raw offset| > B (the clamp's VJP, inclusive at +-B)
//   dx_pad        = the four bilinear corners of every tap, weighted by
//                   dP, scattered into the zero-padded plane
// with dval/dpos_y = (1-tx)(v10-v00) + tx(v11-v01) and
//      dval/dpos_x = (1-ty)(v01-v00) + ty(v11-v10),
// the band-local positions of deform_conv_fused.cu, so the corners and
// coefficients are the forward's.  Pixels of the ragged edge (outside
// Ho x Wo) contribute nothing to any output.
//
// What bounds it on this card: operations.  Two products of 2*P*K*K*C*M
// flops each (dw and dP), against moving x, the offsets, g, the weights
// and the three outputs once.  Both run on the tensor cores as split-fp32
// products ("3xTF32", warp_mma.cuh: a = hi + lo with hi, lo tf32, and
// a.b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32), which keeps fp32
// accuracy (~2^-22 relative a product) at three tf32 mma.sync each, so
// the bound is 3 * 4 * P*K*K*C*M flops over the dense TF32 rate.  A
// single-pass TF32 product (~2^-11) would not meet the fp32 contract.
//
// Design.  The TPU kernel walks a sequential grid and carries two sums
// across it: d_input through read-modify-writes of overlapping bands and
// d_weights in a scratch accumulator.  CUDA blocks run concurrently, so
// the two reductions are split into kernels of their own:
//   * dcb_input_kernel: one block of 8 warps per (output tile, group of
//     C chunks).  The tile grid alone can leave the card half empty (64
//     tiles of 4 x 8 at 16 x 16 outputs and batch 8), so the chunks are
//     split into groups until the grid holds two blocks an SM in waves
//     that are nearly full (tiling.bwd_c_groups).  A block first sorts
//     its tile's 4 K*K corners per pixel by band position (counting sort
//     with shared integer atomics), once for all its chunks.  Per chunk:
//       - dP^T = g W^T on the tensor cores.  M streams through shared
//         memory in steps of 16 channels, three steps in flight
//         (cp.async; one barrier a step).  The dP^T tile (pixels x
//         K*K*tile_c rows, padded so the 16 x 8 mma tiles divide evenly)
//         is spread over the 8 warps, the same number of tiles each;
//         where the count is not a multiple of 8, two groups of four
//         warps take alternate halves of every step and add their sums
//         in a fixed order.  dP then replaces the steps in shared memory.
//       - d_off: a pair's (tap, pixel) channels on consecutive lanes
//         (float4 reads of the band, channels innermost), each lane's
//         terms summed over the pair's lanes by a fixed shuffle tree into
//         a per-pair sum carried across the chunks.  No atomics, so
//         d_off is the same bit for bit from call to call; with more than
//         one C group each group writes a partial that
//         dcb_doff_reduce_kernel adds in group order and masks.
//       - d_input: each (band position, channel) gathers the weighted dP
//         of the corners sorted onto it and adds the sum to the zeroed
//         dx_pad with one global fp32 atomic (neighbouring tiles overlap
//         in their Eq. 6 halos).
//     Blocks of group 0 also write the tile's corner geometry for the
//     d_weights kernel.
//   * dcb_weight_kernel: one block of 8 warps per (C chunk, 144 rows of
//     K*K*tile_c, 128 output channels, pixel split).  It walks its share
//     of the output tiles: the next tile's band (and, up to 32 pixel
//     lanes, its g) is copied (cp.async) while this tile's patch rows are
//     rebuilt from the band and the stored geometry (four channels a
//     thread) and dw^T += g^T P runs on the tensor cores.  The splits
//     are chosen like the C groups (tiling.bwd_dw_splits); their partials
//     go to a scratch buffer that dcb_reduce_kernel adds in a fixed
//     order, so d_weights too is the same bit for bit.
// d_input is not bit for bit (fp32 atomics and the sort's order vary from
// run to run), within 1e-4 relative of the plain version.  Copies are 16
// bytes where the layout allows (the wrapper's `vec` bits: W and g when M
// is a multiple of 4, the band when tile_c and C are, 16-byte aligned
// pointers), else element by element.
//
// The bf16 instance (T = __nv_bfloat16) stages the bf16 band, W and g as
// they are (no fp32 copy in device memory).  Its copies move 4 channels of
// W and g (8 bytes) and 8, 4 or 2 channels of the band (16, 8 or 4 bytes)
// where the layout allows, else one bf16 element by a plain load
// (cp.async has no 2-byte form).  Its products need fewer tensor-core
// passes: dP = g W^T is one bf16 m16n8k16 mma a 16-channel step (bf16
// times bf16 is exact in the fp32 sum), dw^T = g^T P two tf32 passes (P
// split into tf32 hi and lo, as in fp32; g is exact in tf32).  Every other
// value is converted to fp32 where it is read.  d_input still adds in
// fp32, into a zeroed fp32 workspace, and is rounded once to bf16 at the
// end (dcb_round_kernel); d_offsets is rounded once to the offsets' dtype
// and d_weights stays fp32.  (The TPU kernel instead adds each tile's band
// into a bf16 dx_pad, rounding an overlapping halo once per visit; the
// single rounding is the more accurate, tests/test_torch_bf16_dcl.py.)
// Its bound is those products at their dense rates: 2*P*K*K*C*M flops at
// the bf16 rate and twice that at the TF32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "dcl_staging.cuh"
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dcl_staging::band_unit;
using dcl_staging::kVecBand;
using dcl_staging::kVecBand2;
using dcl_staging::kVecBand8;
using dcl_staging::load_off;
using wmma_sm90::bf16_hi;
using wmma_sm90::bf16_lo;
using wmma_sm90::copy4;
using wmma_sm90::copy_elems;
using wmma_sm90::cp_async8;
using wmma_sm90::cp_async_commit;
using wmma_sm90::cp_async_wait;
using wmma_sm90::mma_3xtf32;
using wmma_sm90::mma_bf16;
using wmma_sm90::mma_tf32;
using wmma_sm90::split_tf32;
using wmma_sm90::to_f;

constexpr int kThreads = 256;    // threads of every block (8 warps)
constexpr int kMS = 16;          // output channels of W and g per dP step
constexpr int kStages = 3;       // W / g steps in flight (cp.async)
constexpr int kLdS = kMS + 4;    // row stride of a W / g step (floats)
constexpr int kMaxWarpTiles = 9; // dP^T mma tiles (16 x 8) a warp keeps
constexpr int kRB = 144;         // rows of K*K*tile_c per d_weights block
constexpr int kMB = 128;         // output channels per d_weights block
constexpr int kLdG = kMB + 8;    // row stride of d_weights' g tile
constexpr int kLdP = kRB + 8;    // row stride of d_weights' patch tile
constexpr int kMaxSmem = 232448; // 227 KB, the opt-in ceiling
constexpr int kVecWG = 1;        // vec bit: W and g 4 channels a copy

struct Geometry {
  int n, hp, wp, c, ho, wo, m;
  int k, s, d, hb;
  float bound;
  int th, tw, tc;
  int band_h, band_w, h_tiles, w_tiles;
  int off_bf16;                  // the offsets (and d_offsets) in bf16
};

__host__ __device__ inline int round_up(int v, int u) {
  return (v + u - 1) / u * u;
}
// The band chunk: positions of the Eq. 6 band, tile_c channels innermost,
// rounded to 16 bytes.
template <typename T>
__host__ __device__ inline int band_bytes(const Geometry& g) {
  return round_up((int)sizeof(T) * g.band_h * g.band_w * g.tc, 16);
}
__host__ __device__ inline int kk_rows(const Geometry& g) {
  return g.k * g.k * g.tc;
}
// d_input: rows of K*K*tile_c padded so that the (pix / 16) x (rows / 8)
// mma tiles are a multiple of 4, hence split evenly over 8 warps in one
// or two groups (k_split).
__host__ __device__ inline int rows_pad(const Geometry& g, int pix) {
  return round_up(kk_rows(g), 512 / pix);
}
__host__ __device__ inline int mma_tiles(const Geometry& g, int pix) {
  return (pix / 16) * (rows_pad(g, pix) / 8);
}
__host__ __device__ inline int k_split(const Geometry& g, int pix) {
  return mma_tiles(g, pix) % 8 ? 2 : 1;
}
__host__ __device__ inline int warp_tiles(const Geometry& g, int pix) {
  return mma_tiles(g, pix) * k_split(g, pix) / 8;
}
// Row stride of the dP chunk (dP[pixel][row]): 8 or 24 modulo 32, so the
// warps' float2 stores of their fragments take two wavefronts.
__host__ __device__ inline int dp_ld(const Geometry& g, int pix) {
  const int rp = rows_pad(g, pix);
  return rp + (rp % 16 == 0 ? 8 : 16);
}
// d_input's W / g steps (kStages of them in flight, in T), which the fp32
// dP chunk reuses once a chunk's products are done (bytes).
template <typename T>
__host__ __device__ inline int union_bytes(const Geometry& g, int pix) {
  const int steps = (int)sizeof(T) * kStages * (rows_pad(g, pix) + pix) * kLdS;
  const int dp = 4 * pix * dp_ld(g, pix);
  return steps > dp ? steps : dp;
}

// dcb_input_kernel: the band chunk, the W / g steps or the dP chunk, and
// per tile: the corner geometry (index, ty, tx) and the two d_off sums of
// every (tap, pixel), the four corners of each as (dP offset, weight)
// entries sorted by band position, and the positions' entry starts and
// dx_pad offsets.
template <typename T>
inline size_t input_smem_bytes(const Geometry& g, int pix) {
  const size_t pairs = (size_t)g.k * g.k * pix;
  const size_t npos = (size_t)g.band_h * g.band_w;
  return (size_t)band_bytes<T>(g) + (size_t)union_bytes<T>(g, pix) +
         4 * (13 * pairs + 2 * npos + 1);
}

// dcb_weight_kernel's g tiles: double-buffered up to 32 pixel lanes,
// single at 64 (two blocks an SM still fit).
__host__ __device__ constexpr int g_buffers(int pix) {
  return pix <= 32 ? 2 : 1;
}

// dcb_weight_kernel: two bands (double-buffered), the tap and channel of
// each of its rows, the g tiles (in T) and the fp32 patch tile.
template <typename T>
inline size_t weight_smem_bytes(const Geometry& g, int pix) {
  return 2 * (size_t)band_bytes<T>(g) + 8 * kRB +
         (size_t)pix * (sizeof(T) * g_buffers(pix) * kLdG + 4 * kLdP);
}

__device__ inline void store_off(void* d_off, size_t i, float v, int bf) {
  if (bf)
    static_cast<bf16*>(d_off)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(d_off)[i] = v;
}

// Two consecutive bf16 values (4-byte aligned) as one mma register.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four elements of T (8-byte aligned for bf16, 16 for fp32) as floats.
__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float4 load4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}

// Four elements of T to dst, of which the first `count` (clamped to 0..4)
// come from src and the rest are zero: one copy of 4 * sizeof(T) bytes
// when `vec`, else element by element; src is not read past count.
__device__ inline void copy4t(float* dst, const float* src, int count,
                              bool vec) {
  copy4(dst, src, count, vec);
}
__device__ inline void copy4t(bf16* dst, const bf16* src, int count,
                              bool vec) {
  count = count < 0 ? 0 : count > 4 ? 4 : count;
  if (vec) {
    cp_async8(dst, src, 2 * count);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      copy_elems(dst + e, e < count ? src + e : src, 1, e < count);
  }
}

__device__ inline bool pixel_in(const Geometry& g, int jt, int wt, int p,
                                int* oy, int* ox) {
  if (p >= g.th * g.tw) return false;
  *oy = jt * g.th + p / g.tw;
  *ox = wt * g.tw + p % g.tw;
  return *oy < g.ho && *ox < g.wo;
}

// Band-local corner geometry of every (tap, pixel) of tile (jt, wt), as
// deform_conv_fused.cu computes it: gidx/gty/gtx[tap * pix + p]; index -1
// marks a pixel outside Ho x Wo.
__device__ inline void tile_geometry(const void* __restrict__ off,
                                     const Geometry& g, int n, int jt,
                                     int wt, int pix, int tid, int* gidx,
                                     float* gty, float* gtx) {
  const int k2 = g.k * g.k;
  for (int i = tid; i < k2 * pix; i += kThreads) {
    const int kt = i / pix, p = i % pix;
    int idx = -1, oy, ox;
    float fy = 0.f, fx = 0.f;
    if (pixel_in(g, jt, wt, p, &oy, &ox)) {
      const int t = p / g.tw, u = p % g.tw;
      const size_t o =
          (((size_t)n * g.ho + oy) * g.wo + ox) * (2 * k2) + 2 * kt;
      const float dy =
          fminf(fmaxf(load_off(off, o, g.off_bf16), -g.bound), g.bound);
      const float dx =
          fminf(fmaxf(load_off(off, o + 1, g.off_bf16), -g.bound), g.bound);
      const float py = (float)(t * g.s + g.hb + (kt / g.k) * g.d) + dy;
      const float px = (float)(u * g.s + g.hb + (kt % g.k) * g.d) + dx;
      const float y0 = floorf(py), x0 = floorf(px);
      fy = py - y0;
      fx = px - x0;
      idx = (int)y0 * g.band_w + (int)x0;
    }
    gidx[i] = idx;
    gty[i] = fy;
    gtx[i] = fx;
  }
}

// Channels [c0, c0 + tc) of the band of tile (jt, wt) into shared memory,
// position-major with the channels innermost (band[pos * tc + ch]), `unit`
// channels a copy (band_unit).
template <typename T>
__device__ inline void stage_band(const T* __restrict__ x_pad,
                                  const Geometry& g, int n, int jt, int wt,
                                  int c0, int tid, T* band, int unit) {
  const int row0 = jt * g.th * g.s, col0 = wt * g.tw * g.s;
  const int per = g.tc / unit;              // copies a position
  const int total = g.band_h * g.band_w * per;
  for (int i = tid; i < total; i += kThreads) {
    const int pos = i / per, e = i - pos * per;
    const int r = pos / g.band_w, q = pos - r * g.band_w;
    const T* src =
        x_pad + (((size_t)n * g.hp + row0 + r) * g.wp + col0 + q) * g.c + c0;
    copy_elems(band + pos * g.tc + unit * e, src + unit * e, unit, true);
  }
}

template <typename T, int PIX>
__global__ void __launch_bounds__(kThreads, 2)
dcb_input_kernel(const T* __restrict__ x_pad, const void* __restrict__ off,
                 const T* __restrict__ gy, const T* __restrict__ w_tiles,
                 float* __restrict__ dx_pad, void* __restrict__ d_off,
                 float* __restrict__ geom, Geometry g, int groups, int vec) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k2 = g.k * g.k;
  const int tc = g.tc;
  const int kk_n = kk_rows(g);
  const int rp = rows_pad(g, PIX);
  const int ldr = dp_ld(g, PIX);
  const int bw = g.band_w * tc;              // a band row, in elements
  const int npos = g.band_h * g.band_w;      // band positions
  const int pairs = k2 * PIX;                // (tap, pixel) pairs
  T* band = reinterpret_cast<T*>(smem);
  unsigned char* un = smem + band_bytes<T>(g);
  T* ws = reinterpret_cast<T*>(un);          // [kStages][rp][kLdS]
  T* gs = ws + kStages * rp * kLdS;          // [kStages][PIX][kLdS]
  float* dP = reinterpret_cast<float*>(un);  // [PIX][ldr], after a chunk
  float* gty = reinterpret_cast<float*>(un + union_bytes<T>(g, PIX));
  float* gtx = gty + pairs;
  int* gidx = reinterpret_cast<int*>(gtx + pairs);
  float* doff = reinterpret_cast<float*>(gidx + pairs);   // [pairs][2]
  int* eoff = reinterpret_cast<int*>(doff + 2 * pairs);   // [4 pairs]
  float* ew = reinterpret_cast<float*>(eoff + 4 * pairs); // [4 pairs]
  int* estart = reinterpret_cast<int*>(ew + 4 * pairs);   // [npos + 1]
  int* pos_at = estart + npos + 1;                        // [npos]

  const int per_image = g.h_tiles * g.w_tiles;
  const int tile = blockIdx.x;
  const int n = tile / per_image;
  const int jt = (tile % per_image) / g.w_tiles;
  const int wt = tile % g.w_tiles;
  const int row0 = jt * g.th * g.s;
  const int col0 = wt * g.tw * g.s;
  const int grp = blockIdx.y;
  const int chunks = g.c / tc;
  const int cs0 = grp * chunks / groups, cs1 = (grp + 1) * chunks / groups;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool vwg = vec & kVecWG;
  const int unit = band_unit(vec);

  // This warp's dP^T tiles: k-split group, pixel tile, first 8-row tile.
  const int ks = k_split(g, PIX);
  const int tpw = warp_tiles(g, PIX);
  const int wg = 8 / ks;
  const int kgrp = warp / wg, wi = warp % wg;
  const int per_pt = (rp / 8) / tpw;         // warps per 16-pixel tile
  const int pt = wi / per_pt;
  const int j0 = (wi % per_pt) * tpw;
  // The d_off pass: a pair's channels on consecutive lanes, vw of them a
  // lane (four where tile_c allows float4 reads), seg lanes a pair, spw
  // pairs a warp at once, far apart in the pair order; o_top: the first
  // step of the segment's reduction.
  const int vw = tc % 4 == 0 ? 4 : 1;
  const int seg = tc / vw < 32 ? tc / vw : 32;
  const int spw = 32 / seg;
  const int sub = lane / seg, li = lane - sub * seg;
  const int per_slot = (pairs + spw - 1) / spw;
  int o_top = 0;
  while (2 * o_top < seg) o_top = o_top ? 2 * o_top : 1;

  // The tile's geometry, then its corners sorted by band position: count
  // (shared integer atomics), scan, place.  The order within a position
  // varies from run to run; only d_input's sums depend on it.
  tile_geometry(off, g, n, jt, wt, PIX, tid, gidx, gty, gtx);
  for (int i = tid; i < 2 * pairs; i += kThreads) doff[i] = 0.f;
  for (int i = tid; i <= npos; i += kThreads) estart[i] = 0;
  __syncthreads();
  if (grp == 0) {
    float* gm = geom + (size_t)tile * 3 * pairs;
    for (int i = tid; i < pairs; i += kThreads) {
      gm[i] = __int_as_float(gidx[i]);
      gm[pairs + i] = gty[i];
      gm[2 * pairs + i] = gtx[i];
    }
  }
  const int corner[4] = {0, 1, g.band_w, g.band_w + 1};
  for (int i = tid; i < pairs; i += kThreads) {
    const int idx = gidx[i];
    if (idx < 0) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) atomicAdd(estart + idx + corner[k] + 1, 1);
  }
  __syncthreads();
  if (warp == 0) {  // inclusive scan of estart[1..npos], 32 runs a lane
    const int run = (npos + 31) / 32;
    const int lo = 1 + lane * run, hi = min(lo + run, npos + 1);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += estart[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    int acc_s = incl - sum;
    for (int i = lo; i < hi; ++i) {
      acc_s += estart[i];
      estart[i] = acc_s;
    }
  }
  __syncthreads();
  for (int i = tid; i < npos; i += kThreads) {
    pos_at[i] = estart[i];  // the cursors, for now
  }
  __syncthreads();
  for (int i = tid; i < pairs; i += kThreads) {
    const int idx = gidx[i];
    if (idx < 0) continue;
    const int kt = i / PIX, p = i % PIX;
    const float ty = gty[i], tx = gtx[i];
    const float w[4] = {(1.f - ty) * (1.f - tx), (1.f - ty) * tx,
                        ty * (1.f - tx), ty * tx};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = atomicAdd(pos_at + idx + corner[k], 1);
      eoff[e] = p * ldr + kt * tc;
      ew[e] = w[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < npos; i += kThreads) {  // now dx_pad offsets
    const int r = i / g.band_w, q = i - r * g.band_w;
    pos_at[i] = (r * g.wp + q) * g.c;
  }
  float* dx_tile = dx_pad + (((size_t)n * g.hp + row0) * g.wp + col0) * g.c;

  const int m_steps = (g.m + kMS - 1) / kMS;
  float acc[kMaxWarpTiles][4];

  for (int cs = cs0; cs < cs1; ++cs) {
    const T* wsrc = w_tiles + (size_t)cs * kk_n * g.m;
    auto issue = [&](int ms) {
      const int m0 = ms * kMS, b = ms % kStages;
      T* wdst = ws + b * rp * kLdS;
      for (int i = tid; i < rp * (kMS / 4); i += kThreads) {
        const int kk = i / (kMS / 4), q = i % (kMS / 4);
        const int m = m0 + 4 * q;
        const int cnt = kk < kk_n ? g.m - m : 0;
        copy4t(wdst + kk * kLdS + 4 * q,
               cnt > 0 ? wsrc + (size_t)kk * g.m + m : w_tiles, cnt, vwg);
      }
      T* gdst = gs + b * PIX * kLdS;
      for (int i = tid; i < PIX * (kMS / 4); i += kThreads) {
        const int p = i / (kMS / 4), q = i % (kMS / 4);
        const int m = m0 + 4 * q;
        int oy = 0, ox = 0;
        const int cnt = pixel_in(g, jt, wt, p, &oy, &ox) ? g.m - m : 0;
        copy4t(gdst + p * kLdS + 4 * q,
               cnt > 0 ? gy + (((size_t)n * g.ho + oy) * g.wo + ox) * g.m + m
                       : gy,
               cnt, vwg);
      }
    };
#pragma unroll
    for (int j = 0; j < kMaxWarpTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // Steps 0 and 1, and the chunk's band (needed only by the d_off pass).
    issue(0);
    stage_band(x_pad, g, n, jt, wt, cs * tc, tid, band, unit);
    cp_async_commit();
    if (m_steps > 1) issue(1);
    cp_async_commit();
    for (int ms = 0; ms < m_steps; ++ms) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // step ms landed; step ms - 1's buffer is free
      if (ms + kStages - 1 < m_steps) issue(ms + kStages - 1);
      cp_async_commit();
      const T* wb = ws + (ms % kStages) * rp * kLdS;
      const T* gb = gs + (ms % kStages) * PIX * kLdS;
      if constexpr (kF32) {
        // A = g (16 pixels x 8 channels), B = W^T (8 channels x 8 rows),
        // fp32 split into tf32 hi and lo (3xTF32); with a k split each
        // group takes one half of the step.
#pragma unroll
        for (int k8 = 0; k8 < kMS / 8; ++k8) {
          if (ks == 2 && k8 != kgrp) continue;
          const T* ga = gb + (pt * 16 + gid) * kLdS + k8 * 8 + tig;
          const T* wr = wb + (j0 * 8 + gid) * kLdS + k8 * 8 + tig;
          uint32_t ah[4], al[4];
          split_tf32(ga[0], ah[0], al[0]);
          split_tf32(ga[8 * kLdS], ah[1], al[1]);
          split_tf32(ga[4], ah[2], al[2]);
          split_tf32(ga[8 * kLdS + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < kMaxWarpTiles; ++j) {
            if (j >= tpw) break;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(wr[j * 8 * kLdS], bh0, bl0);
            split_tf32(wr[j * 8 * kLdS + 4], bh1, bl1);
            mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      } else if (ks == 1 || (ms & 1) == kgrp) {
        // A = g (16 pixels x 16 channels), B = W^T (16 channels x 8
        // rows): the whole step is one bf16 m16n8k16 mma, whose products
        // of bf16 values are exact; with a k split each group takes
        // alternate steps.  Each register holds two channels (m
        // innermost in both staged tiles).
        const T* ga = gb + (pt * 16 + gid) * kLdS + 2 * tig;
        const T* wr = wb + (j0 * 8 + gid) * kLdS + 2 * tig;
        const uint32_t a[4] = {ld_pair(ga), ld_pair(ga + 8 * kLdS),
                               ld_pair(ga + 8), ld_pair(ga + 8 * kLdS + 8)};
#pragma unroll
        for (int j = 0; j < kMaxWarpTiles; ++j) {
          if (j >= tpw) break;
          mma_bf16(acc[j], a, ld_pair(wr + j * 8 * kLdS),
                   ld_pair(wr + j * 8 * kLdS + 8));
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the steps: dP reuses them
    // dP[pixel][row] from the dP^T fragments; the second k-split group
    // adds its sums after the first has stored (fixed order).
    for (int pass = 0; pass < ks; ++pass) {
      if (kgrp == pass) {
#pragma unroll
        for (int j = 0; j < kMaxWarpTiles; ++j) {
          if (j >= tpw) break;
          float2* d0 = reinterpret_cast<float2*>(
              dP + (pt * 16 + gid) * ldr + (j0 + j) * 8 + 2 * tig);
          float2* d1 = reinterpret_cast<float2*>(
              reinterpret_cast<float*>(d0) + 8 * ldr);
          float2 v0 = make_float2(acc[j][0], acc[j][1]);
          float2 v1 = make_float2(acc[j][2], acc[j][3]);
          if (pass == 1) {
            const float2 a0 = *d0, a1 = *d1;
            v0 = make_float2(a0.x + acc[j][0], a0.y + acc[j][1]);
            v1 = make_float2(a1.x + acc[j][2], a1.y + acc[j][3]);
          }
          *d0 = v0;
          *d1 = v1;
        }
      }
      __syncthreads();
    }
    // d_off: each lane takes its channels' share of a pair's two sums;
    // the pair's lanes then add them in a fixed order into its first lane.
    for (int j = warp; j < per_slot; j += 8) {
      const int i = sub * per_slot + j;
      float sy = 0.f, sx = 0.f;
      const int idx = sub < spw && i < pairs ? gidx[i] : -1;
      if (idx >= 0) {
        const int kt = i / PIX, p = i % PIX;
        const float ty = gty[i], tx = gtx[i];
        const float* drow = dP + p * ldr + kt * tc;
        const T* b0 = band + idx * tc;
        auto add = [&](float dp, float v00, float v01, float v10,
                       float v11) {
          sy += dp * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
          sx += dp * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
        };
        if (vw == 4) {
          for (int ch = 4 * li; ch < tc; ch += 128) {
            const float4 d = *reinterpret_cast<const float4*>(drow + ch);
            const float4 a = load4(b0 + ch);
            const float4 c = load4(b0 + tc + ch);
            const float4 e = load4(b0 + bw + ch);
            const float4 f = load4(b0 + bw + tc + ch);
            add(d.x, a.x, c.x, e.x, f.x);
            add(d.y, a.y, c.y, e.y, f.y);
            add(d.z, a.z, c.z, e.z, f.z);
            add(d.w, a.w, c.w, e.w, f.w);
          }
        } else {
          for (int ch = li; ch < tc; ch += 32)
            add(drow[ch], to_f(b0[ch]), to_f(b0[tc + ch]), to_f(b0[bw + ch]),
                to_f(b0[bw + tc + ch]));
        }
      }
      for (int o = o_top; o > 0; o >>= 1) {
        const float ay = __shfl_down_sync(0xffffffffu, sy, o);
        const float ax = __shfl_down_sync(0xffffffffu, sx, o);
        if (li + o < seg) {
          sy += ay;
          sx += ax;
        }
      }
      if (idx >= 0 && li == 0) {
        doff[2 * i] += sy;
        doff[2 * i + 1] += sx;
      }
    }
    // d_input: each (band position, channel) gathers the weighted dP of
    // the corners that land on it and adds the sum to dx_pad (global
    // atomics: neighbouring tiles' bands overlap).
    auto gather = [&](int pos, int ch) {
      const int e1 = estart[pos + 1];
      int e = estart[pos];
      if (e == e1) return;
      float v = 0.f;
      for (; e < e1; ++e) v += ew[e] * dP[eoff[e] + ch];
      atomicAdd(dx_tile + pos_at[pos] + cs * tc + ch, v);
    };
    if (kThreads % tc == 0) {
      const int ch = tid % tc;
      for (int pos = tid / tc; pos < npos; pos += kThreads / tc)
        gather(pos, ch);
    } else {
      for (int i = tid; i < npos * tc; i += kThreads) {
        const int pos = i / tc;
        gather(pos, i - pos * tc);
      }
    }
    __syncthreads();  // the passes are done with band and dP
  }
  // d_off, summed over this group's chunks in order.  One C group: masked
  // by the clamp (gradient only where |raw offset| <= B); else this
  // group's partial.
  for (int i = tid; i < pairs; i += kThreads) {
    const int kt = i / PIX, p = i % PIX;
    int oy, ox;
    if (!pixel_in(g, jt, wt, p, &oy, &ox)) continue;
    const size_t at =
        (((size_t)n * g.ho + oy) * g.wo + ox) * (2 * k2) + 2 * kt;
    if (groups == 1) {
      const float ry = load_off(off, at, g.off_bf16);
      const float rx = load_off(off, at + 1, g.off_bf16);
      store_off(d_off, at,
                (ry >= -g.bound && ry <= g.bound) ? doff[2 * i] : 0.f,
                g.off_bf16);
      store_off(d_off, at + 1,
                (rx >= -g.bound && rx <= g.bound) ? doff[2 * i + 1] : 0.f,
                g.off_bf16);
    } else {
      float* dst = static_cast<float*>(d_off) +
                   (size_t)grp * g.n * g.ho * g.wo * (2 * k2);
      dst[at] = doff[2 * i];
      dst[at + 1] = doff[2 * i + 1];
    }
  }
}

// d_off[i] = the C groups' partials summed in group order, masked by the
// clamp, in the offsets' dtype.
__global__ void dcb_doff_reduce_kernel(const float* __restrict__ partial,
                                       const void* __restrict__ off,
                                       void* __restrict__ d_off,
                                       long long count, int groups,
                                       float bound, int off_bf16) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < groups; ++s) v += partial[s * count + i];
    const float r = load_off(off, i, off_bf16);
    store_off(d_off, i, (r >= -bound && r <= bound) ? v : 0.f, off_bf16);
  }
}

// dx[i] = the fp32 d_input workspace rounded once to bf16.
__global__ void dcb_round_kernel(const float* __restrict__ ws,
                                 bf16* __restrict__ dx, long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    dx[i] = __float2bfloat16_rn(ws[i]);
}

template <typename T, int PIX>
__global__ void __launch_bounds__(kThreads, 2)
dcb_weight_kernel(const T* __restrict__ x_pad, const T* __restrict__ gy,
                  const float* __restrict__ geom, float* __restrict__ dw_out,
                  Geometry g, int splits, int vec) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k2 = g.k * g.k;
  const int tc = g.tc;
  const int kk_n = kk_rows(g);
  const int be = band_bytes<T>(g) / (int)sizeof(T);
  const int pairs = k2 * PIX;
  const int bw = g.band_w * tc;
  T* bands = reinterpret_cast<T*>(smem);              // [2][be]
  int* rtap = reinterpret_cast<int*>(bands + 2 * be); // [kRB]
  int* rch = rtap + kRB;                              // [kRB]
  T* Gs = reinterpret_cast<T*>(rch + kRB);            // [gbuf][PIX][kLdG]
  float* P = reinterpret_cast<float*>(Gs + g_buffers(PIX) * PIX * kLdG);
                                                      // [PIX][kLdP]

  const int cs = blockIdx.x;
  const int m_blocks = (g.m + kMB - 1) / kMB;
  const int r0 = (blockIdx.y / m_blocks) * kRB;
  const int m0 = (blockIdx.y % m_blocks) * kMB;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;   // 32 channels x 72 rows a warp
  const int per_image = g.h_tiles * g.w_tiles;
  const int tiles = g.n * per_image;
  const bool vwg = vec & kVecWG;
  const int unit = band_unit(vec);

  // The tap and channel of each of the block's rows (tap -1: past K*K*tc).
  for (int r = tid; r < kRB; r += kThreads) {
    const int kk = r0 + r;
    rtap[r] = kk < kk_n ? kk / tc : -1;
    rch[r] = kk < kk_n ? kk % tc : 0;
  }

  // dw^T[m][row]: two 16-channel by nine 8-row mma tiles a warp.
  float acc[2][9][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  bool m_live[2], r_live[9];
#pragma unroll
  for (int i = 0; i < 2; ++i) m_live[i] = m0 + wm * 32 + i * 16 < g.m;
#pragma unroll
  for (int j = 0; j < 9; ++j) r_live[j] = r0 + wn * 72 + j * 8 < kk_n;

  // The band of tile t into band buffer b; its g (channels m0 ..
  // m0 + 127) into g buffer gb.
  auto stage_tile = [&](int t, int b) {
    const int n = t / per_image;
    const int jt = (t % per_image) / g.w_tiles;
    const int wt = t % g.w_tiles;
    stage_band(x_pad, g, n, jt, wt, cs * tc, tid, bands + b * be, unit);
  };
  auto stage_g = [&](int t, int gb) {
    const int n = t / per_image;
    const int jt = (t % per_image) / g.w_tiles;
    const int wt = t % g.w_tiles;
    T* G = Gs + gb * PIX * kLdG;
    for (int i = tid; i < PIX * (kMB / 4); i += kThreads) {
      const int p = i / (kMB / 4), q = i % (kMB / 4);
      const int m = m0 + 4 * q;
      int oy = 0, ox = 0;
      const int cnt = pixel_in(g, jt, wt, p, &oy, &ox) ? g.m - m : 0;
      copy4t(G + p * kLdG + 4 * q,
             cnt > 0 ? gy + (((size_t)n * g.ho + oy) * g.wo + ox) * g.m + m
                     : gy,
             cnt, vwg);
    }
  };
  constexpr bool g2 = g_buffers(PIX) == 2;
  if (split < tiles) {
    stage_tile(split, 0);
    if (g2) stage_g(split, 0);
  }
  cp_async_commit();
  int it = 0;
  for (int t = split; t < tiles; t += splits, ++it) {
    const int b = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t's band landed; the last tile's products ran
    // With one g buffer, this tile's g now; then the next tile's band
    // (and g), in flight while this one's patches are rebuilt and its
    // products run.
    if (!g2) stage_g(t, 0);
    cp_async_commit();
    if (t + splits < tiles) {
      stage_tile(t + splits, b ^ 1);
      if (g2) stage_g(t + splits, b ^ 1);
    }
    cp_async_commit();
    const T* G = Gs + (g2 ? b : 0) * PIX * kLdG;
    // Rows r0 .. r0 + 143 of this tile's patches, P[pixel][row], from the
    // band and the geometry the d_input kernel wrote; four rows (one tap,
    // four channels) a thread where tile_c is a multiple of 4.
    const T* band = bands + b * be;
    const float* gm = geom + (size_t)t * 3 * pairs;
    const int rstep = tc % 4 == 0 ? 4 : 1;
    for (int i = tid; i < PIX * (kRB / rstep); i += kThreads) {
      const int p = i / (kRB / rstep), r = (i - p * (kRB / rstep)) * rstep;
      const int kt = rtap[r];
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      const int gi = kt * PIX + p;
      const int idx = kt >= 0 ? __float_as_int(__ldg(gm + gi)) : -1;
      if (idx >= 0) {
        const float ty = __ldg(gm + pairs + gi);
        const float tx = __ldg(gm + 2 * pairs + gi);
        const float w00 = (1.f - ty) * (1.f - tx), w01 = (1.f - ty) * tx;
        const float w10 = ty * (1.f - tx), w11 = ty * tx;
        const T* bp = band + idx * tc + rch[r];
        if (rstep == 4) {
          const float4 a = load4(bp);
          const float4 c = load4(bp + tc);
          const float4 e = load4(bp + bw);
          const float4 f = load4(bp + bw + tc);
          val.x = a.x * w00 + c.x * w01 + e.x * w10 + f.x * w11;
          val.y = a.y * w00 + c.y * w01 + e.y * w10 + f.y * w11;
          val.z = a.z * w00 + c.z * w01 + e.z * w10 + f.z * w11;
          val.w = a.w * w00 + c.w * w01 + e.w * w10 + f.w * w11;
        } else {
          val.x = to_f(bp[0]) * w00 + to_f(bp[tc]) * w01 +
                  to_f(bp[bw]) * w10 + to_f(bp[bw + tc]) * w11;
        }
      }
      if (rstep == 4)
        *reinterpret_cast<float4*>(P + p * kLdP + r) = val;
      else
        P[p * kLdP + r] = val.x;
    }
    cp_async_wait<1>();  // g landed (the next tile's band may still fly)
    __syncthreads();
    // dw^T += g^T P: A = g^T (16 channels x 8 pixels), B = P (8 pixels x
    // 8 rows), P split into tf32 hi and lo; g too in fp32 (3xTF32), while
    // a bf16 g is exact in tf32 (two passes: g P_lo, g P_hi).
#pragma unroll
    for (int k8 = 0; k8 < PIX / 8; ++k8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* ga = G + (k8 * 8 + tig) * kLdG + wm * 32 + i * 16 + gid;
        if constexpr (kF32) {
          split_tf32(ga[0], ah[i][0], al[i][0]);
          split_tf32(ga[8], ah[i][1], al[i][1]);
          split_tf32(ga[4 * kLdG], ah[i][2], al[i][2]);
          split_tf32(ga[4 * kLdG + 8], ah[i][3], al[i][3]);
        } else {
          ah[i][0] = __float_as_uint(to_f(ga[0]));
          ah[i][1] = __float_as_uint(to_f(ga[8]));
          ah[i][2] = __float_as_uint(to_f(ga[4 * kLdG]));
          ah[i][3] = __float_as_uint(to_f(ga[4 * kLdG + 8]));
        }
      }
      const float* pb = P + (k8 * 8 + tig) * kLdP + wn * 72 + gid;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        if (!r_live[j]) continue;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(pb[j * 8], bh0, bl0);
        split_tf32(pb[j * 8 + 4 * kLdP], bh1, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!m_live[i]) continue;
          if constexpr (kF32) {
            mma_3xtf32(acc[i][j], ah[i], al[i], bh0, bh1, bl0, bl1);
          } else {
            mma_tf32(acc[i][j], ah[i], bl0, bl1);
            mma_tf32(acc[i][j], ah[i], bh0, bh1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int c_steps = g.c / tc;
  float* dst = dw_out + ((size_t)split * c_steps + cs) * kk_n * g.m;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int mm = m0 + wm * 32 + i * 16 + gid;
      const int kk = r0 + wn * 72 + j * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int me = mm + (e >> 1) * 8, ke = kk + (e & 1);
        if (me < g.m && ke < kk_n) dst[(size_t)ke * g.m + me] = acc[i][j][e];
      }
    }
}

// dw[i] = sum over the splits of partial[split][i], in split order.
__global__ void dcb_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ dw, long long count,
                                  int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * count + i];
    dw[i] = v;
  }
}

inline int grid_1d(long long count) {
  const long long blocks = (count + 255) / 256;
  return (int)(blocks < 1024 ? (blocks < 1 ? 1 : blocks) : 1024);
}

template <typename T, int PIX>
cudaError_t launch(const T* x_pad, const void* off, const T* gy,
                   const T* w_tiles, T* dx_pad, float* dx_ws, void* d_off,
                   float* dw_tiles, float* dw_partial, float* doff_partial,
                   float* geom, int groups, int splits, int vec,
                   const Geometry& g, cudaStream_t stream) {
  static unsigned long long in_done = 0, w_done = 0;
  int e = wmma_sm90::allow_smem(dcb_input_kernel<T, PIX>, kMaxSmem, &in_done);
  if (e) return (cudaError_t)e;
  e = wmma_sm90::allow_smem(dcb_weight_kernel<T, PIX>, kMaxSmem, &w_done);
  if (e) return (cudaError_t)e;
  // d_input adds into fp32: dx_pad itself (fp32) or the workspace (bf16).
  float* dx_acc = sizeof(T) == 4 ? reinterpret_cast<float*>(dx_pad) : dx_ws;
  const long long dx_count = (long long)g.n * g.hp * g.wp * g.c;
  cudaError_t err =
      cudaMemsetAsync(dx_acc, 0, sizeof(float) * (size_t)dx_count, stream);
  if (err != cudaSuccess) return err;
  const int tiles = g.n * g.h_tiles * g.w_tiles;
  dcb_input_kernel<T, PIX><<<dim3(tiles, groups), kThreads,
                             input_smem_bytes<T>(g, PIX), stream>>>(
      x_pad, off, gy, w_tiles, dx_acc,
      groups > 1 ? static_cast<void*>(doff_partial) : d_off, geom, g, groups,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (groups > 1) {
    const long long count = (long long)g.n * g.ho * g.wo * 2 * g.k * g.k;
    dcb_doff_reduce_kernel<<<grid_1d(count), 256, 0, stream>>>(
        doff_partial, off, d_off, count, groups, g.bound, g.off_bf16);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int row_blocks = (kk_rows(g) + kRB - 1) / kRB;
  const int m_blocks = (g.m + kMB - 1) / kMB;
  dcb_weight_kernel<T, PIX><<<dim3(g.c / g.tc, row_blocks * m_blocks, splits),
                              kThreads, weight_smem_bytes<T>(g, PIX),
                              stream>>>(
      x_pad, gy, geom, splits > 1 ? dw_partial : dw_tiles, g, splits, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long count = (long long)kk_rows(g) * g.m * (g.c / g.tc);
    dcb_reduce_kernel<<<grid_1d(count), 256, 0, stream>>>(
        dw_partial, dw_tiles, count, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (sizeof(T) == 2) {
    dcb_round_kernel<<<grid_1d(dx_count), 256, 0, stream>>>(dx_ws, dx_pad,
                                                            dx_count);
    err = cudaGetLastError();
  }
  return err;
}

int pix_lanes(int th, int tw) {
  const int npix = th * tw;
  return npix <= 16 ? 16 : npix <= 32 ? 32 : npix <= 64 ? 64 : 0;
}

Geometry make_geometry(int n, int hp, int wp, int c, int ho, int wo, int m,
                       int k, int s, int d, float bound, int hb, int th,
                       int tw, int tc) {
  Geometry g;
  g.n = n; g.hp = hp; g.wp = wp; g.c = c; g.ho = ho; g.wo = wo; g.m = m;
  g.k = k; g.s = s; g.d = d; g.hb = hb; g.bound = bound;
  g.th = th; g.tw = tw; g.tc = tc;
  g.band_h = (th - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.band_w = (tw - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.h_tiles = th > 0 ? (ho + th - 1) / th : 0;
  g.w_tiles = tw > 0 ? (wo + tw - 1) / tw : 0;
  g.off_bf16 = 0;
  return g;
}

// The `vec` bits the instance of T takes at these arguments: W and g in
// copies of 4 channels need M % 4 == 0 and both pointers aligned to the
// copy; the band copy's channels must divide tile_c and C, its bytes the
// address of x_pad; fp32 takes 4-channel band copies only.
template <typename T>
bool vec_ok(int vec, const Geometry& g, const void* x_pad, const void* gy,
            const void* w_tiles) {
  const uintptr_t wg = 4 * sizeof(T);
  if ((vec & kVecWG) &&
      (g.m % 4 != 0 || reinterpret_cast<uintptr_t>(gy) % wg != 0 ||
       reinterpret_cast<uintptr_t>(w_tiles) % wg != 0))
    return false;
  const int band_bits = vec & (kVecBand | kVecBand8 | kVecBand2);
  if (band_bits == 0) return true;
  if (band_bits != kVecBand && band_bits != kVecBand8 &&
      band_bits != kVecBand2)
    return false;
  if (sizeof(T) == 4 && band_bits != kVecBand) return false;
  const int unit = band_unit(vec);
  return g.tc % unit == 0 && g.c % unit == 0 &&
         reinterpret_cast<uintptr_t>(x_pad) % (unit * sizeof(T)) == 0;
}

template <typename T>
int backward(const void* x_v, const void* off, const void* gy_v,
             const void* w_v, void* dx_v, float* dx_ws, void* d_off,
             float* dw_tiles, float* dw_partial, float* doff_partial,
             float* geom, const Geometry& g, int pix, int groups, int splits,
             int vec, void* stream) {
  const T* x_pad = static_cast<const T*>(x_v);
  const T* gy = static_cast<const T*>(gy_v);
  const T* w_tiles = static_cast<const T*>(w_v);
  T* dx_pad = static_cast<T*>(dx_v);
  if (sizeof(T) == 2 && dx_ws == nullptr) return (int)cudaErrorInvalidValue;
  if (input_smem_bytes<T>(g, pix) > kMaxSmem ||
      weight_smem_bytes<T>(g, pix) > kMaxSmem ||
      warp_tiles(g, pix) > kMaxWarpTiles ||
      !vec_ok<T>(vec, g, x_pad, gy, w_tiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (pix == 16)
    e = launch<T, 16>(x_pad, off, gy, w_tiles, dx_pad, dx_ws, d_off,
                      dw_tiles, dw_partial, doff_partial, geom, groups,
                      splits, vec, g, st);
  else if (pix == 32)
    e = launch<T, 32>(x_pad, off, gy, w_tiles, dx_pad, dx_ws, d_off,
                      dw_tiles, dw_partial, doff_partial, geom, groups,
                      splits, vec, g, st);
  else
    e = launch<T, 64>(x_pad, off, gy, w_tiles, dx_pad, dx_ws, d_off,
                      dw_tiles, dw_partial, doff_partial, geom, groups,
                      splits, vec, g, st);
  return (int)e;
}

}  // namespace

extern "C" {

// Shared memory of one block of the d_input/d_offsets kernel (bytes) for
// inputs of `elt` bytes (4: fp32, 2: bf16); 0 if the tile has more pixels
// than its 64 lanes or elt is neither.
long long dcb_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                         int tc, int elt) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 1 || (elt != 4 && elt != 2)) return 0;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw,
                             tc);
  return (long long)(elt == 4 ? input_smem_bytes<float>(g, pix)
                              : input_smem_bytes<bf16>(g, pix));
}

// Shared memory of one block of the d_weights kernel (bytes); 0 as above.
long long dcb_dw_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                            int tc, int elt) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 1 || (elt != 4 && elt != 2)) return 0;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw,
                             tc);
  return (long long)(elt == 4 ? weight_smem_bytes<float>(g, pix)
                              : weight_smem_bytes<bf16>(g, pix));
}

// Launch the fused backward on `stream`: zero d_input's fp32 sums (dx_pad
// itself in fp32, the workspace dx_ws, n*hp*wp*c floats, in bf16), then
// the d_input / d_offsets kernel over (tiles, groups) (with groups > 1,
// its partials in doff_partial: groups x N*Ho*Wo*2K^2 floats, summed by
// dcb_doff_reduce_kernel), the d_weights kernel over (C / tc, row blocks
// x channel blocks, splits), with splits > 1 the reduction of its
// partials (dw_partial: splits x C/tc x K*K*tc x M floats), and in bf16
// the rounding of dx_ws into dx_pad.  elt: bytes of an element of x_pad,
// g, w_tiles and dx_pad (4: fp32, 2: bf16); off_elt: of the offsets and
// d_off (4 or 2); dw_tiles is fp32.  geom holds tiles x 3 x K^2 x pixel
// lanes floats.  vec: bit 0, W and g are staged 4 channels a copy (M % 4
// == 0, pointers aligned to 4 elements); bit 1, the band 4 channels a
// copy; bf16 only: bit 2, 8 channels, bit 3, 2 channels (tile_c and C
// multiples of them, x_pad aligned to the copy); no band bit: element by
// element.  Returns a cudaError_t (0 on success); invalid arguments
// return cudaErrorInvalidValue before anything is launched.
int dcb_backward(const void* x_pad, const void* off, const void* gy,
                 const void* w_tiles, void* dx_pad, void* d_off,
                 float* dw_tiles, float* dw_partial, float* doff_partial,
                 float* geom, float* dx_ws, int n, int hp, int wp, int c,
                 int ho, int wo, int m, int k, int s, int d, float bound,
                 int hb, int th, int tw, int tc, int groups, int splits,
                 int vec, int elt, int off_elt, void* stream) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 1 || c % tc != 0 || splits < 1 || n < 1 ||
      groups < 1 || groups > c / tc || geom == nullptr ||
      (splits > 1 && dw_partial == nullptr) ||
      (groups > 1 && doff_partial == nullptr) ||
      (off_elt != 4 && off_elt != 2))
    return (int)cudaErrorInvalidValue;
  Geometry g = make_geometry(n, hp, wp, c, ho, wo, m, k, s, d, bound, hb, th,
                             tw, tc);
  g.off_bf16 = off_elt == 2;
  if (elt == 4)
    return backward<float>(x_pad, off, gy, w_tiles, dx_pad, dx_ws, d_off,
                           dw_tiles, dw_partial, doff_partial, geom, g, pix,
                           groups, splits, vec, stream);
  if (elt == 2)
    return backward<bf16>(x_pad, off, gy, w_tiles, dx_pad, dx_ws, d_off,
                          dw_tiles, dw_partial, doff_partial, geom, g, pix,
                          groups, splits, vec, stream);
  return (int)cudaErrorInvalidValue;
}

const char* dcb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
