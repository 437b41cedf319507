// Fused bounded deformable convolution, fp32 and bf16, for sm_90a (H100).
//
// Replaces two TPU kernels, one entry point each:
//  * dcf_forward: the kernel emitted by repro/kernels/band_pipeline.py
//    forward_call (pallas_call at band_pipeline.py:644, body
//    _forward_kernel at :434) for the fp32 and bf16 "cast" plans of
//    repro/kernels/deform_conv_fused.py deform_conv_fused_zerocopy
//    (kernel 1a), which stages its bands from the zero-padded input;
//  * dcf_forward_banded: repro/kernels/deform_conv_fused.py
//    deform_conv_fused_banded (kernel 4, pallas_call at
//    deform_conv_fused.py:130, body _fused_kernel at :75), which reads the
//    HBM-materialised bands of plan.pad_and_band.
//
// What it computes, per output pixel (oy, ox) and output channel m:
//   y[n, oy, ox, m] = sum_{tap, c} bilinear(x_pad[n, :, :, c], pos(tap))
//                                 * w_tiles[c / tc, tap * tc + c % tc, m]
// where pos(tap) is the band-local Eq. 6 position of the tap plus its
// offset clamped to +-B (fminf(fmaxf(o, -B), B), which also sends a NaN to
// -B), and bilinear takes the corners in the order 00, 01, 10, 11.  x_pad
// is zero padded by pad + ceil(B) on the top/left, so every corner of
// every clamped tap lies inside its band and no mask is needed (the zero
// padding stands in for the reference's validity mask).  The banded kernel
// computes the same over bands[n, j], the rows of row tile j; see
// "Banded" below.
//
// What bounds it on this card (fp32 instance; the bf16 one is described
// at the end): operations.  Each output needs K*K*C
// multiply-adds; at the ResNet-50-DCN shapes that work is 10-50x the time
// of moving x, the offsets, the weights and y once through device memory.
// The products run on the tensor cores as split-fp32 products ("3xTF32",
// warp_mma.cuh: a = hi + lo with hi, lo tf32, and a.b ~ a_lo b_hi +
// a_hi b_lo + a_hi b_hi in fp32), which keeps fp32 accuracy (~2^-22
// relative a product) at three tf32 mma.sync each, so the bound is the
// lower of 2*P*K*K*C*M flops on the fp32 CUDA cores and three times that
// at the dense TF32 rate.  A single TF32 pass (~2^-11) would not meet the
// fp32 contract.
//
// Design.
//   * One block of 8 warps per (image, output tile of up to 64 pixels,
//     up to 128 output channels, group of C chunks): the band is gathered
//     once for 128 channels.  A warp takes 32 (16) pixels by 32 channels
//     at 64 (32) pixel lanes, 16 by 16 at 16 lanes: two or one 16-row mma
//     tiles by four or two 8-column ones.  Two blocks fit an SM (128
//     registers a thread, <= 113 KB of shared memory a block): one block's
//     gather runs beside the other's products (a trial build whose block
//     fitted only once an SM was far slower).
//   * The grid counts pixel tiles x M tiles x C groups.  Where the first
//     two leave the card short of two blocks an SM, C is split into
//     groups as the backward's d_input grid splits it
//     (tiling.fwd_c_groups): each group writes an fp32 partial into a
//     workspace and dcf_reduce_kernel adds the partials in group order.
//     With one group the block writes y itself.  Either way every output
//     is summed in a fixed order, so y is the same bit for bit from call
//     to call.
//   * Per block, once: the corner geometry (band index, ty, tx) of every
//     (tap, pixel) in shared memory, as band_pipeline.corner_geometry
//     computes it.
//   * Per chunk of tile_c channels (two chunks in flight): the band chunk
//     and the weight chunk are copied with cp.async into double buffers,
//     16-byte copies where the channels (the band) or the output channels
//     (W) are contiguous and 16-byte aligned (the wrapper's `vec` bits),
//     element by element otherwise.  Chunk c+1 lands while chunk c is
//     gathered and multiplied: wait, barrier, issue c+1, gather c into the
//     patch tile P, barrier, products of c.
//   * Layouts.  The band chunk is position-major with the channels
//     innermost (band[pos * tc + ch], as the backward reads it): a thread
//     builds four channels of one (tap, pixel) from four float4 corner
//     reads, and neighbouring lanes take neighbouring pixels' channels,
//     so taps that land on neighbouring positions read neighbouring words
//     (no bank conflicts; offsets that scatter the taps cost some).  P is
//     [pixel][K*K*tc padded to 8, + 4]: the +4 puts the eight rows of an
//     A fragment on distinct banks.  W is [row][128] with its 16-byte
//     groups XOR-swizzled by 2 * (row % 4), so the 32 lanes of a B
//     fragment read 32 distinct banks with no padding.  Rows of K*K*tc past
//     a multiple of 8 are zero in both P and W.
//   * Products: A = P (pixels x rows), B = W (rows x channels), split
//     into hi and lo as each fragment is loaded (integer rounding), three
//     mma.sync m16n8k8 a product into a zeroed fragment, which is added to
//     the fp32 accumulators in registers (round to nearest).  The tensor
//     cores' own accumulation truncates: chained over a whole C loop (one
//     C group, hundreds of mma steps) it drifted past the 1e-5 contract
//     at the training shapes; summed a step at a time it stays near the
//     plain version's own fp32 error.  Every warp runs all its 8-column
//     tiles, the zero columns past M included: a branch per tile cut the
//     k-step into blocks the scheduler could not overlap.  P is not split
//     once as it is built: a split tile takes twice P's shared memory
//     (39 KB at 64 pixels, tile_c 8), two blocks then no longer fit an SM
//     beside the double-buffered W, and at tile_c 4, where they do, a
//     trial build saved nothing: the loads of the split tile cost what
//     the splits did.
//   * Flush, masking the ragged edge of the image and of M.
//
// Banded (kernel 4).  The TPU block holds a whole band tile (tile_h rows
// by the full output width) and a tile_h*Wo x M fp32 accumulator: 256 KB
// at every DCL of the 512 bucket, more than a Hopper block has.  Here a
// block takes the band tile's tile_h rows, tile_w of its output columns
// and up to 128 output channels, and stages only the band columns those
// outputs reach (u0*S .. u0*S + band_w(tile_w)), in tile_c chunks, with the
// same body as kernel 1a.  Column positions are those of the whole band,
// (u0 + u)*S + hb + kx*d plus the offset, as the TPU kernel computes them
// over the full width, shifted by u0*S after the floor (an exact integer
// step), so the corners and coefficients are JAX's.  Staged columns past
// the band's w_pad read 0: only masked pixels of the ragged last column
// tile reach them.
//
// The bf16 instance (T = __nv_bfloat16; x_pad or the bands and w_tiles in
// bf16, the offsets in fp32 or bf16) computes the TPU kernels' bf16
// function: each bilinear sample in fp32 from the bf16 corners, with the
// plain version's four products and three sums in the order 00, 01, 10,
// 11, each rounded on its own (__fmul_rn / __fadd_rn, as
// deform_sample.cu), then rounded once to bf16 into the patch tile (as
// band_pipeline.py:170 rounds the patches to the band's dtype); the bf16
// patches times the bf16 W chunk on the bf16 tensor cores (mma.sync
// m16n8k16, fragments from ldmatrix, W's transposed), one pass: a bf16
// product is exact in fp32, so no split is needed.  Sums are fp32, the C
// groups' partials fp32 and added in the same fixed order, and y is rounded
// once to bf16.  Its bound is the bf16 products at the dense bf16 rate or
// the bytes at 2 an element, whichever is larger.  Layouts: the band chunk
// is bf16, position-major with the channels innermost; a thread builds
// four channels of one (tap, pixel) from four 8-byte corner reads; P is
// [pixel][K*K*tc padded to 16, + 8] bf16 (rows 16 mod 32 bytes, so the
// eight rows of an ldmatrix read distinct banks) and W [row][128 + 8]
// bf16 (272-byte rows, likewise).  Copies: the band in 16-, 8- or 4-byte
// cp.async (8, 4 or 2 channels, where tile_c, C and the source's alignment
// allow; the wrapper's `vec` bits) or element by element with plain loads
// (cp.async has no 2-byte form); W in 16-byte copies (8 channels) where M
// and tile_m are multiples of 8, else element by element.

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
using wmma_sm90::cp_async16;
using wmma_sm90::cp_async_commit;
using wmma_sm90::cp_async_wait;
using wmma_sm90::from_f;
using wmma_sm90::ldmatrix_x4;
using wmma_sm90::ldmatrix_x4_trans;
using wmma_sm90::mma_3xtf32;
using wmma_sm90::mma_bf16;
using wmma_sm90::pack_bf16;
using wmma_sm90::split_tf32;

constexpr int kThreads = 256;     // threads of every block (8 warps)
constexpr int kTileM = 128;       // output channels a block, at most
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in ceiling
constexpr int kVecW = 1;          // vec bit: W in 16-byte copies

struct Geometry {
  int n, hp, wp, c, ho, wo, m;  // hp x wp: one source plane (x_pad or a band)
  int nt;                       // banded: band tiles per image; 0: x_pad
  int k, s, d, hb;
  float bound;
  int th, tw, tc, tm;
  int band_h, band_w, h_tiles, w_tiles;
  int off_bf16;                 // the offsets in bf16 (else fp32)
};

// What differs between the instances: the rows of one mma step, the
// elements a patch row takes past its rows, and a W row's length.
template <typename T>
struct Inst;
template <>
struct Inst<float> {
  static constexpr int kDepth = 8;       // tf32 m16n8k8
  static constexpr int kPPad = 4;        // patch rows 4 mod 8 floats
  static constexpr int kLdW = kTileM;    // W rows XOR-swizzled, no pad
};
template <>
struct Inst<bf16> {
  static constexpr int kDepth = 16;      // bf16 m16n8k16
  static constexpr int kPPad = 8;        // patch rows 16 mod 32 bytes
  static constexpr int kLdW = kTileM + 8;  // W rows 272 bytes
};

// Warps of a block: kP along the pixels, kN along the output channels;
// each takes kMT 16-row mma tiles by kNT 8-column ones.
template <int PIX>
struct Warps {
  static constexpr int kP = PIX >= 32 ? 2 : 1;
  static constexpr int kN = 8 / kP;
  static constexpr int kMT = PIX / 16 / kP;
  static constexpr int kNT = kTileM / kN / 8;
};

__host__ __device__ inline int round_up(int v, int u) {
  return (v + u - 1) / u * u;
}
__host__ __device__ inline int kk_rows(const Geometry& g) {
  return g.k * g.k * g.tc;
}
// Rows of K*K*tc padded to whole mma steps.
template <typename T>
__host__ __device__ inline int kk_pad(const Geometry& g) {
  return round_up(kk_rows(g), Inst<T>::kDepth);
}
// Row stride of the patch tile (elements).
template <typename T>
__host__ __device__ inline int p_ld(const Geometry& g) {
  return kk_pad<T>(g) + Inst<T>::kPPad;
}
// The band chunk: positions of the Eq. 6 band, tile_c channels innermost,
// rounded to 16 bytes.
template <typename T>
__host__ __device__ inline int band_bytes(const Geometry& g) {
  return round_up((int)sizeof(T) * g.band_h * g.band_w * g.tc, 16);
}
template <typename T>
__host__ __device__ inline int w_bytes(const Geometry& g) {
  return (int)sizeof(T) * kk_pad<T>(g) * Inst<T>::kLdW;
}

// Two band chunks, two weight chunks, the patch tile and the corner
// geometry (ty, tx, index per tap and pixel, 4 bytes each).
template <typename T>
inline size_t smem_bytes(const Geometry& g, int pix) {
  return 2 * (size_t)band_bytes<T>(g) + 2 * (size_t)w_bytes<T>(g) +
         sizeof(T) * (size_t)pix * p_ld<T>(g) + 12 * (size_t)g.k * g.k * pix;
}

// One bilinear sample as the plain version computes it: the corner
// weights (1-ty)(1-tx), (1-ty)tx, ty(1-tx), ty tx and the four products
// summed in the order 00, 01, 10, 11, every operation rounded on its own.
struct Bilerp {
  float w00, w01, w10, w11;
  __device__ Bilerp(float ty, float tx) {
    const float uy = __fsub_rn(1.f, ty), ux = __fsub_rn(1.f, tx);
    w00 = __fmul_rn(uy, ux);
    w01 = __fmul_rn(uy, tx);
    w10 = __fmul_rn(ty, ux);
    w11 = __fmul_rn(ty, tx);
  }
  __device__ float operator()(float a, float b, float c, float d) const {
    float v = __fmul_rn(a, w00);
    v = __fadd_rn(v, __fmul_rn(b, w01));
    v = __fadd_rn(v, __fmul_rn(c, w10));
    return __fadd_rn(v, __fmul_rn(d, w11));
  }
};

template <typename T, int PIX>
__global__ void __launch_bounds__(kThreads, 2)
dcf_kernel(const T* __restrict__ src, const void* __restrict__ off,
           const T* __restrict__ w_tiles, void* __restrict__ dst,
           Geometry g, int groups, int vec) {
  using L = Warps<PIX>;
  using I = Inst<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k2 = g.k * g.k;
  const int tc = g.tc;
  const int kk_n = kk_rows(g), kkp = kk_pad<T>(g), ldp = p_ld<T>(g);
  const int be = band_bytes<T>(g) / (int)sizeof(T);  // a band chunk
  const int we = w_bytes<T>(g) / (int)sizeof(T);     // a weight chunk
  T* bands = reinterpret_cast<T*>(smem);  // [2][be]
  T* Ws = bands + 2 * be;                 // [2][kkp][kLdW]
  T* P = Ws + 2 * we;                     // [PIX][ldp]
  float* gty = reinterpret_cast<float*>(P + PIX * ldp);  // [k2][PIX]
  float* gtx = gty + k2 * PIX;
  int* gidx = reinterpret_cast<int*>(gtx + k2 * PIX);

  const int n = blockIdx.z;
  const int m_tiles = (g.m + g.tm - 1) / g.tm;
  const int grp = blockIdx.y / m_tiles;
  const int m0 = (blockIdx.y % m_tiles) * g.tm;
  const int m_live = min(g.tm, g.m - m0);  // channels of this block
  const int jt = blockIdx.x / g.w_tiles;
  const int wt = blockIdx.x % g.w_tiles;
  const int chunks = g.c / tc;
  const int cs0 = grp * chunks / groups, cs1 = (grp + 1) * chunks / groups;
  // Origin of the staged band in its source plane, and the first output
  // column whose position base the band's columns start from (banded).
  const T* plane;
  int row0, pu0;
  if (g.nt) {
    plane = src + ((size_t)n * g.nt + jt) * g.hp * g.wp * g.c;
    row0 = 0;
    pu0 = wt * g.tw;
  } else {
    plane = src + (size_t)n * g.hp * g.wp * g.c;
    row0 = jt * g.th * g.s;
    pu0 = 0;
  }
  const int col0 = wt * g.tw * g.s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int npix = g.th * g.tw;
  const bool vw = vec & kVecW;
  const int unit = band_unit(vec);

  // Corner geometry of every (tap, pixel), band-local, as
  // repro/kernels/band_pipeline.py corner_geometry computes it.
  for (int i = tid; i < k2 * PIX; i += kThreads) {
    const int kt = i / PIX, p = i % PIX;
    int idx = 0;
    float fy = 0.f, fx = 0.f;
    if (p < npix) {
      const int t = p / g.tw, u = p % g.tw;
      const int oy = jt * g.th + t, ox = wt * g.tw + u;
      float dy = 0.f, dx = 0.f;
      if (oy < g.ho && ox < g.wo) {
        const size_t o =
            (((size_t)n * g.ho + oy) * g.wo + ox) * (2 * k2) + 2 * kt;
        dy = load_off(off, o, g.off_bf16);
        dx = load_off(off, o + 1, g.off_bf16);
      }
      dy = fminf(fmaxf(dy, -g.bound), g.bound);
      dx = fminf(fmaxf(dx, -g.bound), g.bound);
      const float py = (float)(t * g.s + g.hb + (kt / g.k) * g.d) + dy;
      const float px =
          (float)((pu0 + u) * g.s + g.hb + (kt % g.k) * g.d) + dx;
      const float y0 = floorf(py), x0 = floorf(px);
      fy = py - y0;
      fx = px - x0;
      idx = (int)y0 * g.band_w + (int)x0 - pu0 * g.s;
    }
    gidx[i] = idx;
    gty[i] = fy;
    gtx[i] = fx;
  }
  // The patch tile's pad rows (K*K*tc .. kkp) stay zero.
  const int pad = kkp - kk_n;
  for (int i = tid; i < PIX * pad; i += kThreads)
    P[(i / pad) * ldp + kk_n + i % pad] = from_f<T>(0.f);

  // Chunk cs of the band and of W into buffer b.
  auto stage = [&](int cs, int b) {
    T* band = bands + b * be;
    const int c0 = cs * tc;
    const int per = tc / unit;               // copies a position
    const int total = g.band_h * g.band_w * per;
    for (int i = tid; i < total; i += kThreads) {
      const int pos = i / per, e = i - pos * per;
      const int r = pos / g.band_w, q = pos - r * g.band_w;
      const bool in = col0 + q < g.wp;
      const T* s =
          in ? plane + ((size_t)(row0 + r) * g.wp + col0 + q) * g.c + c0
             : plane;
      copy_elems(band + pos * tc + unit * e, s + unit * e, unit, in);
    }
    T* wd = Ws + b * we;
    const T* wsrc = w_tiles + (size_t)cs * kk_n * g.m + m0;
    if constexpr (kF32) {
      for (int i = tid; i < kkp * (kTileM / 4); i += kThreads) {
        const int kk = i / (kTileM / 4), q = i % (kTileM / 4);
        const int cnt = kk < kk_n ? m_live - 4 * q : 0;
        copy4(wd + kk * kTileM + ((q ^ ((kk & 3) << 1)) << 2),
              cnt > 0 ? wsrc + (size_t)kk * g.m + 4 * q : w_tiles, cnt, vw);
      }
    } else {
      for (int i = tid; i < kkp * (kTileM / 8); i += kThreads) {
        const int kk = i / (kTileM / 8), q = i % (kTileM / 8);
        const int cnt = kk < kk_n ? min(max(m_live - 8 * q, 0), 8) : 0;
        T* w8 = wd + kk * I::kLdW + 8 * q;
        const T* s8 = cnt > 0 ? wsrc + (size_t)kk * g.m + 8 * q : w_tiles;
        if (vw) {
          cp_async16(w8, s8, 2 * cnt);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            copy_elems(w8 + e, e < cnt ? s8 + e : w_tiles, 1, e < cnt);
        }
      }
    }
  };

  // This warp's share of the output tile.
  const int prow = (warp / L::kN) * (PIX / L::kP);
  const int ncol = (warp % L::kN) * (kTileM / L::kN);
  float acc[L::kMT][L::kNT][4];
#pragma unroll
  for (int i = 0; i < L::kMT; ++i)
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int bwf = g.band_w * tc;   // a band row, in elements
  stage(cs0, 0);
  cp_async_commit();
  for (int cs = cs0, it = 0; cs < cs1; ++cs, ++it) {
    const int b = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk cs landed; chunk cs - 1's products are done
    if (cs + 1 < cs1) stage(cs + 1, b ^ 1);
    cp_async_commit();
    // Patch tile P[pixel][tap * tc + ch], the corners in JAX's order.
    const T* band = bands + b * be;
    if constexpr (kF32) {
      if (tc % 4 == 0) {
        const int q4 = tc / 4;
        for (int i = tid; i < k2 * PIX * q4; i += kThreads) {
          const int pr = i / q4, q = i - pr * q4;
          const int kt = pr / PIX, p = pr - kt * PIX;
          const float ty = gty[pr], tx = gtx[pr];
          const float w00 = (1.f - ty) * (1.f - tx), w01 = (1.f - ty) * tx;
          const float w10 = ty * (1.f - tx), w11 = ty * tx;
          const float* bp = band + gidx[pr] * tc + 4 * q;
          const float4 a = *reinterpret_cast<const float4*>(bp);
          const float4 c = *reinterpret_cast<const float4*>(bp + tc);
          const float4 e = *reinterpret_cast<const float4*>(bp + bwf);
          const float4 f = *reinterpret_cast<const float4*>(bp + bwf + tc);
          float4 v;
          v.x = a.x * w00 + c.x * w01 + e.x * w10 + f.x * w11;
          v.y = a.y * w00 + c.y * w01 + e.y * w10 + f.y * w11;
          v.z = a.z * w00 + c.z * w01 + e.z * w10 + f.z * w11;
          v.w = a.w * w00 + c.w * w01 + e.w * w10 + f.w * w11;
          if (p >= npix) v = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(P + p * ldp + kt * tc + 4 * q) = v;
        }
      } else {
        for (int i = tid; i < k2 * PIX * tc; i += kThreads) {
          const int pr = i / tc, ch = i - pr * tc;
          const int kt = pr / PIX, p = pr - kt * PIX;
          const float ty = gty[pr], tx = gtx[pr];
          const float* bp = band + gidx[pr] * tc + ch;
          float v = bp[0] * ((1.f - ty) * (1.f - tx));
          v += bp[tc] * ((1.f - ty) * tx);
          v += bp[bwf] * (ty * (1.f - tx));
          v += bp[bwf + tc] * (ty * tx);
          P[p * ldp + kt * tc + ch] = p < npix ? v : 0.f;
        }
      }
    } else {
      // bf16: four channels from four 8-byte corner reads where tile_c
      // allows, each sample rounded once to bf16.
      if (tc % 4 == 0) {
        const int q4 = tc / 4;
        for (int i = tid; i < k2 * PIX * q4; i += kThreads) {
          const int pr = i / q4, q = i - pr * q4;
          const int kt = pr / PIX, p = pr - kt * PIX;
          const Bilerp bl(gty[pr], gtx[pr]);
          const T* bp = band + gidx[pr] * tc + 4 * q;
          const uint2 a = *reinterpret_cast<const uint2*>(bp);
          const uint2 c = *reinterpret_cast<const uint2*>(bp + tc);
          const uint2 e = *reinterpret_cast<const uint2*>(bp + bwf);
          const uint2 f = *reinterpret_cast<const uint2*>(bp + bwf + tc);
          uint2 v = make_uint2(0u, 0u);
          if (p < npix) {
            v.x = pack_bf16(
                bl(bf16_lo(a.x), bf16_lo(c.x), bf16_lo(e.x), bf16_lo(f.x)),
                bl(bf16_hi(a.x), bf16_hi(c.x), bf16_hi(e.x), bf16_hi(f.x)));
            v.y = pack_bf16(
                bl(bf16_lo(a.y), bf16_lo(c.y), bf16_lo(e.y), bf16_lo(f.y)),
                bl(bf16_hi(a.y), bf16_hi(c.y), bf16_hi(e.y), bf16_hi(f.y)));
          }
          *reinterpret_cast<uint2*>(P + p * ldp + kt * tc + 4 * q) = v;
        }
      } else {
        for (int i = tid; i < k2 * PIX * tc; i += kThreads) {
          const int pr = i / tc, ch = i - pr * tc;
          const int kt = pr / PIX, p = pr - kt * PIX;
          const Bilerp bl(gty[pr], gtx[pr]);
          const T* bp = band + gidx[pr] * tc + ch;
          const float v = bl(__bfloat162float(bp[0]),
                             __bfloat162float(bp[tc]),
                             __bfloat162float(bp[bwf]),
                             __bfloat162float(bp[bwf + tc]));
          P[p * ldp + kt * tc + ch] = __float2bfloat16_rn(p < npix ? v : 0.f);
        }
      }
    }
    __syncthreads();  // P is built
    const T* Wb = Ws + b * we;
    if constexpr (kF32) {
      // y += P W on the tensor cores: A = P (16 pixels x 8 rows), B = W
      // (8 rows x 8 channels), each split into tf32 hi and lo.
      const int swz = tig << 1;          // (row % 4) << 1 of rows kb + tig
      for (int kb = 0; kb < kkp; kb += 8) {
        uint32_t ah[L::kMT][4], al[L::kMT][4];
#pragma unroll
        for (int i = 0; i < L::kMT; ++i) {
          const float* pa = P + (prow + i * 16 + gid) * ldp + kb + tig;
          split_tf32(pa[0], ah[i][0], al[i][0]);
          split_tf32(pa[8 * ldp], ah[i][1], al[i][1]);
          split_tf32(pa[4], ah[i][2], al[i][2]);
          split_tf32(pa[8 * ldp + 4], ah[i][3], al[i][3]);
        }
        const float* w0 = Wb + (kb + tig) * kTileM;
#pragma unroll
        for (int j = 0; j < L::kNT; ++j) {
          const int nn = ncol + j * 8 + gid;
          const int col = (((nn >> 2) ^ swz) << 2) | (nn & 3);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(w0[col], bh0, bl0);
          split_tf32(w0[4 * kTileM + col], bh1, bl1);
#pragma unroll
          for (int i = 0; i < L::kMT; ++i) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(d, ah[i], al[i], bh0, bh1, bl0, bl1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
          }
        }
      }
    } else {
      // y += P W on the bf16 tensor cores: A = P (16 pixels x 16 rows,
      // ldmatrix), B = W (16 rows x 8 channels, ldmatrix.trans: two
      // 8-column tiles a load); the products are exact in fp32.
      const int a_row = lane & 15, a_col = 8 * (lane >> 4);
      for (int kb = 0; kb < kkp; kb += 16) {
        uint32_t a[L::kMT][4];
#pragma unroll
        for (int i = 0; i < L::kMT; ++i)
          ldmatrix_x4(a[i], P + (prow + i * 16 + a_row) * ldp + kb + a_col);
#pragma unroll
        for (int jp = 0; jp < L::kNT / 2; ++jp) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, Wb + (kb + a_row) * I::kLdW + ncol + jp * 16 + a_col);
#pragma unroll
          for (int i = 0; i < L::kMT; ++i) {
            float d0[4] = {0.f, 0.f, 0.f, 0.f};
            float d1[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(d0, a[i], r[0], r[1]);
            mma_bf16(d1, a[i], r[2], r[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][2 * jp][e] += d0[e];
              acc[i][2 * jp + 1][e] += d1[e];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Flush, masking the ragged edge of the image and of M: y itself (one
  // C group, rounded once to T) or this group's fp32 partial.
  const size_t plane_out = (size_t)g.n * g.ho * g.wo * g.m;
#pragma unroll
  for (int i = 0; i < L::kMT; ++i)
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = prow + i * 16 + gid + (e >> 1) * 8;
        const int ch = ncol + j * 8 + 2 * tig + (e & 1);
        if (p >= npix || ch >= m_live) continue;
        const int oy = jt * g.th + p / g.tw, ox = wt * g.tw + p % g.tw;
        if (oy >= g.ho || ox >= g.wo) continue;
        const size_t at =
            (((size_t)n * g.ho + oy) * g.wo + ox) * g.m + m0 + ch;
        if (groups > 1)
          static_cast<float*>(dst)[grp * plane_out + at] = acc[i][j][e];
        else
          static_cast<T*>(dst)[at] = from_f<T>(acc[i][j][e]);
      }
}

// y[i] = the C groups' partials summed in group order, rounded once to T.
template <typename T>
__global__ void dcf_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ y, long long count,
                                  int groups) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < groups; ++s) v += partial[s * count + i];
    y[i] = from_f<T>(v);
  }
}

inline int grid_1d(long long count) {
  const long long blocks = (count + 255) / 256;
  return (int)(blocks < 1024 ? (blocks < 1 ? 1 : blocks) : 1024);
}

template <typename T, int PIX>
int allow(void) {
  static unsigned long long done = 0;
  return wmma_sm90::allow_smem(dcf_kernel<T, PIX>, kMaxSmem, &done);
}

template <typename T, int PIX>
cudaError_t launch(const T* src, const void* off, const T* w_tiles, T* out,
                   float* partial, const Geometry& g, int groups, int vec,
                   cudaStream_t stream) {
  if (int e = allow<T, PIX>()) return (cudaError_t)e;
  const int m_tiles = (g.m + g.tm - 1) / g.tm;
  const dim3 grid(g.h_tiles * g.w_tiles, m_tiles * groups, g.n);
  dcf_kernel<T, PIX><<<grid, kThreads, smem_bytes<T>(g, PIX), stream>>>(
      src, off, w_tiles,
      groups > 1 ? static_cast<void*>(partial) : static_cast<void*>(out), g,
      groups, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const long long count = (long long)g.n * g.ho * g.wo * g.m;
  dcf_reduce_kernel<T><<<grid_1d(count), 256, 0, stream>>>(partial, out,
                                                           count, groups);
  return cudaGetLastError();
}

int pix_lanes(int th, int tw) {
  const int npix = th * tw;
  return npix <= 16 ? 16 : npix <= 32 ? 32 : npix <= 64 ? 64 : 0;
}

Geometry make_geometry(int n, int hp, int wp, int c, int ho, int wo, int m,
                       int k, int s, int d, float bound, int hb, int th,
                       int tw, int tc, int tm) {
  Geometry g;
  g.n = n; g.hp = hp; g.wp = wp; g.c = c; g.ho = ho; g.wo = wo; g.m = m;
  g.nt = 0;
  g.k = k; g.s = s; g.d = d; g.hb = hb; g.bound = bound;
  g.th = th; g.tw = tw; g.tc = tc; g.tm = tm;
  g.band_h = (th - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.band_w = (tw - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.h_tiles = th > 0 ? (ho + th - 1) / th : 0;
  g.w_tiles = tw > 0 ? (wo + tw - 1) / tw : 0;
  g.off_bf16 = 0;
  return g;
}

// The `vec` bits the instance of T takes at these arguments: W's 16-byte
// copies need M and tile_m multiples of 16 bytes' elements and an aligned
// w_tiles; the band copy's channels must divide tile_c and C, its bytes
// the source's address; fp32 takes 4-channel band copies only.
template <typename T>
bool vec_ok(int vec, const Geometry& g, const void* src,
            const void* w_tiles) {
  const int we = 16 / (int)sizeof(T);
  if ((vec & kVecW) && (g.m % we != 0 || g.tm % we != 0 ||
                        reinterpret_cast<uintptr_t>(w_tiles) % 16 != 0))
    return false;
  const int band_bits = vec & (kVecBand | kVecBand8 | kVecBand2);
  if (band_bits == 0) return true;
  if (band_bits != kVecBand && band_bits != kVecBand8 &&
      band_bits != kVecBand2)
    return false;
  if (sizeof(T) == 4 && band_bits != kVecBand) return false;
  const int unit = band_unit(vec);
  return g.tc % unit == 0 && g.c % unit == 0 &&
         reinterpret_cast<uintptr_t>(src) % (unit * sizeof(T)) == 0;
}

// Check the arguments and launch the instantiation for the tile's pixel
// count.
template <typename T>
int forward(const void* src_v, const void* off, const void* w_v, void* out_v,
            float* partial, const Geometry& g, int groups, int vec,
            void* stream) {
  const T* src = static_cast<const T*>(src_v);
  const T* w_tiles = static_cast<const T*>(w_v);
  T* out = static_cast<T*>(out_v);
  const int pix = pix_lanes(g.th, g.tw);
  if (pix == 0 || g.n < 1 || g.tm < 1 || g.tm > kTileM || g.tc < 1 ||
      g.c % g.tc != 0 || groups < 1 || groups > g.c / g.tc ||
      (groups > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes<T>(g, pix) > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (!vec_ok<T>(vec, g, src, w_tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (pix == 16)
    e = launch<T, 16>(src, off, w_tiles, out, partial, g, groups, vec, st);
  else if (pix == 32)
    e = launch<T, 32>(src, off, w_tiles, out, partial, g, groups, vec, st);
  else
    e = launch<T, 64>(src, off, w_tiles, out, partial, g, groups, vec, st);
  return (int)e;
}

int dispatch(const void* src, const void* off, const void* w_tiles,
             void* out, float* partial, Geometry g, int groups, int vec,
             int elt, int off_elt, void* stream) {
  if (off_elt != 4 && off_elt != 2) return (int)cudaErrorInvalidValue;
  g.off_bf16 = off_elt == 2;
  if (elt == 4)
    return forward<float>(src, off, w_tiles, out, partial, g, groups, vec,
                          stream);
  if (elt == 2)
    return forward<bf16>(src, off, w_tiles, out, partial, g, groups, vec,
                         stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int blocks_per_sm(const Geometry& g, int pix) {
  const size_t smem = smem_bytes<T>(g, pix);
  int blocks = 0, e;
  cudaError_t err;
  if (pix == 16) {
    e = allow<T, 16>();
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dcf_kernel<T, 16>, kThreads, smem);
  } else if (pix == 32) {
    e = allow<T, 32>();
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dcf_kernel<T, 32>, kThreads, smem);
  } else {
    e = allow<T, 64>();
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dcf_kernel<T, 64>, kThreads, smem);
  }
  if (e) return -e;
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

extern "C" {

// Shared memory one block of the given tiles needs (bytes) for elements
// of `elt` bytes (4: fp32, 2: bf16); 0 if the tile has more pixels than
// the kernel's 64 lanes or elt is neither.
long long dcf_smem_bytes(int k, int s, int d, int hb, int th, int tw, int tc,
                         int elt) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 1 || (elt != 4 && elt != 2)) return 0;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw,
                             tc, 0);
  return (long long)(elt == 4 ? smem_bytes<float>(g, pix)
                              : smem_bytes<bf16>(g, pix));
}

// Blocks of the given tiles that fit one SM of the current device at once
// (registers, threads and shared memory), or a negative cudaError_t.
int dcf_blocks_per_sm(int k, int s, int d, int hb, int th, int tw, int tc,
                      int elt) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 1 || (elt != 4 && elt != 2))
    return -(int)cudaErrorInvalidValue;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw,
                             tc, 0);
  return elt == 4 ? blocks_per_sm<float>(g, pix) : blocks_per_sm<bf16>(g, pix);
}

// Launch the fused forward on `stream`: x_pad (n, hp, wp, c), offsets
// (n, ho, wo, 2*k*k), w_tiles (c / tc, k*k*tc, m), out (n, ho, wo, m).
// elt: bytes of an element of x_pad, w_tiles and out (4: fp32, 2: bf16);
// off_elt: of the offsets (4 or 2).  groups: C groups of the grid (1 ..
// c / tc); with groups > 1, partial holds groups x n*ho*wo*m floats,
// summed into out by a second kernel.  vec: bit 0, W is staged with
// 16-byte copies (m and tm multiples of 4 fp32 or 8 bf16, 16-byte aligned
// w_tiles); bit 1, the band 4 channels a copy; bf16 only: bit 2, 8
// channels a copy, bit 3, 2 channels a copy (tc and c multiples of the
// channels, x_pad aligned to the copy's bytes); no band bit: element by
// element.  Returns a cudaError_t (0 on success); invalid arguments return
// cudaErrorInvalidValue before anything is launched.
int dcf_forward(const void* x_pad, const void* off, const void* w_tiles,
                void* out, float* partial, int n, int hp, int wp, int c,
                int ho, int wo, int m, int k, int s, int d, float bound,
                int hb, int th, int tw, int tc, int tm, int groups, int vec,
                int elt, int off_elt, void* stream) {
  Geometry g = make_geometry(n, hp, wp, c, ho, wo, m, k, s, d, bound, hb,
                             th, tw, tc, tm);
  return dispatch(x_pad, off, w_tiles, out, partial, g, groups, vec, elt,
                  off_elt, stream);
}

// Launch the banded forward (kernel 4) on `stream`: bands (n, nt, band_h,
// w_pad, c) from plan.pad_and_band, offsets (n, nt * th, wo, 2*k*k), out
// (n, nt * th, wo, m); partial, groups, vec, elt and off_elt as for
// dcf_forward.  band_h must be the Eq. 6 extent of th rows.
int dcf_forward_banded(const void* bands, const void* off,
                       const void* w_tiles, void* out, float* partial, int n,
                       int nt, int band_h, int w_pad, int c, int wo, int m,
                       int k, int s, int d, float bound, int hb, int th,
                       int tw, int tc, int tm, int groups, int vec, int elt,
                       int off_elt, void* stream) {
  Geometry g = make_geometry(n, band_h, w_pad, c, nt * th, wo, m, k, s, d,
                             bound, hb, th, tw, tc, tm);
  if (nt < 1 || g.band_h != band_h) return (int)cudaErrorInvalidValue;
  g.nt = nt;
  return dispatch(bands, off, w_tiles, out, partial, g, groups, vec, elt,
                  off_elt, stream);
}

const char* dcf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
