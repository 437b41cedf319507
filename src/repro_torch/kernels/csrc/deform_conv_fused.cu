// Fused bounded deformable convolution, fp32, for sm_90a (H100).
//
// Replaces two TPU kernels, one entry point each:
//  * dcf_forward: the kernel emitted by repro/kernels/band_pipeline.py
//    forward_call (pallas_call at band_pipeline.py:644, body
//    _forward_kernel at :434) for the fp32 "cast" plan of
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
// offset clamped to +-B.  x_pad is zero padded by pad + ceil(B) on the
// top/left, so every corner of every clamped tap lies inside its band and
// no mask is needed (the zero padding stands in for the reference's
// validity mask).  The banded kernel computes the same over bands[n, j],
// the rows of row tile j; see "Banded" below.
//
// What bounds it on this card: operations.  Each output needs K*K*C FMAs
// over data that is re-used M/tile_m and tile-overlap times from shared
// memory; at the ResNet-50-DCN shapes the fp32 FMA work is 10-50x the time
// of moving x, the offsets, the weights and y once through device memory.
//
// Design (simple first; tensor cores, TMA and double buffering are later
// work):
//   * one block per (image, tile_h x tile_w output pixels, tile_m <= 64
//     output channels); the TPU's sequential C-step grid axis is a loop
//     inside the block;
//   * corner geometry (flat band index, ty, tx) for every pixel and tap,
//     once per block, in shared memory;
//   * per channel chunk of tile_c: stage the band channel-major (odd
//     plane stride, so the staging writes and the corner reads spread
//     over the banks) and the weight slice, build the patch tile
//     P[K*K*tile_c][pixels] with the JAX corner order (00, 01, 10, 11),
//     then accumulate P^T W in registers, 4 pixels x 4 channels a thread;
//   * flush the accumulator, masking the ragged edge of the image and of M.
// The fp32 datapath runs on CUDA-core FMAs: no TF32.
//
// Banded (kernel 4).  The TPU block holds a whole band tile (tile_h rows
// by the full output width) and a tile_h*Wo x M fp32 accumulator: 256 KB
// at every DCL of the 512 bucket, more than a Hopper block has.  Here a
// block takes the band tile's tile_h rows, tile_w of its output columns
// and tile_m <= 64 output channels, and stages only the band columns those
// outputs reach (u0*S .. u0*S + band_w(tile_w)), in tile_c chunks; the
// accumulator stays in registers as for kernel 1a.  Column positions are
// those of the whole band, (u0 + u)*S + hb + kx*d plus the offset, as the
// TPU kernel computes them over the full width, shifted by u0*S after the
// floor (an exact integer step), so the corners and coefficients are
// JAX's.  Staged columns past the band's w_pad read 0: only masked pixels
// of the ragged last column tile reach them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTileMMax = 64;   // output channels per block (16 x 4 lanes)

struct Geometry {
  int hp, wp, c, ho, wo, m;   // hp x wp: one source plane (x_pad or a band)
  int nt;                     // banded: band tiles per image; 0: x_pad
  int k, s, d, hb;
  float bound;
  int th, tw, tc, tm;
  int band_h, band_w, w_tiles;
};

__host__ __device__ inline int band_floats(const Geometry& g) {
  int plane = (g.band_h * g.band_w) | 1;
  return ((g.tc * plane + 3) / 4) * 4;
}

inline size_t smem_bytes(const Geometry& g, int pix) {
  size_t k2 = (size_t)g.k * g.k;
  size_t kk = k2 * g.tc;
  return 4 * ((size_t)band_floats(g) + kk * pix + kk * kTileMMax +
              3 * k2 * pix);
}

template <int PIX>
__global__ void __launch_bounds__(PIX * 4)
dcf_kernel(const float* __restrict__ src, const float* __restrict__ off,
           const float* __restrict__ w_tiles, float* __restrict__ out,
           Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int k2 = g.k * g.k;
  const int kk_n = k2 * g.tc;
  const int plane_stride = (g.band_h * g.band_w) | 1;
  float* band = smem;
  float* P = band + band_floats(g);
  float* W = P + kk_n * PIX;
  float* gty = W + kk_n * kTileMMax;
  float* gtx = gty + k2 * PIX;
  int* gidx = reinterpret_cast<int*>(gtx + k2 * PIX);

  const int n = blockIdx.z;
  const int m0 = blockIdx.y * g.tm;
  const int jt = blockIdx.x / g.w_tiles;
  const int wt = blockIdx.x % g.w_tiles;
  // Origin of the staged band in its source plane, and the first output
  // column whose position base the band's columns start from (banded).
  const float* plane;
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
  const int tid = threadIdx.y * 16 + threadIdx.x;
  constexpr int kThreads = PIX * 4;
  const int npix = g.th * g.tw;

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
        const float* o =
            off + (((size_t)n * g.ho + oy) * g.wo + ox) * (2 * k2) + 2 * kt;
        dy = o[0];
        dx = o[1];
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

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int c_steps = g.c / g.tc;
  const int band_n = g.band_h * g.band_w * g.tc;
  for (int cs = 0; cs < c_steps; ++cs) {
    const int c0 = cs * g.tc;
    __syncthreads();  // the previous chunk's FMAs are done with P and W
    // Band: consecutive threads read consecutive channels (coalesced).
    for (int i = tid; i < band_n; i += kThreads) {
      const int ch = i % g.tc, pos = i / g.tc;
      const int r = pos / g.band_w, q = pos % g.band_w;
      band[ch * plane_stride + pos] =
          col0 + q < g.wp
              ? plane[((size_t)(row0 + r) * g.wp + col0 + q) * g.c + c0 + ch]
              : 0.f;
    }
    // Weight slice of this chunk: rows tap * tc + ch, tile_m columns.
    const float* wsrc = w_tiles + (size_t)cs * kk_n * g.m;
    for (int i = tid; i < kk_n * kTileMMax; i += kThreads) {
      const int kk = i / kTileMMax, j = i % kTileMMax;
      W[i] = (j < g.tm && m0 + j < g.m) ? wsrc[(size_t)kk * g.m + m0 + j]
                                        : 0.f;
    }
    __syncthreads();
    // Patch tile P[tap * tc + ch][pixel].
    for (int i = tid; i < kk_n * PIX; i += kThreads) {
      const int p = i % PIX, kk = i / PIX;
      const int kt = kk / g.tc, ch = kk % g.tc;
      const int gi = kt * PIX + p;
      const float ty = gty[gi], tx = gtx[gi];
      const float* b = band + ch * plane_stride + gidx[gi];
      float v = b[0] * ((1.f - ty) * (1.f - tx));
      v += b[1] * ((1.f - ty) * tx);
      v += b[g.band_w] * (ty * (1.f - tx));
      v += b[g.band_w + 1] * (ty * tx);
      P[i] = (p < npix) ? v : 0.f;
    }
    __syncthreads();
    const float* pa = P + threadIdx.y * 4;
    const float* wb = W + threadIdx.x * 4;
#pragma unroll 4
    for (int kk = 0; kk < kk_n; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pa + kk * PIX);
      const float4 b = *reinterpret_cast<const float4*>(wb + kk * kTileMMax);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // Flush, masking the ragged edge of the image and of M.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = threadIdx.y * 4 + i;
    if (p >= npix) continue;
    const int oy = jt * g.th + p / g.tw, ox = wt * g.tw + p % g.tw;
    if (oy >= g.ho || ox >= g.wo) continue;
    float* o = out + (((size_t)n * g.ho + oy) * g.wo + ox) * g.m + m0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mj = threadIdx.x * 4 + j;
      if (mj < g.tm && m0 + mj < g.m) o[mj] = acc[i][j];
    }
  }
}

template <int PIX>
cudaError_t launch(const float* src, const float* off, const float* w_tiles,
                   float* out, int n, const Geometry& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, PIX);
  cudaError_t e = cudaFuncSetAttribute(
      dcf_kernel<PIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int h_tiles = (g.ho + g.th - 1) / g.th;
  const dim3 grid(h_tiles * g.w_tiles, (g.m + g.tm - 1) / g.tm, n);
  const dim3 block(16, PIX / 4);
  dcf_kernel<PIX><<<grid, block, smem, stream>>>(src, off, w_tiles, out, g);
  return cudaGetLastError();
}

int pix_lanes(int th, int tw) {
  const int npix = th * tw;
  return npix <= 16 ? 16 : npix <= 32 ? 32 : npix <= 64 ? 64 : 0;
}

Geometry make_geometry(int hp, int wp, int c, int ho, int wo, int m, int k,
                       int s, int d, float bound, int hb, int th, int tw,
                       int tc, int tm) {
  Geometry g;
  g.hp = hp; g.wp = wp; g.c = c; g.ho = ho; g.wo = wo; g.m = m; g.nt = 0;
  g.k = k; g.s = s; g.d = d; g.hb = hb; g.bound = bound;
  g.th = th; g.tw = tw; g.tc = tc; g.tm = tm;
  g.band_h = (th - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.band_w = (tw - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.w_tiles = (wo + tw - 1) / tw;
  return g;
}

// Check the tiles and launch the instantiation for their pixel count.
int forward(const float* src, const float* off, const float* w_tiles,
            float* out, int n, const Geometry& g, void* stream) {
  const int pix = pix_lanes(g.th, g.tw);
  if (pix == 0 || g.tm < 1 || g.tm > kTileMMax || g.tc < 1 ||
      g.c % g.tc != 0)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(g, pix) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (pix == 16)
    e = launch<16>(src, off, w_tiles, out, n, g, st);
  else if (pix == 32)
    e = launch<32>(src, off, w_tiles, out, n, g, st);
  else
    e = launch<64>(src, off, w_tiles, out, n, g, st);
  return (int)e;
}

}  // namespace

extern "C" {

// Shared memory one block of the given tiles needs (bytes); 0 if the
// tile has more pixels than the kernel's 64 lanes.
long long dcf_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                         int tc) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0) return 0;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw, tc,
                             0);
  return (long long)smem_bytes(g, pix);
}

// Launch the fused forward on `stream`.  Returns a cudaError_t (0 on
// success); invalid tiles return cudaErrorInvalidValue before launching.
int dcf_forward(const float* x_pad, const float* off, const float* w_tiles,
                float* out, int n, int hp, int wp, int c, int ho, int wo,
                int m, int k, int s, int d, float bound, int hb, int th,
                int tw, int tc, int tm, void* stream) {
  Geometry g = make_geometry(hp, wp, c, ho, wo, m, k, s, d, bound, hb, th,
                             tw, tc, tm);
  return forward(x_pad, off, w_tiles, out, n, g, stream);
}

// Launch the banded forward (kernel 4) on `stream`: bands (n, nt, band_h,
// w_pad, c) from plan.pad_and_band, offsets (n, nt * th, wo, 2*k*k), out
// (n, nt * th, wo, m).  band_h must be the Eq. 6 extent of th rows.
int dcf_forward_banded(const float* bands, const float* off,
                       const float* w_tiles, float* out, int n, int nt,
                       int band_h, int w_pad, int c, int wo, int m, int k,
                       int s, int d, float bound, int hb, int th, int tw,
                       int tc, int tm, void* stream) {
  Geometry g = make_geometry(band_h, w_pad, c, nt * th, wo, m, k, s, d,
                             bound, hb, th, tw, tc, tm);
  if (nt < 1 || g.band_h != band_h) return (int)cudaErrorInvalidValue;
  g.nt = nt;
  return forward(bands, off, w_tiles, out, n, g, stream);
}

const char* dcf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

