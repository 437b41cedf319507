// Bounded bilinear sampling (the DCL's stage 1, no contraction), fp32, for
// sm_90a (H100).
//
// Replaces two TPU kernels, one entry point each:
//  * ds_zerocopy: repro/kernels/deform_sample.py deform_sample_zerocopy
//    (kernel 1b), the plan of band_pipeline.forward_call with tile_m=None
//    (pallas_call at band_pipeline.py:644), which samples from windows of
//    the zero-padded input;
//  * ds_banded: repro/kernels/deform_sample.py deform_sample_banded
//    (kernel 3, pallas_call at deform_sample.py:107), which samples from
//    the HBM-materialised bands of plan.pad_and_band.
//
// What it computes, per output pixel (oy, ox), tap and channel c:
//   patches[n, oy, ox, tap, c] = bilinear(src[.., c], pos(tap))
// with pos the band-local Eq. 6 position of the tap plus its offset
// clamped to +-B, the corners in JAX's order (00, 01, 10, 11).  Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction), in the order of the plain version, so the two agree bit
// for bit.
//
// What bounds it on this card: bytes.  The output is K*K times the input
// (9x at K = 3), and each output element costs four shared-memory loads
// and seven flops, so writing the patches dominates.  Design:
//   * one block per (image, output tile, channel chunk of tile_c <= 32);
//   * stage the tile's band chunk in shared memory, position-major with
//     the channels innermost: consecutive threads load consecutive
//     channels (coalesced) and later read consecutive words (no bank
//     conflicts);
//   * corner geometry (band index, ty, tx) of every (tap, pixel), once
//     per block;
//   * thread i writes channel i % tile_c of (pixel, tap) i / tile_c, so a
//     warp writes tile_c * 4 contiguous bytes (128 at tile_c = 32) of each
//     (pixel, tap) along C.
// Zero-copy: the band of tile (j, w) is the window of x_pad at row
// j*th*S, column w*tw*S, and positions are band-local (t*S + hb + ky*d).
// Banded: the band of row tile j is bands[n, j]; a block takes tile_w of
// its output columns from u0 and stages the band's columns u0*S ..
// u0*S + band_w(tile_w).  Column positions are those of the whole band,
// (u0 + u)*S + hb + kx*d plus the offset, as the TPU kernel computes them
// over the full width, shifted by u0*S after the floor (an exact integer
// step).  Staged columns past w_pad read 0: only masked pixels of the
// ragged last column tile reach them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int hp, wp, c;     // one source plane: x_pad, or one band (band_h x w_pad)
  int nt;            // banded: band tiles per image; 0: x_pad
  int ho, wo;        // output extent (the offsets' rows and columns)
  int k, s, d, hb;
  float bound;
  int th, tw, tc;
  int band_h, band_w, w_tiles;
};

inline size_t smem_bytes(const Geometry& g) {
  const size_t k2 = (size_t)g.k * g.k;
  return 4 * ((size_t)g.band_h * g.band_w * g.tc +
              3 * k2 * g.th * g.tw);
}

__global__ void __launch_bounds__(kThreads)
ds_kernel(const float* __restrict__ src, const float* __restrict__ off,
          float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int k2 = g.k * g.k;
  const int pix = g.th * g.tw;
  float* band = smem;
  float* gty = band + g.band_h * g.band_w * g.tc;
  float* gtx = gty + k2 * pix;
  int* gidx = reinterpret_cast<int*>(gtx + k2 * pix);

  const int n = blockIdx.z;
  const int c0 = blockIdx.y * g.tc;
  const int jt = blockIdx.x / g.w_tiles;
  const int wt = blockIdx.x % g.w_tiles;
  const int tid = threadIdx.x;
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

  // Corner geometry of every (tap, pixel), as
  // repro/kernels/band_pipeline.py corner_geometry computes it.
  for (int i = tid; i < k2 * pix; i += kThreads) {
    const int kt = i / pix, p = i % pix;
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
    const float py =
        __fadd_rn((float)(t * g.s + g.hb + (kt / g.k) * g.d), dy);
    const float px =
        __fadd_rn((float)((pu0 + u) * g.s + g.hb + (kt % g.k) * g.d), dx);
    const float y0 = floorf(py), x0 = floorf(px);
    gty[i] = __fsub_rn(py, y0);
    gtx[i] = __fsub_rn(px, x0);
    gidx[i] = (int)y0 * g.band_w + (int)x0 - pu0 * g.s;
  }
  // Band chunk: consecutive threads load consecutive channels.
  const int band_n = g.band_h * g.band_w * g.tc;
  for (int i = tid; i < band_n; i += kThreads) {
    const int ch = i % g.tc, pos = i / g.tc;
    const int r = pos / g.band_w, q = pos % g.band_w;
    band[i] = col0 + q < g.wp
                  ? plane[((size_t)(row0 + r) * g.wp + col0 + q) * g.c +
                          c0 + ch]
                  : 0.f;
  }
  __syncthreads();

  // Patches: channel fastest, then tap, then pixel.
  const int row = g.band_w * g.tc;
  for (int i = tid; i < pix * k2 * g.tc; i += kThreads) {
    const int ch = i % g.tc, q = i / g.tc;
    const int kt = q % k2, p = q / k2;
    const int oy = jt * g.th + p / g.tw, ox = wt * g.tw + p % g.tw;
    if (oy >= g.ho || ox >= g.wo) continue;
    const int gi = kt * pix + p;
    const float ty = gty[gi], tx = gtx[gi];
    const float* b = band + gidx[gi] * g.tc + ch;
    const float uy = __fsub_rn(1.f, ty), ux = __fsub_rn(1.f, tx);
    float v = __fmul_rn(b[0], __fmul_rn(uy, ux));
    v = __fadd_rn(v, __fmul_rn(b[g.tc], __fmul_rn(uy, tx)));
    v = __fadd_rn(v, __fmul_rn(b[row], __fmul_rn(ty, ux)));
    v = __fadd_rn(v, __fmul_rn(b[row + g.tc], __fmul_rn(ty, tx)));
    out[(((size_t)n * g.ho + oy) * g.wo + ox) * k2 * g.c + (size_t)kt * g.c +
        c0 + ch] = v;
  }
}

Geometry make_geometry(int hp, int wp, int c, int ho, int wo, int k, int s,
                       int d, float bound, int hb, int th, int tw, int tc) {
  Geometry g;
  g.hp = hp; g.wp = wp; g.c = c; g.nt = 0; g.ho = ho; g.wo = wo;
  g.k = k; g.s = s; g.d = d; g.hb = hb; g.bound = bound;
  g.th = th; g.tw = tw; g.tc = tc;
  g.band_h = (th - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.band_w = (tw - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.w_tiles = (wo + tw - 1) / tw;
  return g;
}

// Check the tiles and launch one block per (tile, channel chunk, image).
int sample(const float* src, const float* off, float* out, int n,
           const Geometry& g, void* stream) {
  if (g.th < 1 || g.tw < 1 || g.tc < 1 || g.c % g.tc != 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int h_tiles = (g.ho + g.th - 1) / g.th;
  const dim3 grid(h_tiles * g.w_tiles, g.c / g.tc, n);
  ds_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, off, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of the given tiles needs (bytes).
long long ds_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                        int tc) {
  return (long long)smem_bytes(
      make_geometry(0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw, tc));
}

// Kernel 1b on `stream`: x_pad (n, hp, wp, c) from plan.pad_zerocopy,
// offsets (n, ho, wo, 2*k*k), out (n, ho, wo, k*k, c).  Returns a
// cudaError_t (0 on success); invalid tiles return cudaErrorInvalidValue
// before launching.
int ds_zerocopy(const float* x_pad, const float* off, float* out, int n,
                int hp, int wp, int c, int ho, int wo, int k, int s, int d,
                float bound, int hb, int th, int tw, int tc, void* stream) {
  return sample(x_pad, off, out, n,
                make_geometry(hp, wp, c, ho, wo, k, s, d, bound, hb, th, tw,
                              tc),
                stream);
}

// Kernel 3 on `stream`: bands (n, nt, band_h, w_pad, c) from
// plan.pad_and_band, offsets (n, nt * th, wo, 2*k*k), out (n, nt * th, wo,
// k*k, c).  band_h must be the Eq. 6 extent of th rows.
int ds_banded(const float* bands, const float* off, float* out, int n,
              int nt, int band_h, int w_pad, int c, int wo, int k, int s,
              int d, float bound, int hb, int th, int tw, int tc,
              void* stream) {
  Geometry g = make_geometry(band_h, w_pad, c, nt * th, wo, k, s, d, bound,
                             hb, th, tw, tc);
  if (nt < 1 || g.band_h != band_h) return (int)cudaErrorInvalidValue;
  g.nt = nt;
  return sample(bands, off, out, n, g, stream);
}

const char* ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
