// Fused bounded deformable convolution on the int8 datapath, for sm_90a.
//
// Two kernels from one template:
//   * dcq_forward replaces the TPU kernel of
//     repro/kernels/deform_conv_q.py deform_conv_fused_zerocopy_q (:74),
//     emitted by band_pipeline.forward_call (pallas_call at
//     band_pipeline.py:644) with an int8 band, int32 accumulation and the
//     per-M "dequant" epilogue;
//   * dcc_forward replaces deform_conv_q.py deform_conv_fused_zerocopy_chain
//     (:108): the same emitter with the fused int8 offset-conv stage
//     (band_pipeline.offset_conv_stage, :398) and a "requant" epilogue that
//     emits int8 on the next layer's grid ("dequant" + bias for the fp32
//     chain tail).
//
// What they compute, per output pixel p and output channel m:
//   patch[p, tap, c] = round(bilinear(x_q[c], pos(p, tap)))        (int8)
//   acc[p, m]        = sum_{tap, c} patch[p, tap, c] * w_q[tap, c, m] (int32)
//   dcq: y = acc * scale[m]                                          (fp32)
//   dcc: y = acc * out_scale[m] + out_bias[m]; int8: clip(rint(y), +-127)
// with pos(p, tap) the band-local Eq. 6 position plus the tap's offset
// clamped to +-B.  dcq reads the fp32 offsets; dcc computes them itself:
//   off[p, o] = (sum_{tap, c} x_q[undeformed tap] * woff_q[tap, c, o])
//               * off_scale[o] + off_bias[o]
// so no offset ever reaches device memory.
//
// Arithmetic that matches the plain PyTorch versions bit for bit: every
// fp32 step before a rounding to int8 (positions, fractions, coefficients,
// corner products and sums, offset dequant, epilogues) is written with
// __fadd_rn / __fsub_rn / __fmul_rn, so nvcc cannot contract it into an
// FMA, in the order of repro/kernels/band_pipeline.py.  Patches round with
// __float2int_rn (ties to even, as torch.round and jnp.round; roundf would
// round ties away from zero).  The contractions are exact in int32
// (|sum| <= 127^2 * K^2 * C < 2^31 for C <= 14,000).
//
// What bounds them on this card: operations.  int8 moves a quarter of the
// fp32 kernel's bytes, while each output still needs K*K*C multiply-adds;
// at the ResNet-50-DCN shapes the int8 work at the 1,979 TOP/s tensor-core
// rate is still above the time to move x, the weights and y once.  This
// first version runs the contraction on CUDA cores with __dp4a (four int8
// products a lane per instruction, about 1/16 of the tensor-core rate), so
// it is bound by the dp4a issue rate and the shared-memory gathers.
// mma.sync / wgmma s8 tensor cores, TMA and double buffering are later work.
//
// Design (simple first):
//   * one block per (image, tile_h x tile_w output pixels, tile_m <= 64
//     output channels), as deform_conv_fused.cu; the TPU's sequential C
//     axis is a loop inside the block; the ragged edge of the image and of
//     M is masked in the kernel;
//   * x, patches and weights live in shared memory as 32-bit words of four
//     channels: the band is staged channel-group-major with an odd plane
//     stride, each patch word is four bilinear samples rounded to int8,
//     each weight word packs four channels of one output channel, and a
//     thread accumulates 4 pixels x 4 output channels with __dp4a;
//   * chain, whole-C band: the TPU kernel stages all of C so that the
//     offsets are complete before the first sample; a full-C int8
//     band of an 8x8 stride-2 tile at C=512 is 248 KB, more than a block's
//     227 KB.  Of the two ways out (keep the whole-C band and shrink the
//     spatial tile, or stream C twice) this kernel takes the second: two
//     passes over C-chunks of tile_c.  Pass A
//     stages each chunk of the band and of the offset-conv weights and
//     accumulates the offset conv over the undeformed taps in int32; the
//     offsets, then the corner geometry, follow once all of C is summed.
//     Pass B re-stages the chunks (from L2: a layer's int8 input is at most
//     a few MB) and samples and contracts as dcq does.  So the chain's
//     tile_c is a free chunk size, not C, and the spatial tile is chosen
//     as for dcq.  Every M-tile block of a pixel tile recomputes pass A:
//     2*K*K/tile_m more dot products (28% at tile_m = 64), in exchange for
//     no offsets in device memory and no second launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTileMMax = 64;   // output channels per block (16 x 4 lanes)

struct Geometry {
  int hp, wp, c, ho, wo, m;
  int k, s, d, hb;
  float bound;
  int th, tw, tc, tm;
  int band_h, band_w, w_tiles;
};

__host__ __device__ inline int band_words(const Geometry& g) {
  const int plane = (g.band_h * g.band_w) | 1;
  return ((g.tc / 4 * plane + 3) / 4) * 4;
}

// Shared memory of one block, in bytes (tiling.q_smem_bytes mirrors it).
inline size_t smem_bytes(const Geometry& g, int pix, bool chain) {
  const size_t k2 = (size_t)g.k * g.k;
  const size_t kk4 = k2 * (g.tc / 4);
  size_t words = band_words(g) + kk4 * pix + kk4 * kTileMMax + 5 * k2 * pix;
  if (chain) words += kk4 * 2 * k2 + (size_t)pix * 2 * k2;
  return 4 * words;
}

__device__ __forceinline__ int sbyte(int word, int b) {
  return (int)(signed char)(word >> (8 * b));
}

// Four int8 values of one column, rows r, r+stride, r+2*stride, r+3*stride
// of a row-major int8 matrix, packed low byte first.
__device__ __forceinline__ int pack4(const int8_t* p, size_t stride) {
  return (int)(((unsigned)(uint8_t)p[0]) |
               ((unsigned)(uint8_t)p[stride] << 8) |
               ((unsigned)(uint8_t)p[2 * stride] << 16) |
               ((unsigned)(uint8_t)p[3 * stride] << 24));
}

// Stage one tc-channel chunk of the tile's band as 4-channel words,
// channel-group-major: band[ch4 * plane + r * band_w + q].  Consecutive
// threads read consecutive words of x (coalesced) and write words one odd
// plane apart (spread over the banks).
__device__ __forceinline__ void stage_band(int* band, const int* xw,
                                           const Geometry& g, int n, int row0,
                                           int col0, int c0, int tid,
                                           int threads) {
  const int tc4 = g.tc / 4, c4 = g.c / 4;
  const int plane = (g.band_h * g.band_w) | 1;
  const int band_n = g.band_h * g.band_w * tc4;
  for (int i = tid; i < band_n; i += threads) {
    const int ch4 = i % tc4, pos = i / tc4;
    const int r = pos / g.band_w, q = pos % g.band_w;
    band[ch4 * plane + pos] =
        xw[((size_t)(n * g.hp + row0 + r) * g.wp + col0 + q) * c4 +
           c0 / 4 + ch4];
  }
}

template <int PIX, bool CHAIN, bool EMIT_INT8>
__global__ void __launch_bounds__(PIX * 4)
dcq_kernel(const int8_t* __restrict__ x_pad, const float* __restrict__ off,
           const int8_t* __restrict__ w_tiles,
           const int8_t* __restrict__ woff_tiles,
           const float* __restrict__ off_scale,
           const float* __restrict__ off_bias,
           const float* __restrict__ out_scale,
           const float* __restrict__ out_bias, void* __restrict__ out,
           Geometry g) {
  extern __shared__ __align__(16) int smem[];
  const int k2 = g.k * g.k;
  const int tc4 = g.tc / 4;
  const int kk4_n = k2 * tc4;
  const int n_off = 2 * k2;
  const int plane = (g.band_h * g.band_w) | 1;
  int* band = smem;
  int* P = band + band_words(g);
  int* W = P + kk4_n * PIX;
  int* gidx = W + kk4_n * kTileMMax;
  float* gw00 = reinterpret_cast<float*>(gidx + k2 * PIX);
  float* gw01 = gw00 + k2 * PIX;
  float* gw10 = gw01 + k2 * PIX;
  float* gw11 = gw10 + k2 * PIX;
  int* WO = reinterpret_cast<int*>(gw11 + k2 * PIX);   // CHAIN only
  int* oacc = WO + kk4_n * n_off;                      // CHAIN only

  const int n = blockIdx.z;
  const int m0 = blockIdx.y * g.tm;
  const int jt = blockIdx.x / g.w_tiles;
  const int wt = blockIdx.x % g.w_tiles;
  const int row0 = jt * g.th * g.s;
  const int col0 = wt * g.tw * g.s;
  const int tid = threadIdx.y * 16 + threadIdx.x;
  constexpr int kThreads = PIX * 4;
  const int npix = g.th * g.tw;
  const int c_steps = g.c / g.tc;
  const int* xw = reinterpret_cast<const int*>(x_pad);

  // Pass A (chain): the offset conv over the undeformed taps, exact int32,
  // accumulated over the C-chunks.  Pair (p, o) belongs to one thread for
  // the whole pass.
  if (CHAIN) {
    for (int i = tid; i < npix * n_off; i += kThreads) oacc[i] = 0;
    for (int cs = 0; cs < c_steps; ++cs) {
      const int c0 = cs * g.tc;
      __syncthreads();  // the previous chunk's dot products are done
      stage_band(band, xw, g, n, row0, col0, c0, tid, kThreads);
      for (int i = tid; i < kk4_n * n_off; i += kThreads) {
        const int o = i % n_off, kk4 = i / n_off;
        const int kt = kk4 / tc4, ch4 = kk4 % tc4;
        WO[i] = pack4(woff_tiles + ((size_t)kt * g.c + c0 + ch4 * 4) * n_off +
                          o,
                      n_off);
      }
      __syncthreads();
      for (int i = tid; i < npix * n_off; i += kThreads) {
        const int p = i / n_off, o = i % n_off;
        const int t = p / g.tw, u = p % g.tw;
        int a = oacc[i];
        for (int kt = 0; kt < k2; ++kt) {
          const int pos = (t * g.s + g.hb + (kt / g.k) * g.d) * g.band_w +
                          u * g.s + g.hb + (kt % g.k) * g.d;
          const int* bp = band + pos;
          const int* wp = WO + kt * tc4 * n_off + o;
          for (int ch4 = 0; ch4 < tc4; ++ch4)
            a = __dp4a(bp[ch4 * plane], wp[ch4 * n_off], a);
        }
        oacc[i] = a;
      }
    }
    __syncthreads();
  }

  // Corner geometry of every (tap, pixel), band-local, with the
  // coefficient expressions of band_pipeline.corner_geometry and
  // _bilinear_int8_from_band.
  for (int i = tid; i < k2 * PIX; i += kThreads) {
    const int kt = i / PIX, p = i % PIX;
    int idx = 0;
    float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
    if (p < npix) {
      const int t = p / g.tw, u = p % g.tw;
      const int oy = jt * g.th + t, ox = wt * g.tw + u;
      float dy = 0.f, dx = 0.f;
      if (CHAIN) {
        const int* a = oacc + p * n_off + 2 * kt;
        dy = __fadd_rn(__fmul_rn(__int2float_rn(a[0]), off_scale[2 * kt]),
                       off_bias[2 * kt]);
        dx = __fadd_rn(__fmul_rn(__int2float_rn(a[1]), off_scale[2 * kt + 1]),
                       off_bias[2 * kt + 1]);
      } else if (oy < g.ho && ox < g.wo) {
        const float* o =
            off + (((size_t)n * g.ho + oy) * g.wo + ox) * n_off + 2 * kt;
        dy = o[0];
        dx = o[1];
      }
      dy = fminf(fmaxf(dy, -g.bound), g.bound);
      dx = fminf(fmaxf(dx, -g.bound), g.bound);
      const float py =
          __fadd_rn((float)(t * g.s + g.hb + (kt / g.k) * g.d), dy);
      const float px =
          __fadd_rn((float)(u * g.s + g.hb + (kt % g.k) * g.d), dx);
      const float y0 = floorf(py), x0 = floorf(px);
      const float ty = __fsub_rn(py, y0), tx = __fsub_rn(px, x0);
      const float uy = __fsub_rn(1.f, ty), ux = __fsub_rn(1.f, tx);
      w00 = __fmul_rn(uy, ux);
      w01 = __fmul_rn(uy, tx);
      w10 = __fmul_rn(ty, ux);
      w11 = __fmul_rn(ty, tx);
      idx = (int)y0 * g.band_w + (int)x0;
    }
    gidx[i] = idx;
    gw00[i] = w00;
    gw01[i] = w01;
    gw10[i] = w10;
    gw11[i] = w11;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  // Pass B: sample and contract, one C-chunk at a time.
  for (int cs = 0; cs < c_steps; ++cs) {
    const int c0 = cs * g.tc;
    __syncthreads();  // the previous chunk's dot products are done
    if (!CHAIN || c_steps > 1)   // else pass A's band is still staged
      stage_band(band, xw, g, n, row0, col0, c0, tid, kThreads);
    // Weight words W[(tap * tc4 + ch4) * 64 + j]: four channels of output
    // channel m0 + j.  Rows of w_tiles: (c0 / tc) * K*K*tc + tap * tc + ch
    // for dcq (plan.tile_weights at tile_c), tap * C + c0 + ch for dcc
    // (tile_c = C, as the TPU plan lays it out).
    for (int i = tid; i < kk4_n * kTileMMax; i += kThreads) {
      const int j = i % kTileMMax, kk4 = i / kTileMMax;
      const int kt = kk4 / tc4, ch4 = kk4 % tc4;
      const size_t row = CHAIN ? (size_t)kt * g.c + c0 + ch4 * 4
                               : (size_t)cs * k2 * g.tc + kt * g.tc + ch4 * 4;
      W[i] = (j < g.tm && m0 + j < g.m)
                 ? pack4(w_tiles + row * g.m + m0 + j, g.m)
                 : 0;
    }
    __syncthreads();
    // Patch words P[(tap * tc4 + ch4) * PIX + p]: corners in the order
    // (00, 01, 10, 11), products and sums rounded one at a time, then
    // rounded to int8 (a convex mix of int8 values needs no clip).
    for (int i = tid; i < kk4_n * PIX; i += kThreads) {
      const int p = i % PIX, kk4 = i / PIX;
      const int kt = kk4 / tc4, ch4 = kk4 % tc4;
      int word = 0;
      if (p < npix) {
        const int gi = kt * PIX + p;
        const float w00 = gw00[gi], w01 = gw01[gi], w10 = gw10[gi],
                    w11 = gw11[gi];
        const int* b = band + ch4 * plane + gidx[gi];
        const int c00 = b[0], c01 = b[1], c10 = b[g.band_w],
                  c11 = b[g.band_w + 1];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          float v = __fmul_rn((float)sbyte(c00, bb), w00);
          v = __fadd_rn(v, __fmul_rn((float)sbyte(c01, bb), w01));
          v = __fadd_rn(v, __fmul_rn((float)sbyte(c10, bb), w10));
          v = __fadd_rn(v, __fmul_rn((float)sbyte(c11, bb), w11));
          word |= (__float2int_rn(v) & 0xff) << (8 * bb);
        }
      }
      P[i] = word;
    }
    __syncthreads();
    const int* pa = P + threadIdx.y * 4;
    const int* wb = W + threadIdx.x * 4;
#pragma unroll 4
    for (int kk4 = 0; kk4 < kk4_n; ++kk4) {
      const int4 a = *reinterpret_cast<const int4*>(pa + kk4 * PIX);
      const int4 b = *reinterpret_cast<const int4*>(wb + kk4 * kTileMMax);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
  }

  // Epilogue, masking the ragged edge of the image and of M.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = threadIdx.y * 4 + i;
    if (p >= npix) continue;
    const int oy = jt * g.th + p / g.tw, ox = wt * g.tw + p % g.tw;
    if (oy >= g.ho || ox >= g.wo) continue;
    const size_t base = (((size_t)n * g.ho + oy) * g.wo + ox) * g.m + m0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mj = threadIdx.x * 4 + j;
      if (mj >= g.tm || m0 + mj >= g.m) continue;
      float y = __fmul_rn(__int2float_rn(acc[i][j]), out_scale[m0 + mj]);
      if (CHAIN) y = __fadd_rn(y, out_bias[m0 + mj]);
      if (EMIT_INT8) {
        const float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
        static_cast<int8_t*>(out)[base + mj] = (int8_t)(int)r;
      } else {
        static_cast<float*>(out)[base + mj] = y;
      }
    }
  }
}

template <int PIX, bool CHAIN, bool EMIT_INT8>
cudaError_t launch(const int8_t* x_pad, const float* off,
                   const int8_t* w_tiles, const int8_t* woff_tiles,
                   const float* off_scale, const float* off_bias,
                   const float* out_scale, const float* out_bias, void* out,
                   int n, const Geometry& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, PIX, CHAIN);
  auto kernel = dcq_kernel<PIX, CHAIN, EMIT_INT8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int h_tiles = (g.ho + g.th - 1) / g.th;
  const dim3 grid(h_tiles * g.w_tiles, (g.m + g.tm - 1) / g.tm, n);
  const dim3 block(16, PIX / 4);
  kernel<<<grid, block, smem, stream>>>(x_pad, off, w_tiles, woff_tiles,
                                        off_scale, off_bias, out_scale,
                                        out_bias, out, g);
  return cudaGetLastError();
}

template <bool CHAIN, bool EMIT_INT8>
cudaError_t dispatch(int pix, const int8_t* x_pad, const float* off,
                     const int8_t* w_tiles, const int8_t* woff_tiles,
                     const float* off_scale, const float* off_bias,
                     const float* out_scale, const float* out_bias, void* out,
                     int n, const Geometry& g, cudaStream_t st) {
  if (pix == 16)
    return launch<16, CHAIN, EMIT_INT8>(x_pad, off, w_tiles, woff_tiles,
                                        off_scale, off_bias, out_scale,
                                        out_bias, out, n, g, st);
  if (pix == 32)
    return launch<32, CHAIN, EMIT_INT8>(x_pad, off, w_tiles, woff_tiles,
                                        off_scale, off_bias, out_scale,
                                        out_bias, out, n, g, st);
  return launch<64, CHAIN, EMIT_INT8>(x_pad, off, w_tiles, woff_tiles,
                                      off_scale, off_bias, out_scale,
                                      out_bias, out, n, g, st);
}

int pix_lanes(int th, int tw) {
  const int npix = th * tw;
  return npix <= 16 ? 16 : npix <= 32 ? 32 : npix <= 64 ? 64 : 0;
}

Geometry make_geometry(int hp, int wp, int c, int ho, int wo, int m, int k,
                       int s, int d, float bound, int hb, int th, int tw,
                       int tc, int tm) {
  Geometry g;
  g.hp = hp; g.wp = wp; g.c = c; g.ho = ho; g.wo = wo; g.m = m;
  g.k = k; g.s = s; g.d = d; g.hb = hb; g.bound = bound;
  g.th = th; g.tw = tw; g.tc = tc; g.tm = tm;
  g.band_h = (th - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.band_w = (tw - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.w_tiles = (wo + tw - 1) / tw;
  return g;
}

long long smem_for(int k, int s, int d, int hb, int th, int tw, int tc,
                   bool chain) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 4 || tc % 4 != 0) return 0;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw, tc,
                             0);
  return (long long)smem_bytes(g, pix, chain);
}

// Tiles and sizes the kernels refuse, before any launch.
bool invalid(const Geometry& g, int pix, bool chain) {
  return pix == 0 || g.tm < 1 || g.tm > kTileMMax || g.tc < 4 ||
         g.tc % 4 != 0 || g.c % g.tc != 0 ||
         smem_bytes(g, pix, chain) > 232448;
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes); 0 for tiles the kernels refuse
// (more than 64 pixels, tile_c not a positive multiple of 4).
long long dcq_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                         int tc) {
  return smem_for(k, s, d, hb, th, tw, tc, false);
}

long long dcc_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                         int tc) {
  return smem_for(k, s, d, hb, th, tw, tc, true);
}

// int8 fused forward with the per-M dequant epilogue, on `stream`.
// Returns a cudaError_t (0 on success); invalid tiles return
// cudaErrorInvalidValue before launching.
int dcq_forward(const void* x_pad, const float* off, const void* w_tiles,
                const float* scale, float* out, int n, int hp, int wp, int c,
                int ho, int wo, int m, int k, int s, int d, float bound,
                int hb, int th, int tw, int tc, int tm, void* stream) {
  const int pix = pix_lanes(th, tw);
  Geometry g = make_geometry(hp, wp, c, ho, wo, m, k, s, d, bound, hb, th,
                             tw, tc, tm);
  if (invalid(g, pix, false)) return (int)cudaErrorInvalidValue;
  return (int)dispatch<false, false>(
      pix, static_cast<const int8_t*>(x_pad), off,
      static_cast<const int8_t*>(w_tiles), nullptr, nullptr, nullptr, scale,
      nullptr, out, n, g, static_cast<cudaStream_t>(stream));
}

// int8 chain forward: fused offset conv, then the requant (emit_int8 = 1,
// int8 output) or dequant + bias (emit_int8 = 0, fp32 output) epilogue.
int dcc_forward(const void* x_pad, const void* w_tiles,
                const void* woff_tiles, const float* off_scale,
                const float* off_bias, const float* out_scale,
                const float* out_bias, void* out, int emit_int8, int n,
                int hp, int wp, int c, int ho, int wo, int m, int k, int s,
                int d, float bound, int hb, int th, int tw, int tc, int tm,
                void* stream) {
  const int pix = pix_lanes(th, tw);
  Geometry g = make_geometry(hp, wp, c, ho, wo, m, k, s, d, bound, hb, th,
                             tw, tc, tm);
  if (invalid(g, pix, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x_pad);
  const int8_t* wt = static_cast<const int8_t*>(w_tiles);
  const int8_t* wo_t = static_cast<const int8_t*>(woff_tiles);
  if (emit_int8)
    return (int)dispatch<true, true>(pix, xp, nullptr, wt, wo_t, off_scale,
                                     off_bias, out_scale, out_bias, out, n,
                                     g, st);
  return (int)dispatch<true, false>(pix, xp, nullptr, wt, wo_t, off_scale,
                                    off_bias, out_scale, out_bias, out, n, g,
                                    st);
}

const char* dcq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
