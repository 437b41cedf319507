// The DCNv3 core (InternImage, arXiv:2211.05778) with offsets bounded at
// +-B, fp32, stride 1, kernel 3x3 (as InternImage publishes at every
// size), for sm_90a (H100).
//
// Replaces no TPU kernel: the JAX package has no DCNv3.  It is the one
// operation of an InternImage layer that no library call computes: per
// group g of gc channels, output pixel (y, x) and tap t of the K*K grid
// (x outer, y inner: t = ix*K + iy, as dcnv3_core_pytorch orders them),
//   y_g(y, x) = sum_t m_gt(y, x) * bilinear(v_g, (y - K/2 + iy + dy_gt,
//                                                  x - K/2 + ix + dx_gt))
// with (dx, dy) each clamped to +-B (fminf(fmaxf(o, -B), B): a NaN goes to
// -B), m_g the softmax of the group's K*K mask logits, and zero outside
// the image.  Inputs: v (n, h, w, c); offsets (n, h, w, G*K*K*2), (dx, dy)
// a tap; mask logits (n, h, w, G*K*K).  Output y (n, h, w, c).
//
// What bounds it on this card: bytes.  Each output element takes
// K*K*(7 + 2) fp32 operations, while v, the offsets, the mask and y cross
// device memory once (core/h100.dcnv3_work).  Design:
//   * one block of 256 threads per (output tile th x tw, chunk of gpb
//     groups, image); nothing of size K*K*C reaches device memory;
//   * the block stages the tile's bounded window of v, (th + K + 2*hb) x
//     (tw + K + 2*hb) positions of the chunk's channels, once, with
//     cp.async (16 bytes a copy, zero-filled outside the image, so the
//     input needs no padded copy and out-of-image corners read zero), the
//     window of the zero-copy DCL kernels (deform_sample.cu) without
//     plan.pad_zerocopy's copy of the input;
//   * while the copies fly, each (pixel, group) pair's softmax over its
//     K*K logits and each tap's clamped position, bilinear weights times
//     its softmax weight and window index are computed once, into shared
//     memory;
//   * each thread then owns (pixel, group, 4 channels): 4 float4 window
//     reads a tap, the sum in registers, one float4 store of y.
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn: no
// FMA contraction), in the order of the plain version in
// kernels/dcnv3.py; the two differ only where expf and the softmax's
// division round otherwise than torch's.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kK = 3, kTaps = kK * kK;
constexpr long long kSmemMax = 232448;

}  // namespace

extern "C" {

// One call's plan.  The caller fills the first block of fields; dv3_plan
// checks them and fills the rest.  Mirrored by _Dv3Plan in
// kernels/dcnv3.py.
struct Dv3Plan {
  int n, h, w, c, groups;  // v (n, h, w, c), groups of gc = c / groups
  int k, hb;               // kernel size, ceil(bound)
  float bound;
  int th, tw, gpb;         // output tile, groups a block
  // Filled by dv3_plan.
  int gc, band_h, band_w, h_tiles, w_tiles, chunks, smem;
};

}  // extern "C"

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float4 axpy4(float4 acc, float a, float4 v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(a, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(a, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(a, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(a, v.w));
  return acc;
}

// Shared memory of one block: the window (npos positions of cc floats),
// the folded corner weights (float4) and the window index (int) of every
// (pixel, group, tap) row.
inline long long smem_bytes(int band_h, int band_w, int cc, int rows) {
  return 4LL * band_h * band_w * cc + 20LL * rows;
}

__global__ void __launch_bounds__(kThreads)
dv3_kernel(const float* __restrict__ v, const float* __restrict__ off,
           const float* __restrict__ msk, float* __restrict__ out,
           const Dv3Plan g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int k = kK, k2 = kTaps, pad = kK / 2;
  const int cc = g.gpb * g.gc;  // channels of a staged position
  const int npos = g.band_h * g.band_w;
  const int pairs = g.th * g.tw * g.gpb;
  float* win = reinterpret_cast<float*>(smem);
  float4* gw = reinterpret_cast<float4*>(win + (size_t)npos * cc);
  int* gi = reinterpret_cast<int*>(gw + pairs * k2);

  const int n = blockIdx.z;
  const int jt = blockIdx.x / g.w_tiles;
  const int wt = blockIdx.x - jt * g.w_tiles;
  const int g0 = blockIdx.y * g.gpb;
  const int ng = min(g.gpb, g.groups - g0);
  const int oy0 = jt * g.th, ox0 = wt * g.tw;
  const int wy0 = oy0 - pad - g.hb, wx0 = ox0 - pad - g.hb;
  const int tid = threadIdx.x;

  // The window, 16 bytes a copy; lanes of absent groups and positions
  // outside the image are zero-filled.
  const int lanes = cc / 4, live_lanes = ng * g.gc / 4;
  const float* vn = v + (size_t)n * g.h * g.w * g.c + (size_t)g0 * g.gc;
  for (int i = tid; i < npos * lanes; i += kThreads) {
    const int pos = i / lanes, l = i - pos * lanes;
    const int r = pos / g.band_w, q = pos - r * g.band_w;
    const int yy = wy0 + r, xx = wx0 + q;
    const bool ok = l < live_lanes && yy >= 0 && yy < g.h && xx >= 0 &&
                    xx < g.w;
    const float* src = ok ? vn + ((size_t)yy * g.w + xx) * g.c + l * 4 : v;
    cp_async16(win + (size_t)pos * cc + l * 4, src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Each (pixel, group) pair: the softmax of its logits, then each tap's
  // folded corner weights and the window index of its top-left corner.
  const int stride_off = g.groups * 2 * k2, stride_msk = g.groups * k2;
  for (int i = tid; i < pairs; i += kThreads) {
    const int p = i / g.gpb, gl = i - p * g.gpb;
    const int t = p / g.tw, u = p - t * g.tw;
    const int y = oy0 + t, x = ox0 + u;
    if (gl >= ng || y >= g.h || x >= g.w) continue;
    const size_t pix = ((size_t)n * g.h + y) * g.w + x;
    const float* o = off + pix * stride_off + (size_t)(g0 + gl) * 2 * k2;
    const float* m = msk + pix * stride_msk + (size_t)(g0 + gl) * k2;
    float e[kTaps];
    float mx = -INFINITY;
    for (int kt = 0; kt < k2; ++kt) {
      e[kt] = m[kt];
      mx = fmaxf(mx, e[kt]);
    }
    float s = 0.f;
    for (int kt = 0; kt < k2; ++kt) {
      e[kt] = expf(__fsub_rn(e[kt], mx));
      s = __fadd_rn(s, e[kt]);
    }
    for (int kt = 0; kt < k2; ++kt) {
      const float a = __fdiv_rn(e[kt], s);
      const int ix = kt / k, iy = kt - ix * k;
      const float dx = fminf(fmaxf(o[2 * kt], -g.bound), g.bound);
      const float dy = fminf(fmaxf(o[2 * kt + 1], -g.bound), g.bound);
      const float px = __fadd_rn((float)(x - pad + ix), dx);
      const float py = __fadd_rn((float)(y - pad + iy), dy);
      const float x0 = floorf(px), y0 = floorf(py);
      const float tx = __fsub_rn(px, x0), ty = __fsub_rn(py, y0);
      const float ux = __fsub_rn(1.f, tx), uy = __fsub_rn(1.f, ty);
      gw[i * k2 + kt] = make_float4(
          __fmul_rn(a, __fmul_rn(uy, ux)), __fmul_rn(a, __fmul_rn(uy, tx)),
          __fmul_rn(a, __fmul_rn(ty, ux)), __fmul_rn(a, __fmul_rn(ty, tx)));
      gi[i * k2 + kt] = ((int)y0 - wy0) * g.band_w + ((int)x0 - wx0);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // (pixel, group, 4 channels) a thread: the taps' corners in the order
  // 00, 01, 10, 11, summed tap by tap.
  const int quads = g.gc / 4;
  const int row = g.band_w * cc;
  for (int i = tid; i < pairs * quads; i += kThreads) {
    const int pg = i / quads, qd = i - pg * quads;
    const int p = pg / g.gpb, gl = pg - p * g.gpb;
    const int t = p / g.tw, u = p - t * g.tw;
    const int y = oy0 + t, x = ox0 + u;
    if (gl >= ng || y >= g.h || x >= g.w) continue;
    const int ch = gl * g.gc + qd * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 3
    for (int kt = 0; kt < k2; ++kt) {
      const float4 wt4 = gw[pg * k2 + kt];
      const float* b = win + (size_t)gi[pg * k2 + kt] * cc + ch;
      acc = axpy4(acc, wt4.x, *reinterpret_cast<const float4*>(b));
      acc = axpy4(acc, wt4.y, *reinterpret_cast<const float4*>(b + cc));
      acc = axpy4(acc, wt4.z, *reinterpret_cast<const float4*>(b + row));
      acc = axpy4(acc, wt4.w,
                  *reinterpret_cast<const float4*>(b + row + cc));
    }
    const size_t pix = ((size_t)n * g.h + y) * g.w + x;
    *reinterpret_cast<float4*>(out + pix * g.c + (size_t)g0 * g.gc + ch) =
        acc;
  }
}

int launch(const float* v, const float* off, const float* msk, float* out,
           const Dv3Plan& g, int dev, cudaStream_t stream) {
  static int attr[kMaxDevices];
  if (g.smem > attr[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        dv3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
    attr[dev] = g.smem;
  }
  const dim3 grid(g.h_tiles * g.w_tiles, g.chunks, g.n);
  dv3_kernel<<<grid, kThreads, g.smem, stream>>>(v, off, msk, out, g);
  return (int)cudaGetLastError();
}

int band(int tile, int k, int hb) { return tile + k + 2 * hb; }

}  // namespace

extern "C" {

// Check a plan and fill its derived fields.  Returns 0, or
// cudaErrorInvalidValue for sizes or tiles the kernel does not take: K
// must be 3, the group width a multiple of 4 (float4 copies), hb at least
// the bound.
int dv3_plan(Dv3Plan* g) {
  const int bad = (int)cudaErrorInvalidValue;
  if (g->n < 1 || g->n > 65535 || g->h < 1 || g->w < 1 || g->groups < 1 ||
      g->c % g->groups || g->k != kK || g->hb < 0 || !(g->bound >= 0.f) ||
      g->bound > (float)g->hb || g->th < 1 || g->tw < 1 || g->gpb < 1 ||
      g->gpb > g->groups)
    return bad;
  g->gc = g->c / g->groups;
  if (g->gc % 4) return bad;
  g->band_h = band(g->th, g->k, g->hb);
  g->band_w = band(g->tw, g->k, g->hb);
  g->h_tiles = (g->h + g->th - 1) / g->th;
  g->w_tiles = (g->w + g->tw - 1) / g->tw;
  g->chunks = (g->groups + g->gpb - 1) / g->gpb;
  if ((long long)g->h_tiles * g->w_tiles >= (1LL << 31) ||
      g->chunks > 65535)
    return bad;
  const long long smem =
      smem_bytes(g->band_h, g->band_w, g->gpb * g->gc,
                 g->th * g->tw * g->gpb * g->k * g->k);
  if (smem > kSmemMax) return bad;
  g->smem = (int)smem;
  return 0;
}

// The DCNv3 core on `stream` of `device` (made current for the launch
// where it is not): v (n, h, w, c), offsets (n, h, w, groups*k*k*2) and
// mask logits (n, h, w, groups*k*k), all fp32, contiguous, v 16-byte
// aligned; out (n, h, w, c).  `plan` must have passed dv3_plan.  Returns
// a cudaError_t (0 on success).
int dv3_launch(const void* v, const void* off, const void* msk, void* out,
               const Dv3Plan* plan, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(off);
  const float* mf = static_cast<const float*>(msk);
  float* yf = static_cast<float*>(out);
  const int err = launch(vf, of, mf, yf, *plan, device, st);
  if (cur != device) cudaSetDevice(cur);
  return err;
}

const char* dv3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
