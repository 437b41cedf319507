// Bounded bilinear sampling (the DCL's stage 1, no contraction), fp32 and
// bf16, for sm_90a (H100).
//
// Replaces two TPU kernels, both launched by ds_launch:
//  * kernel 1b (plan nt == 0): repro/kernels/deform_sample.py
//    deform_sample_zerocopy, the plan of band_pipeline.forward_call with
//    tile_m=None (pallas_call at band_pipeline.py:644), which samples from
//    windows of the zero-padded input;
//  * kernel 3 (plan nt > 0): repro/kernels/deform_sample.py
//    deform_sample_banded (pallas_call at deform_sample.py:107), which
//    samples from the HBM-materialised bands of plan.pad_and_band.
//
// What it computes, per output pixel (oy, ox), tap and channel c:
//   patches[n, oy, ox, tap, c] = bilinear(src[.., c], pos(tap))
// with pos the band-local Eq. 6 position of the tap plus its offset
// clamped to +-B (fminf(fmaxf(o, -B), B): a NaN goes to -B), the corners
// in JAX's order (00, 01, 10, 11).  Every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn: no FMA contraction), in the order of the
// plain version, so the two agree bit for bit.  bf16 corners convert to
// fp32 exactly, and the sum rounds once to bf16 (round to nearest even),
// as the plain version's .to(bfloat16).  Offsets are read in their own
// dtype (fp32 or bf16) and converted to fp32.
//
// What bounds it on this card: bytes.  The output is K*K times the input
// (9x at K = 3) and nothing is contracted, so the kernel is a write stream.
// Design:
//   * one block of 256 threads per (output tile, C group, image); the block
//     walks its group's channel chunks (tile_c each) through a ring of two
//     shared-memory stages: cp.async stages chunk k+1 while chunk k is
//     written;
//   * the corner geometry is computed once per block: for each (pixel,
//     tap) row its top-left band position, its four weights w00..w11
//     (band_pipeline.corner_weights, rounded the same way) and its output
//     offset, reused for every chunk;
//   * each thread owns one vector of VB bytes (16 where tile_c allows: 4
//     fp32 or 8 bf16 channels) of one row: four vector loads from shared
//     memory, one streaming store (st.global.cs: the patches are written
//     once and not read back by this kernel).  Rows and lanes come from
//     shifts; runtime divisions happen only in the per-block setup;
//   * the band chunk is position-major with the chunk's channels
//     innermost, so the lanes of a row read one contiguous line (no bank
//     conflicts when tile_c fills 128 bytes).
// Zero-copy: the band of tile (j, w) is the window of x_pad at row
// j*th*S, column w*tw*S, and positions are band-local (t*S + hb + ky*d).
// Banded: the band of row tile j is bands[n, j]; a block takes tile_w of
// its output columns from u0 and stages the band's columns u0*S ..
// u0*S + band_w(tile_w).  Column positions are those of the whole band,
// (u0 + u)*S + hb + kx*d plus the offset, as the TPU kernel computes them
// over the full width, shifted by u0*S after the floor (an exact integer
// step).  Staged columns past w_pad read 0: only masked pixels of the
// ragged last column tile reach them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;
constexpr long long kSmemMax = 232448;

}  // namespace

extern "C" {

// One call's plan.  The caller fills the first block of fields; ds_plan
// checks them and fills the rest.  Mirrored by _DsPlan in
// kernels/deform_sample.py.
struct DsPlan {
  int n, hp, wp, c;  // one source plane: x_pad (hp x wp), or one band
  int nt;            // banded: band tiles per image; 0: zero-copy (x_pad)
  int ho, wo;        // output extent (the offsets' rows and columns)
  int k, s, d, hb;
  float bound;
  int th, tw, tc;
  int groups;        // C groups of the grid (each walks c/tc/groups chunks)
  int elt;           // element bytes: 4 fp32, 2 bf16
  int vec;           // bytes a thread moves at once: 16, 8, 4 or 2
  int off_bf16;      // offsets in bf16 (else fp32)
  // Filled by ds_plan.
  int band_h, band_w, h_tiles, w_tiles, lg_lanes;
  int smem;
};

}  // extern "C"

namespace {

template <int B> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_cs(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void store_cs(uint2* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};\n" ::"l"(p), "r"(v.x),
               "r"(v.y)
               : "memory");
}
__device__ __forceinline__ void store_cs(unsigned int* p, unsigned int v) {
  asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void store_cs(unsigned short* p,
                                         unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p), "h"(v) : "memory");
}

// Copy B bytes from global to shared memory, asynchronously where cp.async
// takes the size (4, 8, 16); zeros where !valid (src is then not read).
template <int B>
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           bool valid) {
  if constexpr (B >= 4) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = valid ? B : 0;
    if constexpr (B == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(src), "r"(n)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                   "l"(src), "n"(B), "r"(n)
                   : "memory");
  } else {
    using R = typename Raw<B>::type;
    *reinterpret_cast<R*>(dst) =
        valid ? *reinterpret_cast<const R*>(src) : R(0);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__host__ __device__ inline int stage_bytes(int npos, int tc, int elt) {
  return (npos * tc * elt + 15) / 16 * 16;
}

// Shared memory of one block: the stage ring, the corner weights (float4)
// and the band position and output offset (int2) of every (pixel, tap)
// row, and each staged position's offset in its plane.
inline long long smem_bytes(int band_h, int band_w, int rows, int tc,
                            int elt) {
  const int npos = band_h * band_w;
  return (long long)kStages * stage_bytes(npos, tc, elt) + 24LL * rows +
         4LL * npos;
}

template <typename T, int KT, int VB>
__global__ void __launch_bounds__(kThreads)
ds_kernel(const T* __restrict__ src, const void* __restrict__ off,
          T* __restrict__ out, const DsPlan g) {
  constexpr int V = VB / (int)sizeof(T);
  using R = typename Raw<VB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = KT ? KT : g.k;
  const int k2 = k * k;
  const int rows = g.th * g.tw * k2;
  const int npos = g.band_h * g.band_w;
  const int stage_elems = stage_bytes(npos, g.tc, (int)sizeof(T)) /
                          (int)sizeof(T);
  T* stages = reinterpret_cast<T*>(smem);
  float4* gw = reinterpret_cast<float4*>(stages + kStages * stage_elems);
  int2* gi = reinterpret_cast<int2*>(gw + rows);
  int* poff = reinterpret_cast<int*>(gi + rows);

  const int n = blockIdx.z;
  const int jt = blockIdx.x / g.w_tiles;
  const int wt = blockIdx.x - jt * g.w_tiles;
  const int tid = threadIdx.x;
  // The staged band's plane, its first row there, and the first output
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
  const int oy0 = jt * g.th, ox0 = wt * g.tw;
  T* out_tile = out + (((size_t)n * g.ho + oy0) * g.wo + ox0) * k2 * g.c;
  const int chunks = g.c / g.tc;
  const int ck0 = blockIdx.y * chunks / g.groups;
  const int nk = (blockIdx.y + 1) * chunks / g.groups - ck0;
  const int lanes = g.tc / V;  // vectors of a position's chunk
  const int lg = g.lg_lanes;   // lanes rounded up to a power of 2

  for (int i = tid; i < npos; i += kThreads) {
    const int r = i / g.band_w, q = i - r * g.band_w;
    poff[i] = col0 + q < g.wp ? ((row0 + r) * g.wp + col0 + q) * g.c : -1;
  }
  __syncthreads();

  // Chunk kk of the group into stage kk % kStages.
  auto issue = [&](int kk) {
    T* dst = stages + (kk % kStages) * stage_elems;
    const T* base = plane + (ck0 + kk) * g.tc;
    for (int i = tid; i < npos << lg; i += kThreads) {
      const int pos = i >> lg, v = i & ((1 << lg) - 1);
      if (v >= lanes) continue;
      const int o = poff[pos];
      stage_copy<VB>(dst + pos * g.tc + v * V,
                     o >= 0 ? base + o + v * V : base, o >= 0);
    }
  };
  issue(0);
  cp_commit();

  // Corner geometry of every (pixel, tap) row, as band_pipeline
  // corner_geometry and corner_weights compute it (overlaps stage 0).
  for (int i = tid; i < rows; i += kThreads) {
    const int p = i / k2, kt = i - p * k2;
    const int t = p / g.tw, u = p - t * g.tw;
    const bool live = oy0 + t < g.ho && ox0 + u < g.wo;
    float dy = 0.f, dx = 0.f;
    if (live) {
      const size_t o =
          (((size_t)n * g.ho + oy0 + t) * g.wo + ox0 + u) * (2 * k2) + 2 * kt;
      if (g.off_bf16) {
        const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(off);
        dy = __bfloat162float(ob[o]);
        dx = __bfloat162float(ob[o + 1]);
      } else {
        const float* of = static_cast<const float*>(off);
        dy = of[o];
        dx = of[o + 1];
      }
    }
    dy = fminf(fmaxf(dy, -g.bound), g.bound);
    dx = fminf(fmaxf(dx, -g.bound), g.bound);
    const int ky = kt / k, kx = kt - ky * k;
    const float py = __fadd_rn((float)(t * g.s + g.hb + ky * g.d), dy);
    const float px = __fadd_rn((float)((pu0 + u) * g.s + g.hb + kx * g.d), dx);
    const float y0 = floorf(py), x0 = floorf(px);
    const float ty = __fsub_rn(py, y0), tx = __fsub_rn(px, x0);
    const float uy = __fsub_rn(1.f, ty), ux = __fsub_rn(1.f, tx);
    gw[i] = make_float4(__fmul_rn(uy, ux), __fmul_rn(uy, tx),
                        __fmul_rn(ty, ux), __fmul_rn(ty, tx));
    gi[i] = make_int2((int)y0 * g.band_w + (int)x0 - pu0 * g.s,
                      live ? ((t * g.wo + u) * k2 + kt) * g.c : -1);
  }

  const int row_stride = g.band_w * g.tc;
  for (int kk = 0; kk < nk; ++kk) {
    if (kk + 1 < nk) issue(kk + 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const T* st = stages + (kk % kStages) * stage_elems;
    T* oc = out_tile + (ck0 + kk) * g.tc;
#pragma unroll 2
    for (int i = tid; i < rows << lg; i += kThreads) {
      const int r = i >> lg, v = i & ((1 << lg) - 1);
      if (v >= lanes) continue;
      const int2 io = gi[r];
      if (io.y < 0) continue;
      const float4 w = gw[r];
      const T* b = st + io.x * g.tc + v * V;
      const R r00 = *reinterpret_cast<const R*>(b);
      const R r01 = *reinterpret_cast<const R*>(b + g.tc);
      const R r10 = *reinterpret_cast<const R*>(b + row_stride);
      const R r11 = *reinterpret_cast<const R*>(b + row_stride + g.tc);
      T e00[V], e01[V], e10[V], e11[V], y[V];
      memcpy(e00, &r00, VB);
      memcpy(e01, &r01, VB);
      memcpy(e10, &r10, VB);
      memcpy(e11, &r11, VB);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float a = __fmul_rn(to_f(e00[j]), w.x);
        a = __fadd_rn(a, __fmul_rn(to_f(e01[j]), w.y));
        a = __fadd_rn(a, __fmul_rn(to_f(e10[j]), w.z));
        a = __fadd_rn(a, __fmul_rn(to_f(e11[j]), w.w));
        y[j] = from_f<T>(a);
      }
      R ry;
      memcpy(&ry, y, VB);
      store_cs(reinterpret_cast<R*>(oc + io.y + v * V), ry);
    }
    __syncthreads();
  }
}

// Launch one instantiation on the current device `dev`; its
// shared-memory attribute is set once per device and size (the largest
// asked so far).
template <typename T, int KT, int VB>
int launch(const void* src, const void* off, void* out, const DsPlan& g,
           int dev, cudaStream_t stream) {
  static int attr[kMaxDevices];
  if (g.smem > attr[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        ds_kernel<T, KT, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        g.smem);
    if (e != cudaSuccess) return (int)e;
    attr[dev] = g.smem;
  }
  const dim3 grid(g.h_tiles * g.w_tiles, g.groups, g.n);
  ds_kernel<T, KT, VB><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const T*>(src), off, static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T, int KT>
int launch_vec(const void* src, const void* off, void* out, const DsPlan& g,
               int dev, cudaStream_t stream) {
  switch (g.vec) {
    case 16: return launch<T, KT, 16>(src, off, out, g, dev, stream);
    case 8: return launch<T, KT, 8>(src, off, out, g, dev, stream);
    case 4: return launch<T, KT, 4>(src, off, out, g, dev, stream);
    default: break;
  }
  if constexpr (sizeof(T) == 2) {
    if (g.vec == 2) return launch<T, KT, 2>(src, off, out, g, dev, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_k(const void* src, const void* off, void* out, const DsPlan& g,
             int dev, cudaStream_t stream) {
  return g.k == 3 ? launch_vec<T, 3>(src, off, out, g, dev, stream)
                  : launch_vec<T, 0>(src, off, out, g, dev, stream);
}

int extent(int tile, int k, int s, int d, int hb) {
  return (tile - 1) * s + (k - 1) * d + 2 * hb + 2;
}

}  // namespace

extern "C" {

// Shared memory one block of the given tiles needs (bytes), for elements
// of `elt` bytes.
long long ds_smem_bytes(int k, int s, int d, int hb, int th, int tw, int tc,
                        int elt) {
  return smem_bytes(extent(th, k, s, d, hb), extent(tw, k, s, d, hb),
                    th * tw * k * k, tc, elt);
}

// Check a plan and fill its derived fields.  Returns 0, or
// cudaErrorInvalidValue for tiles, sizes or vectors the kernel does not
// take (a banded plan's hp must be the Eq. 6 rows of th).
int ds_plan(DsPlan* g) {
  const int bad = (int)cudaErrorInvalidValue;
  if (g->n < 1 || g->n > 65535 || g->k < 1 || g->s < 1 || g->d < 1 ||
      g->hb < 0 || g->th < 1 || g->tw < 1 || g->tc < 1 || g->c % g->tc ||
      g->groups < 1 || g->groups > g->c / g->tc || g->groups > 65535 ||
      g->ho < 1 || g->wo < 1 || g->nt < 0)
    return bad;
  if (!(g->elt == 4 || g->elt == 2) || g->vec < g->elt || g->vec > 16 ||
      (g->vec & (g->vec - 1)) || (g->tc * g->elt) % g->vec)
    return bad;
  g->band_h = extent(g->th, g->k, g->s, g->d, g->hb);
  g->band_w = extent(g->tw, g->k, g->s, g->d, g->hb);
  if (g->nt && (g->hp != g->band_h || g->ho != g->nt * g->th)) return bad;
  g->h_tiles = g->nt ? g->nt : (g->ho + g->th - 1) / g->th;
  g->w_tiles = (g->wo + g->tw - 1) / g->tw;
  if (!g->nt && ((g->h_tiles - 1) * g->th * g->s + g->band_h > g->hp ||
                 (g->w_tiles - 1) * g->tw * g->s + g->band_w > g->wp))
    return bad;
  // 32-bit offsets: within a plane, and within an output tile's rows.
  const long long k2 = (long long)g->k * g->k;
  if ((long long)g->hp * g->wp * g->c >= (1LL << 31) ||
      (long long)g->th * g->wo * k2 * g->c >= (1LL << 31) ||
      (long long)g->h_tiles * g->w_tiles >= (1LL << 31))
    return bad;
  int lanes = g->tc * g->elt / g->vec, lg = 0;
  while ((1 << lg) < lanes) ++lg;
  g->lg_lanes = lg;
  const long long smem =
      smem_bytes(g->band_h, g->band_w, g->th * g->tw * (int)k2, g->tc,
                 g->elt);
  if (smem > kSmemMax) return bad;
  g->smem = (int)smem;
  return 0;
}

// Kernel 1b (plan nt == 0: x_pad (n, hp, wp, c) from plan.pad_zerocopy)
// or kernel 3 (nt > 0: bands (n, nt, hp = band_h, wp = w_pad, c) from
// plan.pad_and_band) on `stream` of `device` (made current for the launch
// where it is not): offsets (n, ho, wo, 2*k*k), out (n, ho, wo, k*k, c) in
// src's dtype.  `plan` must have passed ds_plan.  Returns a cudaError_t
// (0 on success).
int ds_launch(const void* src, const void* off, void* out,
              const DsPlan* plan, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err =
      plan->elt == 4
          ? launch_k<float>(src, off, out, *plan, device, st)
          : launch_k<__nv_bfloat16>(src, off, out, *plan, device, st);
  if (cur != device) cudaSetDevice(cur);
  return err;
}

const char* ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
