// Fused bounded deformable convolution on the int8 datapath, for sm_90a.
//
// Two entry points around one main body:
//   * dcq_forward replaces the TPU kernel of
//     repro/kernels/deform_conv_q.py deform_conv_fused_zerocopy_q (:74),
//     emitted by band_pipeline.forward_call (pallas_call at
//     band_pipeline.py:644) with an int8 band, int32 accumulation and the
//     per-M "dequant" epilogue (kernel 1c);
//   * dcc_forward replaces deform_conv_q.py deform_conv_fused_zerocopy_chain
//     (:108): the same emitter with the fused int8 offset-conv stage
//     (band_pipeline.offset_conv_stage, :398) and a "requant" epilogue that
//     emits int8 on the next layer's grid ("dequant" + bias for the fp32
//     chain tail) (kernel 1d).
//
// What they compute, per output pixel p and output channel m:
//   patch[p, tap, c] = round(bilinear(x_q[c], pos(p, tap)))        (int8)
//   acc[p, m]        = sum_{tap, c} patch[p, tap, c] * w_q[tap, c, m] (int32)
//   dcq: y = acc * scale[m]                                          (fp32)
//   dcc: y = acc * out_scale[m] + out_bias[m]; int8: clip(rint(y), +-127)
// with pos(p, tap) the band-local Eq. 6 position plus the tap's offset
// clamped to +-B.  dcq reads the fp32 offsets; dcc computes them first:
//   off[p, o] = (sum_{tap, c} x_q[undeformed tap] * woff_q[tap, c, o])
//               * off_scale[o] + off_bias[o]
//
// Arithmetic that matches the plain PyTorch versions bit for bit: every
// fp32 step before a rounding to int8 (positions, fractions, coefficients,
// corner products and sums, offset dequant, epilogues) is written with
// __fadd_rn / __fsub_rn / __fmul_rn, so nvcc cannot contract it into an
// FMA, in the order of repro/kernels/band_pipeline.py.  Two conversions
// take exact magic-number forms, since the conversion instructions run at
// a quarter of the fp32 rate: a band byte v becomes fp32 as
// float(0x4B000000 | (v ^ 0x80)) - (2^23 + 128) (one PRMT and one FADD),
// and a sample s (|s| <= 128) rounds to int8 as the low byte of
// float(s + 1.5 * 2^23), whose FADD rounds to nearest with ties to even,
// as torch.round.  The contractions are exact in int32 (|sum| <= 127^2 *
// K^2 * C < 2^31 for C <= 14,000), so any order and any C grouping gives
// the same bits.
//
// What bounds them on this card: latency, then the patch build.  The int8
// products run on the s8 tensor cores (mma.sync m16n8k32, 1,979 TOP/s
// dense); the bilinear samples are fp32 work on the CUDA cores that no
// tensor core can take, at least 4 products and 3 sums a sample,
// uncontracted.  At the ResNet-50-DCN shapes both are a few microseconds a
// call, below what staging the chunks and filling the card cost: the
// serving layers are small (a 256-bucket layer is 256-4,096 output
// pixels), so each launch is a short wave of blocks that each walk a few
// chunks.
//
// Design.
//   * One block of 8 warps per (image, output tile of up to 64 pixels, up
//     to 128 output channels, group of C chunks): the patch tile is built
//     once for 128 channels and shared by all 8 warps.  A warp takes 32
//     (16) pixels by 32 channels at 64 (32) pixel lanes, 16 by 16 at 16
//     lanes: two or one 16-row mma tiles by four or two 8-column ones.
//   * The grid counts pixel tiles x M tiles x C groups.  Where the first
//     two do not fill a wave of two blocks an SM, C is split into groups
//     (tiling.fwd_c_groups at Q_GROUP_LEAST); each group writes int32
//     partials into a workspace and dcq_reduce_kernel sums them and
//     applies the epilogue, which therefore always sees the full int32
//     sum.  With one group the main kernel runs the epilogue itself.
//   * Weights.  The s8 mma reads both operands k-contiguous and ldmatrix
//     has no 8-bit transpose, so dqt_kernel first copies the weights from
//     the TPU layout (C/tc_w, K*K*tc_w, M) into chunk-major
//     (C/tc, M, K*K*tc) in a workspace: a block's weight chunk is then one
//     contiguous run of bytes.
//   * Per chunk of tile_c channels (kStages in flight): the band chunk and
//     the weight chunk are copied with cp.async into a ring of buffers
//     (two: a third stage bought nothing on the card), 16-byte copies
//     where C and tile_c are multiples of 16 (the wrapper's `vec`), 4-byte
//     copies otherwise.  Chunk c+1 lands while chunk c is sampled and
//     multiplied: wait, barrier, issue c+1 into chunk c-1's buffers, build
//     the patch tile P from chunk c, barrier, products of chunk c.
//   * Layouts.  The band chunk is position-major with the channels
//     innermost (band[pos * tc + ch]); a thread builds one 4-channel word
//     of one (tap, pixel) from four corner words, neighbouring lanes
//     taking the next channels, then the next pixel.  P is
//     [pixel][K*K*tc padded to 32, + 16 bytes] and W is [channel][K*K*tc
//     padded to 32, + 16 bytes], k contiguous in both; the 16 bytes put
//     the eight rows of an ldmatrix phase on distinct banks.  Rows of
//     K*K*tc past a multiple of 32 are zero in both.
//   * The chain's offsets are computed before the main body, by
//     dco_kernel: the same staging and s8 products over the undeformed
//     taps (P is a plain copy of the band's words), 2*K*K <= 64 output
//     columns, its grid split into C groups (tiling.q_off_groups) whose
//     int32 sums meet in a workspace by atomics (integers: any order gives
//     the same).  The main body reads those sums and dequantizes them with
//     __fmul_rn / __fadd_rn as the TPU kernel's fused stage does.  This
//     gives up the TPU design's "no offsets in device memory" (int32 sums,
//     at most 1.2 MB at the model's shapes): offsets must be complete
//     before the first sample, and C groups would otherwise repeat the
//     offset conv in every group and M tile.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using wmma_sm90::cp_async16;
using wmma_sm90::cp_async4;
using wmma_sm90::cp_async_commit;
using wmma_sm90::cp_async_wait;
using wmma_sm90::ldmatrix_x4;
using wmma_sm90::mma_s8;

constexpr int kThreads = 256;     // threads of every block (8 warps)
constexpr int kStages = 2;        // chunks in flight (cp.async ring)
constexpr int kTileM = 128;       // output channels a block, at most
constexpr int kOffCols = 64;      // offset-conv columns: 2*K*K <= 64
constexpr int kRowPad = 16;       // bytes past each P and W row
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in ceiling
constexpr int kTile = 64;         // dqt_kernel's square tile

enum Epilogue { kDequant = 0, kAffineF32 = 1, kAffineI8 = 2 };

// n / d for 0 <= n < 2^31 by a multiply-high (Granlund-Montgomery).
struct FastDiv {
  uint32_t d, mul, shift;
};

inline FastDiv fast_div(uint32_t d) {
  if (d < 1) d = 1;
  uint32_t l = 0;
  while ((1u << l) < d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return FastDiv{d, (uint32_t)m, l};
}

__device__ __forceinline__ int quot(int n, const FastDiv& f) {
  return (int)((__umulhi((uint32_t)n, f.mul) + (uint32_t)n) >> f.shift);
}

struct Geometry {
  int n, hp, wp, c, ho, wo, m;
  int k, s, d, hb;
  float bound;
  int th, tw, tc, tm;
  int band_h, band_w, h_tiles, w_tiles;
  // Staging pieces (16 or 4 bytes): of a band position's tc channels, and
  // of a weight row's K*K*tc bytes; tc / 4 words of a position.
  FastDiv per, row_pieces, tc4;
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
// K*K*tc padded to whole 32-deep mma steps.
__host__ __device__ inline int kk_pad(const Geometry& g) {
  return round_up(kk_rows(g), 32);
}
// Bytes of a P or W row.
__host__ __device__ inline int row_bytes(const Geometry& g) {
  return kk_pad(g) + kRowPad;
}
__host__ __device__ inline int band_bytes(const Geometry& g) {
  return round_up(g.band_h * g.band_w * g.tc, 16);
}

// kStages band chunks, kStages weight chunks, the patch tile and the
// corner geometry (index, ty, tx per tap and pixel).
inline size_t smem_bytes(const Geometry& g, int pix) {
  return kStages * (size_t)band_bytes(g) +
         (kStages * (size_t)kTileM + pix) * row_bytes(g) +
         12 * (size_t)g.k * g.k * pix;
}

// Weight rows of the offset conv's chunks: 2*K*K padded to whole
// 16-column warp tiles, at most kOffCols.
__host__ __device__ inline int off_rows(const Geometry& g) {
  return round_up(2 * g.k * g.k, 16);
}

// The offset conv's block: kStages band chunks, kStages chunks of
// off_rows weight rows, the patch tile and the band position of every
// (tap, pixel).
inline size_t dco_smem_bytes(const Geometry& g, int pix) {
  return kStages * (size_t)band_bytes(g) +
         (kStages * (size_t)off_rows(g) + pix) * row_bytes(g) +
         4 * (size_t)g.k * g.k * pix;
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte b of a word whose bytes were XORed with 0x80, as fp32: the exact
// value of the original signed byte.
__device__ __forceinline__ float byte_f32(uint32_t biased, int b) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | b)),
      8388736.f);
}

// Four channels of one bilinear sample, rounded to int8 and packed: the
// corners in the order (00, 01, 10, 11), products and sums rounded one
// at a time (a convex mix of int8 values needs no clip).
__device__ __forceinline__ uint32_t sample4(uint32_t c00, uint32_t c01,
                                            uint32_t c10, uint32_t c11,
                                            float w00, float w01, float w10,
                                            float w11) {
  c00 ^= 0x80808080u;
  c01 ^= 0x80808080u;
  c10 ^= 0x80808080u;
  c11 ^= 0x80808080u;
  uint32_t r[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float v = __fmul_rn(byte_f32(c00, b), w00);
    v = __fadd_rn(v, __fmul_rn(byte_f32(c01, b), w01));
    v = __fadd_rn(v, __fmul_rn(byte_f32(c10, b), w10));
    v = __fadd_rn(v, __fmul_rn(byte_f32(c11, b), w11));
    r[b] = __float_as_uint(__fadd_rn(v, 12582912.f));  // low byte: rint(v)
  }
  return __byte_perm(__byte_perm(r[0], r[1], 0x0040u),
                     __byte_perm(r[2], r[3], 0x0040u), 0x5410u);
}

// A fragments of one 16-row mma tile at k step kb, from a [row][k] tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const unsigned char* t, int ld,
                                       int row0, int kb, int lane) {
  ldmatrix_x4(a, t + (row0 + (lane & 15)) * ld + kb + (lane >> 4) * 16);
}

// B fragments of two 8-column mma tiles (n0 and n0 + 8) at k step kb, from
// a [n][k] tile: b[0], b[1] of the first, b[2], b[3] of the second.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4],
                                        const unsigned char* t, int ld,
                                        int n0, int kb, int lane) {
  ldmatrix_x4(b, t + (n0 + ((lane >> 4) << 3) + (lane & 7)) * ld + kb +
                     ((lane >> 3) & 1) * 16);
}

template <int EPI>
__device__ __forceinline__ float epilogue(int acc, float scale, float bias) {
  const float y = __fmul_rn(__int2float_rn(acc), scale);
  return EPI == kDequant ? y : __fadd_rn(y, bias);
}

__device__ __forceinline__ int8_t requant(float y) {
  return (int8_t)(int)fminf(fmaxf(rintf(y), -127.f), 127.f);
}

template <int EPI>
__device__ __forceinline__ void store_out(void* out, size_t i, int acc,
                                          float scale, float bias) {
  const float y = epilogue<EPI>(acc, scale, bias);
  if (EPI == kAffineI8)
    static_cast<int8_t*>(out)[i] = requant(y);
  else
    static_cast<float*>(out)[i] = y;
}

// Outputs i and i + 1 (i even; output channels ch, ch + 1) in one store.
template <int EPI>
__device__ __forceinline__ void store_out2(void* out, size_t i, int a0,
                                           int a1, const float* scale,
                                           const float* bias, int ch) {
  const bool b = EPI != kDequant;
  const float y0 = epilogue<EPI>(a0, scale[ch], b ? bias[ch] : 0.f);
  const float y1 = epilogue<EPI>(a1, scale[ch + 1], b ? bias[ch + 1] : 0.f);
  if (EPI == kAffineI8) {
    char2 v;
    v.x = requant(y0);
    v.y = requant(y1);
    reinterpret_cast<char2*>(static_cast<int8_t*>(out) + i)[0] = v;
  } else {
    reinterpret_cast<float2*>(static_cast<float*>(out) + i)[0] =
        make_float2(y0, y1);
  }
}

// A block's output tile and its image's plane (the main body and the
// offset conv take the same tiles).
struct Tile {
  int n, jt, wt, row0, col0, npix;
  const int8_t* plane;
};

__device__ __forceinline__ Tile tile_of(const int8_t* x_pad,
                                        const Geometry& g) {
  Tile t;
  t.n = blockIdx.z;
  t.jt = blockIdx.x / g.w_tiles;
  t.wt = blockIdx.x % g.w_tiles;
  t.row0 = t.jt * g.th * g.s;
  t.col0 = t.wt * g.tw * g.s;
  t.npix = g.th * g.tw;
  t.plane = x_pad + (size_t)t.n * g.hp * g.wp * g.c;
  return t;
}

// Chunk cs of the band into `band` and of the chunk-major weights (rows
// r0 .. r0 + rows of chunk cs, each K*K*tc bytes, one run) into `w` rows
// of row_bytes: 16-byte pieces with `vec`, else 4-byte ones.
__device__ __forceinline__ void stage_chunk(unsigned char* band,
                                            unsigned char* w,
                                            const Tile& t,
                                            const int8_t* w_ck, int w_m,
                                            int r0, int rows, int cs,
                                            const Geometry& g, int vec) {
  const int tc = g.tc, kk_n = kk_rows(g), ld = row_bytes(g);
  const int piece = vec ? 16 : 4;
  const int c0 = cs * tc;
  const int band_n = g.band_h * g.band_w * g.per.d;
  for (int i = threadIdx.x; i < band_n; i += kThreads) {
    const int pos = quot(i, g.per), e = i - pos * g.per.d;
    const int r = pos / g.band_w, q = pos - r * g.band_w;
    const int8_t* s = t.plane +
                      ((size_t)(t.row0 + r) * g.wp + t.col0 + q) * g.c + c0 +
                      e * piece;
    if (vec)
      cp_async16(band + pos * tc + e * piece, s, 16);
    else
      cp_async4(band + pos * tc + e * piece, s, 4);
  }
  const int8_t* src = w_ck + ((size_t)cs * w_m + r0) * kk_n;
  const int w_n = rows * g.row_pieces.d;
  for (int i = threadIdx.x; i < w_n; i += kThreads) {
    const int r = quot(i, g.row_pieces), e = i - r * g.row_pieces.d;
    if (vec)
      cp_async16(w + r * ld + e * piece, src + (size_t)i * piece, 16);
    else
      cp_async4(w + r * ld + e * piece, src + (size_t)i * piece, 4);
  }
}

// Zero what no chunk writes: the pad columns (K*K*tc .. padded) of `rows`
// contiguous rows from `t` on (the weight buffers and the patch tile),
// and rows live .. all of the kStages weight buffers, `stride` bytes
// apart from `w` on.
__device__ __forceinline__ void zero_pads(unsigned char* t, int rows,
                                          unsigned char* w, int live,
                                          int all, int stride,
                                          const Geometry& g) {
  const int kk_n = kk_rows(g), ld = row_bytes(g);
  const int padw = (kk_pad(g) - kk_n) / 4, roww = kk_n / 4;
  for (int i = threadIdx.x; i < rows * padw; i += kThreads) {
    const int r = i / padw;
    reinterpret_cast<uint32_t*>(t + r * ld + kk_n)[i - r * padw] = 0;
  }
  const int dead = all - live;
  for (int i = threadIdx.x; i < kStages * dead * roww; i += kThreads) {
    const int r = i / roww, buf = r / dead;
    reinterpret_cast<uint32_t*>(w + buf * stride +
                                (live + r - buf * dead) * ld)[i - r * roww] =
        0;
  }
}

template <int PIX, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
dcq_kernel(const int8_t* __restrict__ x_pad, const float* __restrict__ off,
           const int* __restrict__ off_acc,
           const float* __restrict__ off_scale,
           const float* __restrict__ off_bias,
           const int8_t* __restrict__ w_ck, const float* __restrict__ scale,
           const float* __restrict__ bias, void* __restrict__ dst, Geometry g,
           int groups, int vec) {
  using L = Warps<PIX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k2 = g.k * g.k;
  const int tc = g.tc, tc4 = tc >> 2;
  const int kkp = kk_pad(g), ld = row_bytes(g);
  const int bb = band_bytes(g), wb = kTileM * ld;
  unsigned char* bands = smem;             // [kStages][bb]
  unsigned char* Ws = bands + kStages * bb;  // [kStages][kTileM][ld]
  unsigned char* P = Ws + kStages * wb;    // [PIX][ld]
  int* gidx = reinterpret_cast<int*>(P + PIX * ld);  // [k2][PIX]
  float* gty = reinterpret_cast<float*>(gidx + k2 * PIX);
  float* gtx = gty + k2 * PIX;

  const Tile t = tile_of(x_pad, g);
  const int m_tiles = (g.m + g.tm - 1) / g.tm;
  const int grp = blockIdx.y / m_tiles;
  const int m0 = (blockIdx.y % m_tiles) * g.tm;
  const int m_live = min(g.tm, g.m - m0);  // channels of this block
  const int chunks = g.c / tc;
  const int cs0 = grp * chunks / groups, cs1 = (grp + 1) * chunks / groups;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_off = 2 * k2;

  for (int st = 0; st < kStages - 1; ++st) {
    if (cs0 + st < cs1)
      stage_chunk(bands + st * bb, Ws + st * wb, t, w_ck, g.m, m0, m_live,
                  cs0 + st, g, vec);
    cp_async_commit();
  }

  // Corner geometry of every (tap, pixel), band-local, with the position
  // and fraction expressions of band_pipeline.corner_geometry; the chain's
  // offsets are its offset conv's int32 sums, dequantized here.
  for (int i = tid; i < k2 * PIX; i += kThreads) {
    const int kt = i / PIX, p = i % PIX;
    int idx = 0;
    float fy = 0.f, fx = 0.f;
    if (p < t.npix) {
      const int u = p % g.tw, v = p / g.tw;
      const int oy = t.jt * g.th + v, ox = t.wt * g.tw + u;
      float dy = 0.f, dx = 0.f;
      if (oy < g.ho && ox < g.wo) {
        const size_t o =
            (((size_t)t.n * g.ho + oy) * g.wo + ox) * n_off + 2 * kt;
        if (off_acc) {
          dy = __fadd_rn(__fmul_rn(__int2float_rn(off_acc[o]),
                                   off_scale[2 * kt]),
                         off_bias[2 * kt]);
          dx = __fadd_rn(__fmul_rn(__int2float_rn(off_acc[o + 1]),
                                   off_scale[2 * kt + 1]),
                         off_bias[2 * kt + 1]);
        } else {
          dy = off[o];
          dx = off[o + 1];
        }
      }
      dy = fminf(fmaxf(dy, -g.bound), g.bound);
      dx = fminf(fmaxf(dx, -g.bound), g.bound);
      const float py =
          __fadd_rn((float)(v * g.s + g.hb + (kt / g.k) * g.d), dy);
      const float px =
          __fadd_rn((float)(u * g.s + g.hb + (kt % g.k) * g.d), dx);
      const float y0 = floorf(py), x0 = floorf(px);
      fy = __fsub_rn(py, y0);
      fx = __fsub_rn(px, x0);
      idx = (int)y0 * g.band_w + (int)x0;
    }
    gidx[i] = idx;
    gty[i] = fy;
    gtx[i] = fx;
  }
  zero_pads(Ws, kStages * kTileM + PIX, Ws, m_live, kTileM, wb, g);

  // This warp's share of the output tile.
  const int prow = (warp / L::kN) * (PIX / L::kP);
  const int ncol = (warp % L::kN) * (kTileM / L::kN);
  int acc[L::kMT][L::kNT][4];
#pragma unroll
  for (int i = 0; i < L::kMT; ++i)
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // The patch words this thread builds: (tap * PIX + pixel, channel word)
  // from tid on, kThreads at a time, stepped without a division.
  const int step_pr = kThreads / tc4, step_q = kThreads - step_pr * tc4;
  const int first_pr = quot(tid, g.tc4), first_q = tid - first_pr * tc4;
  const int rowb = g.band_w * tc;  // a band row, in bytes

  for (int cs = cs0, b = 0; cs < cs1; ++cs, b = b + 1 < kStages ? b + 1 : 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk cs landed; chunk cs - 1's products are done
    const int nb = b > 0 ? b - 1 : kStages - 1;  // chunk cs - 1's buffer
    if (cs + kStages - 1 < cs1)
      stage_chunk(bands + nb * bb, Ws + nb * wb, t, w_ck, g.m, m0, m_live,
                  cs + kStages - 1, g, vec);
    cp_async_commit();
    // Patch tile P[pixel][tap * tc + ch].
    const unsigned char* band = bands + b * bb;
    for (int pr = first_pr, q = first_q; pr < k2 * PIX;) {
      const int kt = pr / PIX, p = pr % PIX;
      uint32_t word = 0;
      if (p < t.npix) {
        const float ty = gty[pr], tx = gtx[pr];
        const float uy = __fsub_rn(1.f, ty), ux = __fsub_rn(1.f, tx);
        const unsigned char* bp = band + gidx[pr] * tc + 4 * q;
        word = sample4(ld32(bp), ld32(bp + tc), ld32(bp + rowb),
                       ld32(bp + rowb + tc), __fmul_rn(uy, ux),
                       __fmul_rn(uy, tx), __fmul_rn(ty, ux),
                       __fmul_rn(ty, tx));
      }
      *reinterpret_cast<uint32_t*>(P + p * ld + kt * tc + 4 * q) = word;
      pr += step_pr;
      q += step_q;
      if (q >= tc4) {
        q -= tc4;
        ++pr;
      }
    }
    __syncthreads();  // P is built
    // acc += P W on the s8 tensor cores: A = P (16 pixels x 32 k), B = W
    // (32 k x 8 channels).
    const unsigned char* Wb = Ws + b * wb;
    for (int kb = 0; kb < kkp; kb += 32) {
      uint32_t a[L::kMT][4];
#pragma unroll
      for (int i = 0; i < L::kMT; ++i)
        load_a(a[i], P, ld, prow + i * 16, kb, lane);
#pragma unroll
      for (int j = 0; j < L::kNT; j += 2) {
        uint32_t bf[4];
        load_b2(bf, Wb, ld, ncol + j * 8, kb, lane);
#pragma unroll
        for (int i = 0; i < L::kMT; ++i) {
          mma_s8(acc[i][j], a[i], bf[0], bf[1]);
          mma_s8(acc[i][j + 1], a[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Flush, masking the ragged edge of the image and of M: the epilogue
  // (one C group) or this group's int32 partial, a thread's two
  // neighbouring channels in one store where M and m0 are even.
  const size_t count = (size_t)g.n * g.ho * g.wo * g.m;
  const bool pairs = g.m % 2 == 0 && m0 % 2 == 0;
#pragma unroll
  for (int i = 0; i < L::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = prow + i * 16 + gid + h * 8;
      const int oy = t.jt * g.th + p / g.tw, ox = t.wt * g.tw + p % g.tw;
      if (p >= t.npix || oy >= g.ho || ox >= g.wo) continue;
      const size_t base = (((size_t)t.n * g.ho + oy) * g.wo + ox) * g.m + m0;
#pragma unroll
      for (int j = 0; j < L::kNT; ++j) {
        const int ch = ncol + j * 8 + 2 * tig;
        const int a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
        if (pairs && ch + 1 < m_live) {
          if (groups > 1)
            reinterpret_cast<int2*>(static_cast<int*>(dst) + grp * count +
                                    base + ch)[0] = make_int2(a0, a1);
          else
            store_out2<EPI>(dst, base + ch, a0, a1, scale, bias, m0 + ch);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (ch + e >= m_live) continue;
          if (groups > 1)
            static_cast<int*>(dst)[grp * count + base + ch + e] = e ? a1 : a0;
          else
            store_out<EPI>(dst, base + ch + e, e ? a1 : a0,
                           scale[m0 + ch + e],
                           EPI == kDequant ? 0.f : bias[m0 + ch + e]);
        }
      }
    }
}

// out[i] = the epilogue of the C groups' int32 partials summed.
template <int EPI>
__global__ void dcq_reduce_kernel(const int* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ bias,
                                  void* __restrict__ out, long long count,
                                  int m, int groups) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    int a = 0;
    for (int s = 0; s < groups; ++s) a += partial[s * count + i];
    const int ch = (int)(i % m);
    store_out<EPI>(out, i, a, scale[ch], EPI == kDequant ? 0.f : bias[ch]);
  }
}

// The chain's offset conv, its int32 sums over the undeformed taps:
// off_acc[p, o] (+)= sum_{tap, c} x_q[tap of p, c] * woff_q[tap, c, o],
// one block per (image, output tile, group of C chunks) with the main
// body's tiles and staging; P is a plain copy of the band's words at the
// undeformed taps.  A warp takes 16 of the kOffCols columns (2*K*K live)
// for every other 16-pixel mma tile.  With one group each sum is stored,
// else added with an atomic into the zeroed sums (integer sums: any order
// gives the same).
template <int PIX>
__global__ void __launch_bounds__(kThreads)
dco_kernel(const int8_t* __restrict__ x_pad,
           const int8_t* __restrict__ woff_ck, int* __restrict__ off_acc,
           Geometry g, int groups, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k2 = g.k * g.k, n_off = 2 * k2;
  const int tc = g.tc, tc4 = tc >> 2;
  const int kkp = kk_pad(g), ld = row_bytes(g);
  const int rows = off_rows(g);
  const int bb = band_bytes(g), wb = rows * ld;
  unsigned char* bands = smem;                // [kStages][bb]
  unsigned char* Ws = bands + kStages * bb;  // [kStages][rows][ld]
  unsigned char* P = Ws + kStages * wb;    // [PIX][ld]

  const Tile t = tile_of(x_pad, g);
  const int grp = blockIdx.y;
  const int chunks = g.c / tc;
  const int cs0 = grp * chunks / groups, cs1 = (grp + 1) * chunks / groups;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // Pixel tiles warp / 4 and warp / 4 + 2, columns 16 * (warp % 4) ...
  const int mt = warp >> 2, np = warp & 3;
  const bool active = np * 16 < rows;
  constexpr int kMT = PIX / 16 > 2 ? 2 : 1;

  int* gpos = reinterpret_cast<int*>(P + PIX * ld);  // [k2][PIX]

  for (int st = 0; st < kStages - 1; ++st) {
    if (cs0 + st < cs1)
      stage_chunk(bands + st * bb, Ws + st * wb, t, woff_ck, n_off, 0, n_off,
                  cs0 + st, g, vec);
    cp_async_commit();
  }
  // The band position of every undeformed (tap, pixel).
  for (int i = tid; i < k2 * PIX; i += kThreads) {
    const int kt = i / PIX, p = i % PIX;
    gpos[i] = ((p / g.tw) * g.s + g.hb + (kt / g.k) * g.d) * g.band_w +
              (p % g.tw) * g.s + g.hb + (kt % g.k) * g.d;
  }
  zero_pads(Ws, kStages * rows + PIX, Ws, n_off, rows, wb, g);
  const int step_pr = kThreads / tc4, step_q = kThreads - step_pr * tc4;
  const int first_pr = quot(tid, g.tc4), first_q = tid - first_pr * tc4;
  int acc[kMT][2][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][0][e] = acc[i][1][e] = 0;
  for (int cs = cs0, b = 0; cs < cs1;
       ++cs, b = b + 1 < kStages ? b + 1 : 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nb = b > 0 ? b - 1 : kStages - 1;
    if (cs + kStages - 1 < cs1)
      stage_chunk(bands + nb * bb, Ws + nb * wb, t, woff_ck, n_off, 0, n_off,
                  cs + kStages - 1, g, vec);
    cp_async_commit();
    const unsigned char* band = bands + b * bb;
    for (int pr = first_pr, q = first_q; pr < k2 * PIX;) {
      const int kt = pr / PIX, p = pr % PIX;
      *reinterpret_cast<uint32_t*>(P + p * ld + kt * tc + 4 * q) =
          p < t.npix ? ld32(band + gpos[pr] * tc + 4 * q) : 0u;
      pr += step_pr;
      q += step_q;
      if (q >= tc4) {
        q -= tc4;
        ++pr;
      }
    }
    __syncthreads();
    if (active && mt < PIX / 16) {
      const unsigned char* Wb = Ws + b * wb;
      for (int kb = 0; kb < kkp; kb += 32) {
        uint32_t bf[4];
        load_b2(bf, Wb, ld, np * 16, kb, lane);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          uint32_t a[4];
          load_a(a, P, ld, (mt + 2 * i) * 16, kb, lane);
          mma_s8(acc[i][0], a, bf[0], bf[1]);
          mma_s8(acc[i][1], a, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active || mt >= PIX / 16) return;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (mt + 2 * i) * 16 + gid + h * 8;
      const int oy = t.jt * g.th + p / g.tw, ox = t.wt * g.tw + p % g.tw;
      if (p >= t.npix || oy >= g.ho || ox >= g.wo) continue;
      int* row = off_acc + (((size_t)t.n * g.ho + oy) * g.wo + ox) * n_off;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = np * 16 + j * 8 + 2 * tig + e;
          if (o >= n_off) continue;
          if (groups > 1)
            atomicAdd(row + o, acc[i][j][2 * h + e]);
          else
            row[o] = acc[i][j][2 * h + e];
        }
    }
}

// One weight tensor to lay out chunk-major (dqt_kernel).
struct Mat {
  const int8_t* src;
  int8_t* dst;
  int m;
};

// Weights from the TPU layout src (C/tcw, K*K*tcw, M) to chunk-major dst
// (C/tc, M, K*K*tc): dst[cs][m][kt*tc + ch] = src row kt*tcw + c % tcw of
// block c / tcw, column m, with c = cs*tc + ch; blockIdx.z runs over the
// chunks of `a`, then of `b` (the chain's two tensors in one launch).  A
// block takes a kTile x kTile tile (rows of a chunk by M); a thread reads
// 4 rows x 4 columns (word loads where M % 4 == 0), transposes them in
// registers and leaves 4 words of 4 rows each in shared memory, from
// where the block writes whole dst rows.
__global__ void __launch_bounds__(kThreads)
dqt_kernel(Mat a, Mat b, int chunks, int k2, int tc, int tcw) {
  __shared__ uint32_t tile[kTile][kTile / 4 + 1];  // [column][row word]
  const Mat mat = (int)blockIdx.z < chunks ? a : b;
  const int cs = blockIdx.z % chunks, rows = k2 * tc, m = mat.m;
  const int r0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  if (m0 >= m) return;
  const int mq = threadIdx.x & 15, kq = threadIdx.x >> 4;
  const int col = m0 + 4 * mq;
  const bool words = m % 4 == 0;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = r0 + 4 * kq + j;
    w[j] = 0;
    if (row >= rows) continue;
    const int kt = row / tc, cc = cs * tc + row % tc;
    const int8_t* s = mat.src +
                      ((size_t)(cc / tcw) * k2 * tcw + kt * tcw + cc % tcw) *
                          m + col;
    if (words) {
      if (col < m) w[j] = *reinterpret_cast<const uint32_t*>(s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < m) w[j] |= (uint32_t)(uint8_t)s[e] << (8 * e);
    }
  }
  // Column e of the 4 x 4 bytes: rows 4 kq .. 4 kq + 3 of column col + e.
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140u);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140u);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362u);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362u);
  tile[4 * mq][kq] = __byte_perm(lo01, lo23, 0x5410u);
  tile[4 * mq + 1][kq] = __byte_perm(lo01, lo23, 0x7632u);
  tile[4 * mq + 2][kq] = __byte_perm(hi01, hi23, 0x5410u);
  tile[4 * mq + 3][kq] = __byte_perm(hi01, hi23, 0x7632u);
  __syncthreads();
  const int cm = threadIdx.x >> 2;
  if (m0 + cm >= m) return;
  uint32_t* drow = reinterpret_cast<uint32_t*>(
      mat.dst + ((size_t)cs * m + m0 + cm) * rows + r0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = 4 * (threadIdx.x & 3) + e;
    if (r0 + 4 * q < rows) drow[q] = tile[cm][q];
  }
}

// One warp: d (16 x 16, s32) = a (16 x 32, row-major) . b (16 x 32,
// n-major)^T through shared memory, ldmatrix and mma_s8, with the main
// kernel's fragment loads and row stride.
__global__ void mma_s8_check_kernel(const int8_t* __restrict__ a,
                                    const int8_t* __restrict__ b,
                                    int* __restrict__ d) {
  constexpr int ld = 32 + kRowPad;
  __shared__ __align__(16) unsigned char sa[16 * ld];
  __shared__ __align__(16) unsigned char sb[16 * ld];
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  for (int i = lane; i < 16 * 32; i += 32) {
    sa[(i / 32) * ld + i % 32] = (unsigned char)a[i];
    sb[(i / 32) * ld + i % 32] = (unsigned char)b[i];
  }
  __syncwarp();
  uint32_t af[4], bf[4];
  load_a(af, sa, ld, 0, 0, lane);
  load_b2(bf, sb, ld, 0, 0, lane);
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  mma_s8(acc[0], af, bf[0], bf[1]);
  mma_s8(acc[1], af, bf[2], bf[3]);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(gid + (e >> 1) * 8) * 16 + 8 * j + 2 * tig + (e & 1)] = acc[j][e];
}

inline int grid_1d(long long count) {
  const long long blocks = (count + 255) / 256;
  return (int)(blocks < 1024 ? (blocks < 1 ? 1 : blocks) : 1024);
}

template <typename Kernel>
int allow(Kernel* kernel, unsigned long long* done) {
  return wmma_sm90::allow_smem(kernel, kMaxSmem, done);
}

// The chunk-major copies of one or two weight tensors (dqt_kernel), whose
// TPU layout is blocked at tcw channels.
cudaError_t to_chunk_major(Mat a, Mat b, const Geometry& g, int tcw,
                           cudaStream_t st) {
  const int k2 = g.k * g.k, chunks = g.c / g.tc;
  const int m = a.m > b.m ? a.m : b.m;
  const dim3 grid((k2 * g.tc + kTile - 1) / kTile, (m + kTile - 1) / kTile,
                  chunks * (b.m > 0 ? 2 : 1));
  dqt_kernel<<<grid, kThreads, 0, st>>>(a, b, chunks, k2, g.tc, tcw);
  return cudaGetLastError();
}

template <int PIX, int EPI>
cudaError_t launch(const int8_t* x_pad, const float* off, const int* off_acc,
                   const float* off_scale, const float* off_bias,
                   const int8_t* w_ck, const float* scale, const float* bias,
                   void* out, int* partial, const Geometry& g, int groups,
                   int vec, cudaStream_t stream) {
  static unsigned long long done = 0;
  if (int e = allow(dcq_kernel<PIX, EPI>, &done)) return (cudaError_t)e;
  const int m_tiles = (g.m + g.tm - 1) / g.tm;
  const dim3 grid(g.h_tiles * g.w_tiles, m_tiles * groups, g.n);
  dcq_kernel<PIX, EPI><<<grid, kThreads, smem_bytes(g, PIX), stream>>>(
      x_pad, off, off_acc, off_scale, off_bias, w_ck, scale, bias,
      groups > 1 ? (void*)partial : out, g, groups, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const long long count = (long long)g.n * g.ho * g.wo * g.m;
  dcq_reduce_kernel<EPI><<<grid_1d(count), 256, 0, stream>>>(
      partial, scale, bias, out, count, g.m, groups);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t dispatch(int pix, const int8_t* x_pad, const float* off,
                     const int* off_acc, const float* off_scale,
                     const float* off_bias, const int8_t* w_ck,
                     const float* scale, const float* bias, void* out,
                     int* partial, const Geometry& g, int groups, int vec,
                     cudaStream_t st) {
  if (pix == 16)
    return launch<16, EPI>(x_pad, off, off_acc, off_scale, off_bias, w_ck,
                           scale, bias, out, partial, g, groups, vec, st);
  if (pix == 32)
    return launch<32, EPI>(x_pad, off, off_acc, off_scale, off_bias, w_ck,
                           scale, bias, out, partial, g, groups, vec, st);
  return launch<64, EPI>(x_pad, off, off_acc, off_scale, off_bias, w_ck,
                         scale, bias, out, partial, g, groups, vec, st);
}

template <int PIX>
cudaError_t launch_dco(const int8_t* x_pad, const int8_t* woff_ck,
                       int* off_acc, const Geometry& g, int groups, int vec,
                       cudaStream_t st) {
  static unsigned long long done = 0;
  if (int e = allow(dco_kernel<PIX>, &done)) return (cudaError_t)e;
  if (groups > 1) {
    const cudaError_t e = cudaMemsetAsync(
        off_acc, 0, sizeof(int) * (size_t)g.n * g.ho * g.wo * 2 * g.k * g.k,
        st);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g.h_tiles * g.w_tiles, groups, g.n);
  dco_kernel<PIX><<<grid, kThreads, dco_smem_bytes(g, PIX), st>>>(
      x_pad, woff_ck, off_acc, g, groups, vec);
  return cudaGetLastError();
}

int pix_lanes(int th, int tw) {
  const int npix = th * tw;
  return npix <= 16 ? 16 : npix <= 32 ? 32 : npix <= 64 ? 64 : 0;
}

Geometry make_geometry(int n, int hp, int wp, int c, int ho, int wo, int m,
                       int k, int s, int d, float bound, int hb, int th,
                       int tw, int tc, int tm, int vec) {
  Geometry g;
  g.n = n; g.hp = hp; g.wp = wp; g.c = c; g.ho = ho; g.wo = wo; g.m = m;
  g.k = k; g.s = s; g.d = d; g.hb = hb; g.bound = bound;
  g.th = th; g.tw = tw; g.tc = tc; g.tm = tm;
  g.band_h = (th - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.band_w = (tw - 1) * s + (k - 1) * d + 2 * hb + 2;
  g.h_tiles = th > 0 ? (ho + th - 1) / th : 0;
  g.w_tiles = tw > 0 ? (wo + tw - 1) / tw : 0;
  const int piece = vec ? 16 : 4;
  g.per = fast_div(tc / piece);
  g.row_pieces = fast_div(k * k * tc / piece);
  g.tc4 = fast_div(tc / 4);
  return g;
}

// Tiles and sizes the kernels refuse, before any launch.
bool invalid(const Geometry& g, int pix, int groups, const void* partial,
             int vec, const void* x_pad, const void* w_ck) {
  return pix == 0 || g.n < 1 || g.k < 1 || g.tm < 1 || g.tm > kTileM ||
         g.tc < 4 || g.tc % 4 != 0 || g.c % g.tc != 0 || groups < 1 ||
         groups > g.c / g.tc || (groups > 1 && partial == nullptr) ||
         w_ck == nullptr || smem_bytes(g, pix) > kMaxSmem ||
         (vec && (g.tc % 16 != 0 || g.c % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(x_pad) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(w_ck) % 16 != 0));
}

}  // namespace

extern "C" {

// Shared memory one block of the given tiles needs (bytes); 0 for tiles
// the kernels refuse (more than 64 pixels, tile_c not a positive multiple
// of 4).  Both entry points run the same main body.
long long dcq_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                         int tc) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 4 || tc % 4 != 0) return 0;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw,
                             tc, 0, 0);
  return (long long)smem_bytes(g, pix);
}

// Blocks of the given tiles that fit one SM of the current device at once
// (registers, threads and shared memory), or a negative cudaError_t.
int dcq_blocks_per_sm(int k, int s, int d, int hb, int th, int tw, int tc) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 4 || tc % 4 != 0) return -(int)cudaErrorInvalidValue;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw,
                             tc, 0, 0);
  const size_t smem = smem_bytes(g, pix);
  static unsigned long long done[3] = {0, 0, 0};
  int blocks = 0, e;
  cudaError_t err;
  if (pix == 16) {
    e = allow(dcq_kernel<16, kAffineI8>, &done[0]);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dcq_kernel<16, kAffineI8>, kThreads, smem);
  } else if (pix == 32) {
    e = allow(dcq_kernel<32, kAffineI8>, &done[1]);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dcq_kernel<32, kAffineI8>, kThreads, smem);
  } else {
    e = allow(dcq_kernel<64, kAffineI8>, &done[2]);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dcq_kernel<64, kAffineI8>, kThreads, smem);
  }
  if (e) return -e;
  return err == cudaSuccess ? blocks : -(int)err;
}

// int8 fused forward with the per-M dequant epilogue (kernel 1c), on
// `stream`: x_pad (n, hp, wp, c) int8, off (n, ho, wo, 2*k*k) fp32,
// w_tiles (c / tc, k*k*tc, m) int8 (plan.tile_weights at tc), scale (m,),
// out (n, ho, wo, m) fp32.  Workspaces: w_ck, c*k*k*m bytes (the weights
// chunk-major); with groups > 1 (C groups of the grid, 1 .. c / tc),
// partial, groups x n*ho*wo*m int32, summed into out by a second kernel.
// vec: 16-byte staging (tc % 16 == c % 16 == 0, x_pad and w_ck 16-byte
// aligned), else 4-byte.  Returns a cudaError_t (0 on success); invalid
// arguments return cudaErrorInvalidValue before any launch.
int dcq_forward(const void* x_pad, const float* off, const void* w_tiles,
                const float* scale, float* out, void* w_ck, int* partial,
                int n, int hp, int wp, int c, int ho, int wo, int m, int k,
                int s, int d, float bound, int hb, int th, int tw, int tc,
                int tm, int groups, int vec, void* stream) {
  const int pix = pix_lanes(th, tw);
  Geometry g = make_geometry(n, hp, wp, c, ho, wo, m, k, s, d, bound, hb, th,
                             tw, tc, tm, vec);
  if (invalid(g, pix, groups, partial, vec, x_pad, w_ck))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* wc = static_cast<int8_t*>(w_ck);
  cudaError_t e = to_chunk_major(
      Mat{static_cast<const int8_t*>(w_tiles), wc, m}, Mat{nullptr, nullptr, 0},
      g, tc, st);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch<kDequant>(
      pix, static_cast<const int8_t*>(x_pad), off, nullptr, nullptr, nullptr,
      wc, scale, nullptr, out, partial, g, groups, vec, st);
}

// int8 chain forward (kernel 1d): the offset conv's int32 sums, split
// into off_groups C groups (1 .. c / tc), into off_acc (n, ho, wo, 2*k*k),
// then the main body with the requant
// (emit_int8 = 1, int8 output) or dequant + bias (emit_int8 = 0, fp32
// output) epilogue.  w_tiles (1, k*k*c, m) and woff_tiles (1, k*k*c,
// 2*k*k) int8 in the TPU plan's layout, 2*k*k <= 64; workspaces w_ck
// (c*k*k*m bytes) and woff_ck (c*k*k*2*k*k bytes, 16-byte aligned); the
// rest as dcq_forward.
int dcc_forward(const void* x_pad, const void* w_tiles,
                const void* woff_tiles, const float* off_scale,
                const float* off_bias, const float* out_scale,
                const float* out_bias, void* out, void* w_ck, void* woff_ck,
                int* off_acc, int* partial, int emit_int8, int n, int hp,
                int wp, int c, int ho, int wo, int m, int k, int s, int d,
                float bound, int hb, int th, int tw, int tc, int tm,
                int groups, int off_groups, int vec, void* stream) {
  const int pix = pix_lanes(th, tw);
  Geometry g = make_geometry(n, hp, wp, c, ho, wo, m, k, s, d, bound, hb, th,
                             tw, tc, tm, vec);
  if (invalid(g, pix, groups, partial, vec, x_pad, w_ck) ||
      invalid(g, pix, groups, partial, vec, x_pad, woff_ck) ||
      2 * k * k > kOffCols || off_acc == nullptr || off_groups < 1 ||
      off_groups > c / tc || dco_smem_bytes(g, pix) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x_pad);
  int8_t* wc = static_cast<int8_t*>(w_ck);
  int8_t* woc = static_cast<int8_t*>(woff_ck);
  cudaError_t e = to_chunk_major(
      Mat{static_cast<const int8_t*>(w_tiles), wc, m},
      Mat{static_cast<const int8_t*>(woff_tiles), woc, 2 * k * k}, g, c, st);
  if (e == cudaSuccess)
    e = pix == 16   ? launch_dco<16>(xp, woc, off_acc, g, off_groups, vec, st)
        : pix == 32 ? launch_dco<32>(xp, woc, off_acc, g, off_groups, vec, st)
                    : launch_dco<64>(xp, woc, off_acc, g, off_groups, vec, st);
  if (e != cudaSuccess) return (int)e;
  if (emit_int8)
    return (int)dispatch<kAffineI8>(pix, xp, nullptr, off_acc, off_scale,
                                    off_bias, wc, out_scale, out_bias, out,
                                    partial, g, groups, vec, st);
  return (int)dispatch<kAffineF32>(pix, xp, nullptr, off_acc, off_scale,
                                   off_bias, wc, out_scale, out_bias, out,
                                   partial, g, groups, vec, st);
}

// d (16 x 16 int32) = a (16 x 32 int8, row-major) . b (16 x 32 int8)^T on
// one warp through mma_s8 and the main kernel's ldmatrix fragment loads,
// on the default stream, synchronised: the card test of the s8 fragment
// layout.
int dcq_mma_s8_check(const void* a, const void* b, int* d) {
  mma_s8_check_kernel<<<1, 32>>>(static_cast<const int8_t*>(a),
                                 static_cast<const int8_t*>(b), d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

const char* dcq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
