// Fused backward of the bounded deformable convolution, fp32, for sm_90a.
//
// Replaces the TPU kernel of repro/kernels/deform_conv_bwd.py
// deform_conv_bwd_zerocopy (:241; pallas_call at :304, body
// _bwd_zerocopy_kernel at :88).
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
// each (dw and dP), about twice the forward's, against moving x, the
// offsets, g, the weights and the three outputs once.
//
// Design.  The TPU kernel walks a sequential grid and carries two sums
// across it: d_input through read-modify-writes of overlapping bands and
// d_weights in a scratch accumulator.  CUDA blocks run concurrently, so
// the two reductions are split into kernels of their own:
//   * dcb_input_kernel, one block of 256 threads per (image, tile_h x
//     tile_w output pixels), the C axis a loop inside the block: per
//     tile_c chunk it stages the band, builds dP = g * W^T streaming M in
//     steps of 16 (a full K*K*tile_c x M weight block does not fit: 295 KB
//     at tile_c = 16 and M = 512), each thread holding its (at most
//     three) 4 x 4 tiles of dP in registers over all of M; then one thread
//     per (channel, tap, pixel) adds its share of d_off and scatters the
//     four weighted corners into a shared-memory band accumulator (shared
//     atomics: taps of one block hit the same corners).  The accumulator
//     is added to the zeroed dx_pad with global fp32 atomics, because
//     neighbouring tiles overlap in their Eq. 6 halos.  d_off is complete
//     per block (it sums over C, which the block owns), masked once at
//     the end.
//   * dcb_weight_kernel, one block per (C chunk, up to five 64-row blocks
//     of K*K*tile_c, 64 output channels, pixel split): it walks its share
//     of the output tiles, stages each tile's band and g once, recomputes
//     its rows of P from the band and accumulates P^T g in registers (4 x
//     4 a thread per row block).  With more than one split the partials
//     go to a scratch buffer that dcb_reduce_kernel sums in a fixed order.
// Every copy into shared memory is asynchronous (cp.async), so a block's
// loads are in flight together.  d_weights is deterministic; d_input and
// d_offsets are not bit for bit (fp32 atomics add in a run-dependent
// order), within 1e-4 relative of the plain version.  CUDA-core FMAs, no
// TF32; tensor cores, TMA and double buffering are later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256; // threads of every block
constexpr int kRows = 64;     // rows of K*K*tile_c per d_weights row block
constexpr int kMaxRowBlocks = 5;  // row blocks per d_weights block
constexpr int kMC = 16;       // output channels of g and W per dP step
constexpr int kQuadsPerThread = 3;  // dP register tiles a thread keeps
constexpr int kTM = 64;       // output channels per d_weights block

struct Geometry {
  int n, hp, wp, c, ho, wo, m;
  int k, s, d, hb;
  float bound;
  int th, tw, tc;
  int band_h, band_w, h_tiles, w_tiles;
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int plane_of(const Geometry& g) {
  return (g.band_h * g.band_w) | 1;
}
__host__ __device__ inline int band_floats(const Geometry& g) {
  return round4(g.tc * plane_of(g));
}
__host__ __device__ inline int kk_rows(const Geometry& g) {
  return g.k * g.k * g.tc;
}
// Rows of the dP chunk, padded to whole 4-row register tiles.
__host__ __device__ inline int kk_pad(const Geometry& g) {
  return round4(kk_rows(g));
}

// dcb_input_kernel: band, d_input band accumulator, dP chunk, W^T and
// g^T steps, then geometry (ty, tx, index) and the d_off accumulator.
inline size_t input_smem_bytes(const Geometry& g, int pix) {
  const size_t k2 = (size_t)g.k * g.k;
  return 4 * (2 * (size_t)band_floats(g) + (size_t)kk_pad(g) * pix +
              (size_t)kMC * (kk_pad(g) + 4) + (size_t)kMC * (pix + 4) +
              5 * k2 * pix);
}

// d_weights: 64-row blocks of K*K*tile_c, and how many one block takes.
__host__ __device__ inline int row_blocks(const Geometry& g) {
  return (kk_rows(g) + kRows - 1) / kRows;
}
__host__ __device__ inline int rows_per_block(const Geometry& g) {
  return row_blocks(g) < kMaxRowBlocks ? row_blocks(g) : kMaxRowBlocks;
}

// dcb_weight_kernel: band, P rows of its row blocks, g tile, geometry.
inline size_t weight_smem_bytes(const Geometry& g, int pix) {
  const size_t k2 = (size_t)g.k * g.k;
  return 4 * ((size_t)band_floats(g) +
              (size_t)rows_per_block(g) * pix * kRows + (size_t)pix * kTM +
              3 * k2 * pix);
}

// Band-local corner geometry of every (tap, pixel) of tile (jt, wt), as
// deform_conv_fused.cu computes it.  Returns nothing; fills gidx/gty/gtx.
__device__ inline void tile_geometry(const float* __restrict__ off,
                                     const Geometry& g, int n, int jt,
                                     int wt, int pix, int tid, int threads,
                                     int* gidx, float* gty, float* gtx) {
  const int k2 = g.k * g.k;
  const int npix = g.th * g.tw;
  for (int i = tid; i < k2 * pix; i += threads) {
    const int kt = i / pix, p = i % pix;
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

// Copy one float from device to shared memory asynchronously (cp.async),
// or store 0 when `valid` is false.  The copies land after
// __pipeline_commit(); __pipeline_wait_prior(0); and a barrier.
__device__ inline void stage(float* dst, const float* src, bool valid) {
  if (valid)
    __pipeline_memcpy_async(dst, src, sizeof(float));
  else
    *dst = 0.f;
}

// Stage channels [c0, c0 + tc) of the band of tile (jt, wt), channel-major
// with an odd plane stride (asynchronous, see stage()).
__device__ inline void stage_band(const float* __restrict__ x_pad,
                                  const Geometry& g, int n, int jt, int wt,
                                  int c0, int tid, int threads, float* band) {
  const int plane = plane_of(g);
  const int row0 = jt * g.th * g.s, col0 = wt * g.tw * g.s;
  const int band_n = g.band_h * g.band_w * g.tc;
  for (int i = tid; i < band_n; i += threads) {
    const int ch = i % g.tc, pos = i / g.tc;
    const int r = pos / g.band_w, q = pos % g.band_w;
    stage(band + ch * plane + pos,
          x_pad + (((size_t)n * g.hp + row0 + r) * g.wp + col0 + q) * g.c +
              c0 + ch,
          true);
  }
}

__device__ inline bool pixel_in(const Geometry& g, int jt, int wt, int p,
                                int* oy, int* ox) {
  if (p >= g.th * g.tw) return false;
  *oy = jt * g.th + p / g.tw;
  *ox = wt * g.tw + p % g.tw;
  return *oy < g.ho && *ox < g.wo;
}

template <int PIX>
__global__ void __launch_bounds__(kThreads)
dcb_input_kernel(const float* __restrict__ x_pad,
                 const float* __restrict__ off, const float* __restrict__ gy,
                 const float* __restrict__ w_tiles, float* __restrict__ dx_pad,
                 float* __restrict__ d_off, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int k2 = g.k * g.k;
  const int kk_n = kk_rows(g);
  const int kkp = kk_pad(g);
  const int plane = plane_of(g);
  const int bf = band_floats(g);
  float* band = smem;
  float* dxb = band + bf;
  float* dP = dxb + bf;                      // [kkp][PIX]
  float* Wt = dP + kkp * PIX;                // [kMC][kkp + 4]
  float* gT = Wt + kMC * (kkp + 4);          // [kMC][PIX + 4]
  float* doff = gT + kMC * (PIX + 4);        // [k2 * PIX][2]
  float* gty = doff + 2 * k2 * PIX;
  float* gtx = gty + k2 * PIX;
  int* gidx = reinterpret_cast<int*>(gtx + k2 * PIX);

  const int n = blockIdx.y;
  const int jt = blockIdx.x / g.w_tiles;
  const int wt = blockIdx.x % g.w_tiles;
  const int row0 = jt * g.th * g.s;
  const int col0 = wt * g.tw * g.s;
  const int tid = threadIdx.x;
  const int wld = kkp + 4, gld = PIX + 4;
  const int pairs = k2 * PIX;                // (tap, pixel) pairs
  // dP register tiles: 4 rows x 4 pixels, row-quad fastest.
  const int row_quads = kkp / 4;
  const int quads = row_quads * (PIX / 4);

  tile_geometry(off, g, n, jt, wt, PIX, tid, kThreads, gidx, gty, gtx);
  for (int i = tid; i < 2 * pairs; i += kThreads) doff[i] = 0.f;
  for (int i = tid; i < bf; i += kThreads) dxb[i] = 0.f;

  const int c_steps = g.c / g.tc;
  const int band_n = g.band_h * g.band_w * g.tc;
  const int m_steps = (g.m + kMC - 1) / kMC;
  for (int cs = 0; cs < c_steps; ++cs) {
    const int c0 = cs * g.tc;
    __syncthreads();  // the previous chunk is done with band, dP and dxb
    stage_band(x_pad, g, n, jt, wt, c0, tid, kThreads, band);
    // This thread's dP tiles (quads tid, tid + 256, ...), summed over all
    // of M in registers and stored once.
    float acc[kQuadsPerThread][4][4];
#pragma unroll
    for (int k = 0; k < kQuadsPerThread; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][i][j] = 0.f;
    const float* wsrc = w_tiles + (size_t)cs * kk_n * g.m;
    // dP[kk][p] = sum_m W[kk][m] * g[p][m], kMC output channels a step.
    for (int ms = 0; ms < m_steps; ++ms) {
      const int m0 = ms * kMC;
      __syncthreads();  // the previous step is done with Wt and gT
      for (int i = tid; i < kkp * kMC; i += kThreads) {
        const int kk = i / kMC, mm = i % kMC;
        stage(Wt + mm * wld + kk, wsrc + (size_t)kk * g.m + m0 + mm,
              kk < kk_n && m0 + mm < g.m);
      }
      for (int i = tid; i < PIX * kMC; i += kThreads) {
        const int p = i / kMC, mm = i % kMC;
        int oy = 0, ox = 0;
        const bool in = m0 + mm < g.m && pixel_in(g, jt, wt, p, &oy, &ox);
        stage(gT + mm * gld + p,
              gy + (((size_t)n * g.ho + oy) * g.wo + ox) * g.m + m0 + mm, in);
      }
      __pipeline_commit();      // with the first step: the chunk's band
      __pipeline_wait_prior(0);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kQuadsPerThread; ++k) {
        const int q = tid + k * kThreads;
        if (q >= quads) continue;
        const float* wa = Wt + (q % row_quads) * 4;
        const float* gb = gT + (q / row_quads) * 4;
#pragma unroll 4
        for (int mm = 0; mm < kMC; ++mm) {
          const float4 a = *reinterpret_cast<const float4*>(wa + mm * wld);
          const float4 b = *reinterpret_cast<const float4*>(gb + mm * gld);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[k][i][j] = fmaf(av[i], bv[j], acc[k][i][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kQuadsPerThread; ++k) {
      const int q = tid + k * kThreads;
      if (q >= quads) continue;
      const int rq = q % row_quads, pq = q / row_quads;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(dP + (rq * 4 + i) * PIX + pq * 4) =
            make_float4(acc[k][i][0], acc[k][i][1], acc[k][i][2],
                        acc[k][i][3]);
    }
    __syncthreads();
    // One thread per (channel, tap, pixel): its share of d_off, and the
    // four weighted corners scattered into the band accumulator.
    for (int it = tid; it < g.tc * pairs; it += kThreads) {
      const int ch = it / pairs, i = it % pairs;
      const int kt = i / PIX, p = i % PIX;
      int oy, ox;
      if (!pixel_in(g, jt, wt, p, &oy, &ox)) continue;
      const int idx = gidx[i];
      const float ty = gty[i], tx = gtx[i];
      const float* b = band + ch * plane + idx;
      const float v00 = b[0], v01 = b[1];
      const float v10 = b[g.band_w], v11 = b[g.band_w + 1];
      const float dp = dP[(kt * g.tc + ch) * PIX + p];
      atomicAdd(doff + 2 * i,
                dp * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01)));
      atomicAdd(doff + 2 * i + 1,
                dp * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10)));
      float* o = dxb + ch * plane + idx;
      atomicAdd(o, (1.f - ty) * (1.f - tx) * dp);
      atomicAdd(o + 1, (1.f - ty) * tx * dp);
      atomicAdd(o + g.band_w, ty * (1.f - tx) * dp);
      atomicAdd(o + g.band_w + 1, ty * tx * dp);
    }
    __syncthreads();
    // Add the band accumulator into dx_pad; neighbouring tiles' bands
    // overlap, hence global atomics.  Zero it for the next chunk.
    for (int i = tid; i < band_n; i += kThreads) {
      const int ch = i % g.tc, pos = i / g.tc;
      const int r = pos / g.band_w, q = pos % g.band_w;
      float* a = dxb + ch * plane + pos;
      const float v = *a;
      if (v != 0.f) {
        atomicAdd(dx_pad + (((size_t)n * g.hp + row0 + r) * g.wp + col0 + q) *
                               g.c + c0 + ch,
                  v);
        *a = 0.f;
      }
    }
  }
  __syncthreads();
  // d_off, masked by the clamp: gradient only where |raw offset| <= B.
  for (int i = tid; i < pairs; i += kThreads) {
    const int kt = i / PIX, p = i % PIX;
    int oy, ox;
    if (!pixel_in(g, jt, wt, p, &oy, &ox)) continue;
    const size_t at = (((size_t)n * g.ho + oy) * g.wo + ox) * (2 * k2) + 2 * kt;
    const float ry = off[at], rx = off[at + 1];
    d_off[at] = (ry >= -g.bound && ry <= g.bound) ? doff[2 * i] : 0.f;
    d_off[at + 1] = (rx >= -g.bound && rx <= g.bound) ? doff[2 * i + 1] : 0.f;
  }
}

template <int PIX, int NKB>
__global__ void __launch_bounds__(kThreads, 2)
dcb_weight_kernel(const float* __restrict__ x_pad,
                  const float* __restrict__ off, const float* __restrict__ gy,
                  float* __restrict__ dw_out, Geometry g, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int k2 = g.k * g.k;
  const int kk_n = kk_rows(g);
  const int plane = plane_of(g);
  float* band = smem;
  float* P = band + band_floats(g);      // [NKB][PIX][kRows]
  float* G = P + NKB * PIX * kRows;      // [PIX][kTM]
  float* gty = G + PIX * kTM;
  float* gtx = gty + k2 * PIX;
  int* gidx = reinterpret_cast<int*>(gtx + k2 * PIX);

  const int cs = blockIdx.x;
  const int m_tiles = (g.m + kTM - 1) / kTM;
  const int kb0 = (blockIdx.y / m_tiles) * NKB * kRows;
  const int m0 = (blockIdx.y % m_tiles) * kTM;
  const int split = blockIdx.z;
  const int tid = threadIdx.y * 16 + threadIdx.x;
  const int per_image = g.h_tiles * g.w_tiles;
  const int tiles = g.n * per_image;

  float acc[NKB][4][4];
#pragma unroll
  for (int b = 0; b < NKB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.f;

  for (int t = split; t < tiles; t += splits) {
    const int n = t / per_image;
    const int jt = (t % per_image) / g.w_tiles;
    const int wt = (t % per_image) % g.w_tiles;
    __syncthreads();  // the previous tile is done with band, P and G
    tile_geometry(off, g, n, jt, wt, PIX, tid, kThreads, gidx, gty, gtx);
    stage_band(x_pad, g, n, jt, wt, cs * g.tc, tid, kThreads, band);
    for (int i = tid; i < PIX * kTM; i += kThreads) {
      const int p = i / kTM, j = i % kTM;
      int oy = 0, ox = 0;
      const bool in = m0 + j < g.m && pixel_in(g, jt, wt, p, &oy, &ox);
      stage(G + i, gy + (((size_t)n * g.ho + oy) * g.wo + ox) * g.m + m0 + j,
            in);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // Rows kb0 .. kb0 + NKB * 64 - 1 of this tile's patches,
    // P[row block][p][row].
    for (int i = tid; i < NKB * PIX * kRows; i += kThreads) {
      const int r = i % kRows, p = (i / kRows) % PIX;
      const int kk = kb0 + (i / (PIX * kRows)) * kRows + r;
      int oy, ox;
      float v = 0.f;
      if (kk < kk_n && pixel_in(g, jt, wt, p, &oy, &ox)) {
        const int kt = kk / g.tc, ch = kk % g.tc;
        const int gi = kt * PIX + p;
        const float ty = gty[gi], tx = gtx[gi];
        const float* b = band + ch * plane + gidx[gi];
        v = b[0] * ((1.f - ty) * (1.f - tx));
        v += b[1] * ((1.f - ty) * tx);
        v += b[g.band_w] * (ty * (1.f - tx));
        v += b[g.band_w + 1] * (ty * tx);
      }
      P[i] = v;
    }
    __syncthreads();
    const float* pa = P + threadIdx.x * 4;
    const float* gb = G + threadIdx.y * 4;
#pragma unroll 2
    for (int p = 0; p < PIX; ++p) {
      const float4 bq = *reinterpret_cast<const float4*>(gb + p * kTM);
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int b = 0; b < NKB; ++b) {
        const float4 a = *reinterpret_cast<const float4*>(
            pa + (b * PIX + p) * kRows);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[b][i][j] = fmaf(av[i], bv[j], acc[b][i][j]);
      }
    }
  }

  const int c_steps = g.c / g.tc;
  float* dst = dw_out + ((size_t)split * c_steps + cs) * kk_n * g.m;
#pragma unroll
  for (int b = 0; b < NKB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = kb0 + b * kRows + threadIdx.x * 4 + i;
      if (kk >= kk_n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mj = m0 + threadIdx.y * 4 + j;
        if (mj < g.m) dst[(size_t)kk * g.m + mj] = acc[b][i][j];
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

template <int PIX, int NKB>
cudaError_t launch_weight(const float* x_pad, const float* off,
                          const float* gy, float* dw_out, int splits,
                          const Geometry& g, cudaStream_t stream) {
  const size_t smem = weight_smem_bytes(g, PIX);
  cudaError_t e = cudaFuncSetAttribute(
      dcb_weight_kernel<PIX, NKB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int groups = (row_blocks(g) + NKB - 1) / NKB;
  const int m_tiles = (g.m + kTM - 1) / kTM;
  const dim3 grid(g.c / g.tc, groups * m_tiles, splits);
  dcb_weight_kernel<PIX, NKB><<<grid, dim3(16, 16), smem, stream>>>(
      x_pad, off, gy, dw_out, g, splits);
  return cudaGetLastError();
}

template <int PIX>
cudaError_t launch(const float* x_pad, const float* off, const float* gy,
                   const float* w_tiles, float* dx_pad, float* d_off,
                   float* dw_tiles, float* dw_partial, int splits,
                   const Geometry& g, cudaStream_t stream) {
  const size_t in_smem = input_smem_bytes(g, PIX);
  cudaError_t e = cudaFuncSetAttribute(
      dcb_input_kernel<PIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)in_smem);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(dx_pad, 0,
                      sizeof(float) * (size_t)g.n * g.hp * g.wp * g.c, stream);
  if (e != cudaSuccess) return e;
  const dim3 in_grid(g.h_tiles * g.w_tiles, g.n);
  dcb_input_kernel<PIX><<<in_grid, kThreads, in_smem, stream>>>(
      x_pad, off, gy, w_tiles, dx_pad, d_off, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float* dw_out = splits > 1 ? dw_partial : dw_tiles;
  switch (rows_per_block(g)) {
    case 1: e = launch_weight<PIX, 1>(x_pad, off, gy, dw_out, splits, g,
                                      stream); break;
    case 2: e = launch_weight<PIX, 2>(x_pad, off, gy, dw_out, splits, g,
                                      stream); break;
    case 3: e = launch_weight<PIX, 3>(x_pad, off, gy, dw_out, splits, g,
                                      stream); break;
    case 4: e = launch_weight<PIX, 4>(x_pad, off, gy, dw_out, splits, g,
                                      stream); break;
    default: e = launch_weight<PIX, 5>(x_pad, off, gy, dw_out, splits, g,
                                       stream);
  }
  if (e != cudaSuccess || splits == 1) return e;
  const long long count = (long long)kk_rows(g) * g.m * (g.c / g.tc);
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256
                                                      : 1024);
  dcb_reduce_kernel<<<blocks, 256, 0, stream>>>(dw_partial, dw_tiles, count,
                                                splits);
  return cudaGetLastError();
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
  return g;
}

}  // namespace

extern "C" {

// Shared memory of one block of the d_input/d_offsets kernel (bytes), the
// larger of the two; 0 if the tile has more pixels than its 64 lanes.
long long dcb_smem_bytes(int k, int s, int d, int hb, int th, int tw,
                         int tc) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 1) return 0;
  Geometry g = make_geometry(0, 0, 0, 0, 0, 0, 0, k, s, d, 0.f, hb, th, tw,
                             tc);
  return (long long)input_smem_bytes(g, pix);
}

// Launch the fused backward on `stream`: zero dx_pad, then the d_input /
// d_offsets kernel, the d_weights kernel and, with splits > 1, the
// reduction of its partials (dw_partial: splits x C/tc x K*K*tc x M
// floats).  Returns a cudaError_t (0 on success); invalid arguments
// return cudaErrorInvalidValue before anything is launched.
int dcb_backward(const float* x_pad, const float* off, const float* gy,
                 const float* w_tiles, float* dx_pad, float* d_off,
                 float* dw_tiles, float* dw_partial, int n, int hp, int wp,
                 int c, int ho, int wo, int m, int k, int s, int d,
                 float bound, int hb, int th, int tw, int tc, int splits,
                 void* stream) {
  const int pix = pix_lanes(th, tw);
  if (pix == 0 || tc < 1 || c % tc != 0 || splits < 1 || n < 1 ||
      (splits > 1 && dw_partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Geometry g = make_geometry(n, hp, wp, c, ho, wo, m, k, s, d, bound, hb, th,
                             tw, tc);
  if (input_smem_bytes(g, pix) > 232448 || weight_smem_bytes(g, pix) > 232448 ||
      kk_pad(g) / 4 * (pix / 4) > kQuadsPerThread * kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (pix == 16)
    e = launch<16>(x_pad, off, gy, w_tiles, dx_pad, d_off, dw_tiles,
                   dw_partial, splits, g, st);
  else if (pix == 32)
    e = launch<32>(x_pad, off, gy, w_tiles, dx_pad, d_off, dw_tiles,
                   dw_partial, splits, g, st);
  else
    e = launch<64>(x_pad, off, gy, w_tiles, dx_pad, d_off, dw_tiles,
                   dw_partial, splits, g, st);
  return (int)e;
}

const char* dcb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
