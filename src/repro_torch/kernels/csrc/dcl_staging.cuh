// What the DCL kernels 1a, 4 (deform_conv_fused.cu) and 2
// (deform_conv_bwd.cu) share: the band bits of their wrappers' `vec`
// argument (repro_torch/kernels/_staging.py sets them) and the offsets'
// load in either dtype.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace dcl_staging {

constexpr int kVecBand = 2;   // vec bit: the band 4 channels a copy
constexpr int kVecBand8 = 4;  // vec bit (bf16): 8 channels a copy
constexpr int kVecBand2 = 8;  // vec bit (bf16): 2 channels a copy

// Channels of one band copy (1: element by element).
__host__ __device__ inline int band_unit(int vec) {
  return (vec & kVecBand8) ? 8 : (vec & kVecBand) ? 4 : (vec & kVecBand2) ? 2
                                                                          : 1;
}

// Offset i of a float32 (bf = 0) or bfloat16 (bf = 1) tensor, as fp32.
__device__ inline float load_off(const void* off, size_t i, int bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(off)[i])
            : static_cast<const float*>(off)[i];
}

}  // namespace dcl_staging
