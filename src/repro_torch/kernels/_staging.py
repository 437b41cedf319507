"""What the DCL kernels 1a, 4 and 2 share: the dtypes of their two
instances, the band bits of their ``vec`` argument, and the launch count
of each instance.

``vec`` bit 0 is each wrapper's own (its W, or W and g, copies); bits 1-3
say how the band is staged, and ``csrc/deform_conv_fused.cu`` and
``csrc/deform_conv_bwd.cu`` decode them the same way.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# The input, the weights (and the cotangent) share one of these dtypes;
# the offsets may take either.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# Band bits of ``vec`` and the channels one copy of each stages.
_BAND_UNITS = ((4, 8), (2, 4), (8, 2))


def band_vec(src: Tensor, tile_c: int) -> int:
    """How the kernels stage the band of ``src``: 4 channels a copy (bit
    1), 8 (bit 2, bf16) or 2 (bit 3, bf16), the most channels, up to 16
    bytes (fp32: 4 or none), that divide tile_c and C and whose bytes the
    source's address is aligned to; 0: element by element."""
    size = src.element_size()
    units = ((4, 2),) if size == 4 else ((8, 4), (4, 2), (2, 8))
    for unit, bit in units:
        if tile_c % unit == 0 and src.shape[-1] % unit == 0 \
                and src.data_ptr() % (unit * size) == 0:
            return bit
    return 0


def band_channels(vec: int) -> int:
    """Channels a band copy of ``vec`` stages (1: element by element)."""
    for bit, unit in _BAND_UNITS:
        if vec & bit:
            return unit
    return 1


def count_launch(fn, src: Tensor) -> None:
    """One launch of ``fn``'s kernel: ``launches`` counts both instances,
    ``launches_bf16`` the bf16 one."""
    fn.launches += 1
    if src.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
