"""The yardstick's arithmetic: the H100's peaks, a detector's FLOPs and
the bound of every DCL kernel call, counted from layer shapes alone.

A frozen copy of the work arithmetic of ``repro_torch/core/h100.py``
with one change: fp32 products count at the card's TF32 tensor rate,
the highest rate at which fp32 inputs can be multiplied, whatever the
kernel implements them with.  int8 products count at the int8 rate, and
each input byte is read once and each output byte written once at the
HBM rate; a bound is the larger of the two times.  Nothing here imports
torch or the program.
"""
from __future__ import annotations

import re

# NVIDIA's data sheet, H100 SXM, dense rates at 700 W.
PEAK_BF16_FLOPS = 989e12          # the card's highest floating-point rate
PEAK_TF32_FLOPS = 494.7e12        # fp32 inputs on the tensor cores
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# Device kernels of the port's DCL libraries, by name prefix: kernels 1a
# and 4 (dcf_), 1c and 1d (dqt_, dco_, dcq_) and 2 (dcb_).
DCL_KERNEL_PREFIXES = ("dcf_", "dcq_", "dco_", "dqt_", "dcb_")


def kernel_function(name: str) -> str:
    """The bare function name of a device kernel as the profiler names
    it (``void (anonymous namespace)::dcq_kernel<64, 2>(...)`` ->
    ``dcq_kernel``)."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip()


def is_dcl_kernel(name: str) -> bool:
    return kernel_function(name).startswith(DCL_KERNEL_PREFIXES)


def conv_out(n: int, k: int, stride: int) -> int:
    """Output extent of a convolution whose padding keeps ceil(n/stride)
    (XLA's SAME and the DCL's symmetric K//2 padding agree on it)."""
    return -(-n // stride)


def dcl_layers(cfg: dict, img: int) -> list[dict]:
    """Every DCL of a ResNet-DCN at input ``img``: input extent, channels
    and stride.  The stem (stride 2) and max-pool (stride 2) take the
    image to img/4; each later stage's first block has stride 2."""
    e = img // 4
    out, bi = [], 0
    total = sum(cfg["stage_sizes"])
    for s, (blocks, width) in enumerate(zip(cfg["stage_sizes"],
                                            cfg["widths"])):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            if bi >= total - cfg["num_dcn"]:
                mid = width // 4
                out.append(dict(name=f"s{s}b{b}", h=e, w=e, c=mid, m=mid,
                                stride=stride))
            e = conv_out(e, 3, stride)
            bi += 1
    return out


def forward_macs(cfg: dict, img: int) -> int:
    """Multiply-accumulates of one image's forward: every convolution,
    each DCL's offset conv and its deformable contraction, the head."""
    k2 = cfg["kernel_size"] ** 2
    macs = 0
    e = conv_out(img, 7, 2)
    macs += e * e * 49 * 3 * cfg["stem_width"]
    e = conv_out(e, 3, 2)                               # max-pool
    cin, bi = cfg["stem_width"], 0
    total = sum(cfg["stage_sizes"])
    for s, (blocks, width) in enumerate(zip(cfg["stage_sizes"],
                                            cfg["widths"])):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            mid = width // 4
            eo = conv_out(e, 3, stride)
            macs += e * e * cin * mid                   # conv1
            if bi >= total - cfg["num_dcn"]:
                macs += eo * eo * k2 * mid * (mid + 2 * k2)   # DCL + offsets
            else:
                macs += eo * eo * k2 * mid * mid        # conv2
            macs += eo * eo * mid * width               # conv3
            if b == 0 or cin != width:
                macs += eo * eo * cin * width           # proj
            e, cin = eo, width
            bi += 1
    head = cfg["head_width"]
    macs += e * e * 9 * cin * head
    macs += e * e * head * (cfg["num_classes"] + 1 + 4)
    return macs


def forward_flops(cfg: dict, img: int) -> float:
    return 2.0 * forward_macs(cfg, img)


def _bound(ops_s: float, nbytes: float) -> float:
    return max(ops_s, nbytes / PEAK_HBM_BYTES_PER_S)


def dcl_fp32_forward_s(n: int, h: int, w: int, c: int, m: int,
                       stride: int, k: int = 3) -> float:
    """Kernel 1a: x, offsets and w read, y written, fp32."""
    ho, wo = conv_out(h, k, stride), conv_out(w, k, stride)
    k2, p = k * k, n * ho * wo
    flops = 2 * p * k2 * c * m
    nbytes = 4 * (n * h * w * c + k2 * c * m + p * m) + 4 * p * 2 * k2
    return _bound(flops / PEAK_TF32_FLOPS, nbytes)


def dcl_fp32_backward_s(n: int, h: int, w: int, c: int, m: int,
                        stride: int, k: int = 3) -> float:
    """Kernel 2: x, offsets, g and w read; dx, d_offsets and dw written;
    dP = g Wᵀ and dw = Pᵀ g."""
    ho, wo = conv_out(h, k, stride), conv_out(w, k, stride)
    k2, p = k * k, n * ho * wo
    flops = 4 * p * k2 * c * m
    nbytes = 4 * (2 * n * h * w * c + p * m + 2 * k2 * c * m) \
        + 4 * 2 * p * 2 * k2
    return _bound(flops / PEAK_TF32_FLOPS, nbytes)


def dcl_int8_chain_s(n: int, h: int, w: int, c: int, m: int,
                     stride: int, k: int = 3) -> float:
    """Kernel 1d: the int8 input and weights (deform and offset conv),
    the scales and biases read, the int8 output written; the offset
    conv's products and the contraction's at the int8 rate."""
    ho, wo = conv_out(h, k, stride), conv_out(w, k, stride)
    k2, p = k * k, n * ho * wo
    ops = 2 * p * k2 * c * (m + 2 * k2)
    nbytes = n * h * w * c + k2 * c * m + p * m + 4 * m \
        + k2 * c * 2 * k2 + 4 * (4 * k2 + m)
    return _bound(ops / PEAK_INT8_OPS, nbytes)


def dcl_bound_s(cfg: dict, img: int, batch: int, path: str) -> float:
    """The least time the card could take for the DCL kernels of one
    forward (``path`` "int8_chain" or "fp32") or one training step
    ("train": forward and backward) at ``batch`` images."""
    total = 0.0
    for L in dcl_layers(cfg, img):
        shape = (batch, L["h"], L["w"], L["c"], L["m"], L["stride"])
        if path == "int8_chain":
            total += dcl_int8_chain_s(*shape)
        elif path == "fp32":
            total += dcl_fp32_forward_s(*shape)
        elif path == "train":
            total += dcl_fp32_forward_s(*shape) + dcl_fp32_backward_s(*shape)
        else:
            raise ValueError(f"unknown DCL path {path!r}")
    return total
