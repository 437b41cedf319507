"""Plain PyTorch reference of InternImage (arXiv:2211.05778; the official
``intern_image.py`` and ``dcnv3_core_pytorch``) as a detector: the stem,
four stages of post-norm DCNv3 layers with layer scale, the downsampling
convolutions, and a dense single-scale head.

It is the benchmark's oracle: it imports nothing of the program.  Layout
NHWC, convolution weights HWIO and linear weights (in, out), in the
parameter layout the program takes, so the weights the benchmark draws
serve both sides.  Its departures from the published model:

* the bound: each DCNv3 layer's offsets are clamped to ±``offset_bound``
  (B = 2), the paper's Eq. 5 applied to DCNv3 (arXiv:2006.05238); the
  published offsets are unbounded;
* the head: the Mask R-CNN FPN and RoI heads are replaced by the dense
  head of the ResNet-50-DCN configurations (``pb_ref_dcn``) on the last
  stage: conv 3x3 -> 256, GroupNorm 32, ReLU, 1x1 convs to the class
  logits (with objectness) and 4 box values;
* the offset layout is the official one, (G, K*K, 2) a pixel with (dx,
  dy) a tap and the taps x outer, y inner; the core samples in pixel
  coordinates (``core``-style bilinear, zero outside the image) where
  the official code goes through ``F.grid_sample`` on normalised ones.

The convolutions pad one pixel on each side (PyTorch's ``padding=1``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pb_ref_dcn import conv, group_norm, tf32  # noqa: F401  (re-export)

Tensor = torch.Tensor

GELU_SQUARE = 0.4256     # E[gelu(z)^2] of a unit normal z


# -- parameters -------------------------------------------------------------

def _normal(shape, fan_in):
    return (tuple(shape), "normal", 1.0 / math.sqrt(fan_in))


def _zeros(c):
    return ((c,), "zeros", None)


def _ln(c):
    return {"scale": ((c,), "ones", None), "bias": _zeros(c)}


def _dense(cin, cout, std=None):
    w = _normal((cin, cout), cin)
    if std is not None:
        w = ((cin, cout), "normal", std)
    return {"w": w, "b": _zeros(cout)}


def param_specs(cfg: dict) -> dict:
    """``(shape, init, std)`` of every weight.  The offset projection's
    std gives offsets of standard deviation ``offset_std`` pixels on its
    input GELU(LN(.)) (second moment ``GELU_SQUARE``), so taps land
    between pixels and about 1% beyond the bound; the mask projection
    gives logits of standard deviation ~0.65; biases start at zero and
    every layer scale at 1."""
    k = cfg["kernel_size"]
    k2, c0 = k * k, cfg["channels"]
    specs = {"stem": {
        "conv1": {"w": _normal((3, 3, 3, c0 // 2), 27), "b": _zeros(c0 // 2)},
        "ln1": _ln(c0 // 2),
        "conv2": {"w": _normal((3, 3, c0 // 2, c0), 9 * (c0 // 2)),
                  "b": _zeros(c0)},
        "ln2": _ln(c0)}}
    n = len(cfg["depths"])
    for s, (depth, g) in enumerate(zip(cfg["depths"], cfg["groups"])):
        c = c0 * 2 ** s
        hidden = int(c * cfg["mlp_ratio"])
        for b in range(depth):
            specs[f"s{s}b{b}"] = {
                "dcn": {
                    "input_proj": _dense(c, c),
                    "dw": {"w": _normal((k, k, 1, c), k2), "b": _zeros(c)},
                    "dw_ln": _ln(c),
                    "offset": _dense(c, g * k2 * 2, cfg["offset_std"]
                                     / math.sqrt(c * GELU_SQUARE)),
                    "mask": _dense(c, g * k2),
                    "output_proj": _dense(c, c)},
                "norm1": _ln(c), "gamma1": ((c,), "ones", None),
                "mlp": {"fc1": _dense(c, hidden), "fc2": _dense(hidden, c)},
                "norm2": _ln(c), "gamma2": ((c,), "ones", None)}
        if s + 1 < n:
            specs[f"down{s}"] = {"conv": _normal((3, 3, c, 2 * c), 9 * c),
                                 "ln": _ln(2 * c)}
    c, hw = c0 * 2 ** (n - 1), cfg["head_width"]
    specs["head"] = {"conv": _normal((3, 3, c, hw), 9 * c),
                     "gn": {"scale": ((hw,), "ones", None),
                            "bias": _zeros(hw)},
                     "cls": _normal((1, 1, hw, cfg["num_classes"] + 1), hw),
                     "box": _normal((1, 1, hw, 4), hw)}
    return specs


# -- layers -------------------------------------------------------------------

def layer_norm(x: Tensor, p: dict, eps: float) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def linear(x: Tensor, p: dict) -> Tensor:
    return x @ p["w"] + p["b"]


def dcnv3_core(v: Tensor, offsets: Tensor, logits: Tensor, *, groups: int,
               k: int, bound: float) -> Tensor:
    """The DCNv3 core, group by group within one tensor and tap by tap:
    v (N, H, W, C); offsets (N, H, W, G*K*K*2), (dx, dy) a tap clamped to
    ±bound; logits (N, H, W, G*K*K), softmax over each group's taps.
    Each tap samples the zero-padded input bilinearly at (y - K//2 + iy +
    dy, x - K//2 + ix + dx), tap t = ix*K + iy."""
    n, h, w, c = v.shape
    gc, k2 = c // groups, k * k
    m = torch.softmax(logits.reshape(n, h, w, groups, k2), dim=-1)
    off = offsets.reshape(n, h, w, groups, k2, 2).clamp(-bound, bound)
    p = k // 2 + int(math.ceil(bound)) + 1     # every corner inside
    vp = F.pad(v.reshape(n, h, w, groups, gc), (0, 0, 0, 0, p, p, p, p))
    rows = torch.arange(n, device=v.device).view(n, 1, 1, 1)
    grp = torch.arange(groups, device=v.device).view(1, 1, 1, groups)
    ys = torch.arange(h, device=v.device).view(1, h, 1, 1).float()
    xs = torch.arange(w, device=v.device).view(1, 1, w, 1).float()
    out = torch.zeros(n, h, w, groups, gc, device=v.device)
    for t in range(k2):
        ix, iy = divmod(t, k)
        px = xs + (ix - k // 2 + p) + off[..., t, 0]   # padded frame
        py = ys + (iy - k // 2 + p) + off[..., t, 1]
        x0, y0 = px.floor(), py.floor()
        fx, fy = px - x0, py - y0
        x0, y0 = x0.long(), y0.long()
        sample = (vp[rows, y0, x0, grp] * ((1 - fy) * (1 - fx))[..., None]
                  + vp[rows, y0, x0 + 1, grp] * ((1 - fy) * fx)[..., None]
                  + vp[rows, y0 + 1, x0, grp] * (fy * (1 - fx))[..., None]
                  + vp[rows, y0 + 1, x0 + 1, grp] * (fy * fx)[..., None])
        out = out + m[..., t, None] * sample
    return out.reshape(n, h, w, c)


def dcnv3_module(p: dict, u: Tensor, cfg: dict, groups: int) -> Tensor:
    k, eps = cfg["kernel_size"], cfg["ln_eps"]
    c = u.shape[-1]
    v = linear(u, p["input_proj"])
    dw = p["dw"]["w"].permute(3, 2, 0, 1)                 # (C, 1, K, K)
    a = F.conv2d(u.permute(0, 3, 1, 2), dw, p["dw"]["b"], padding=k // 2,
                 groups=c).permute(0, 2, 3, 1)
    a = F.gelu(layer_norm(a, p["dw_ln"], eps))
    y = dcnv3_core(v, linear(a, p["offset"]), linear(a, p["mask"]),
                   groups=groups, k=k, bound=cfg["offset_bound"])
    return linear(y, p["output_proj"])


def forward(params: dict, cfg: dict, images: Tensor):
    """images (N, H, W, 3) -> (cls, box)."""
    eps, st = cfg["ln_eps"], params["stem"]
    x = conv(images, st["conv1"]["w"], 2, pad=1) + st["conv1"]["b"]
    x = F.gelu(layer_norm(x, st["ln1"], eps))
    x = layer_norm(conv(x, st["conv2"]["w"], 2, pad=1) + st["conv2"]["b"],
                   st["ln2"], eps)
    n = len(cfg["depths"])
    for s, (depth, g) in enumerate(zip(cfg["depths"], cfg["groups"])):
        for b in range(depth):
            p = params[f"s{s}b{b}"]
            x = x + p["gamma1"] * layer_norm(dcnv3_module(p["dcn"], x, cfg, g),
                                             p["norm1"], eps)
            h = linear(F.gelu(linear(x, p["mlp"]["fc1"])), p["mlp"]["fc2"])
            x = x + p["gamma2"] * layer_norm(h, p["norm2"], eps)
        if s + 1 < n:
            d = params[f"down{s}"]
            x = layer_norm(conv(x, d["conv"], 2, pad=1), d["ln"], eps)
    hd = params["head"]
    h = F.relu(group_norm(conv(x, hd["conv"]), hd["gn"], 32))
    return conv(h, hd["cls"]), conv(h, hd["box"])
