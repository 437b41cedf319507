"""InternImage (arXiv:2211.05778; the official ``intern_image.py``): a
backbone of DCNv3 layers, served with the dense detection head of
``models.resnet_dcn``.

Layout NHWC with HWIO convolution weights and (in, out) linear weights.
The published detection backbone, as ``mask_rcnn_internimage_b_fpn``
configures it:

* stem: conv 3x3 stride 2 (3 -> C/2), LayerNorm, GELU; conv 3x3 stride 2
  (C/2 -> C), LayerNorm;
* four stages of ``depths`` post-norm layers at widths C, 2C, 4C, 8C with
  ``groups`` DCNv3 groups, each layer
  ``x = x + γ1 · LN(DCNv3(x))``, then ``x = x + γ2 · LN(MLP(x))``
  (``post_norm`` True, layer scale present; MLP ratio 4, exact GELU);
* between stages a conv 3x3 stride 2 without bias (C -> 2C), LayerNorm.

These convolutions pad one pixel on every side (``padding=1``), not as
XLA's SAME.  LayerNorms take ``ln_eps`` (1e-6).  The DCNv3 module on
input u: ``v = input_proj(u)``; ``a = GELU(LN(dwconv3x3(u)))``; offsets
``Linear_off(a)`` (G*K*K*2: (dx, dy) a tap, the taps x outer, y inner) and
mask logits ``Linear_mask(a)`` (G*K*K); ``y = output_proj(dcnv3(v,
offsets, mask))``, the core with the softmax over each group's taps and
offsets clamped to ±``offset_bound`` (``kernels.dcnv3``).

The bound departs from the published model, whose offsets are unbounded:
the layers are taken as trained with Eq. 5 to B (arXiv:2006.05238), and
their offsets clamped there, so that each reads a bounded window.  The
offset scale is 1.0, as published: the core samples the unscaled grid.

``use_kernel=True`` runs the core through ``ops.dcnv3`` (the ``dv3_``
kernel on CUDA); ``False`` through ``kernels.dcnv3.dcnv3_plain`` directly,
the plain path.  There is no int8 datapath and no backward kernel:
``forward`` is inference.  ``forward`` returns ``resnet_dcn.forward``'s
contract, ``({"cls", "box", "features"}, {})``: no DCNv3 layer reports an
Eq. 3 statistic.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.deform_conv import conv2d
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import dcnv3, ops
from repro_torch.models.layers import ParamDef, init_tree
from repro_torch.models.resnet_dcn import dense_head, head_def

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class InternImageConfig:
    name: str = "internimage_b"
    channels: int = 112
    depths: tuple[int, ...] = (4, 4, 21, 4)
    groups: tuple[int, ...] = (7, 14, 28, 56)
    kernel_size: int = 3
    mlp_ratio: float = 4.0
    offset_bound: float = 2.0
    ln_eps: float = 1e-6
    num_classes: int = 80
    img_size: int = 512
    use_kernel: bool = False       # the core through ops.dcnv3

    def __post_init__(self):
        if len(self.depths) != len(self.groups):
            raise ValueError(f"depths {self.depths} and groups "
                             f"{self.groups} name different stage counts")

    def width(self, stage: int) -> int:
        return self.channels * 2 ** stage


def _dense_def(cin: int, cout: int, init: str = "normal") -> dict:
    return {"w": ParamDef((cin, cout), (None, None), init=init),
            "b": ParamDef((cout,), (None,), init="zeros")}


def _ln_def(c: int) -> dict:
    return {"scale": ParamDef((c,), (None,), init="ones"),
            "bias": ParamDef((c,), (None,), init="zeros")}


def _conv_def(kh: int, kw: int, cin: int, cout: int) -> ParamDef:
    return ParamDef((kh, kw, cin, cout), (None, None, None, "conv_out"))


def _layer_def(cfg: InternImageConfig, c: int, g: int) -> dict:
    k2 = cfg.kernel_size ** 2
    hidden = int(c * cfg.mlp_ratio)
    return {
        "dcn": {
            "input_proj": _dense_def(c, c),
            "dw": {"w": _conv_def(cfg.kernel_size, cfg.kernel_size, 1, c),
                   "b": ParamDef((c,), (None,), init="zeros")},
            "dw_ln": _ln_def(c),
            # Zero-initialised, as the official _reset_parameters does: a
            # fresh layer samples the plain grid with uniform weights.
            "offset": _dense_def(c, g * k2 * 2, init="zeros"),
            "mask": _dense_def(c, g * k2, init="zeros"),
            "output_proj": _dense_def(c, c),
        },
        "norm1": _ln_def(c),
        "gamma1": ParamDef((c,), (None,), init="ones"),   # layer scale 1.0
        "mlp": {"fc1": _dense_def(c, hidden), "fc2": _dense_def(hidden, c)},
        "norm2": _ln_def(c),
        "gamma2": ParamDef((c,), (None,), init="ones"),
    }


def model_def(cfg: InternImageConfig) -> dict:
    c = cfg.channels
    defs = {"stem": {
        "conv1": {"w": _conv_def(3, 3, 3, c // 2),
                  "b": ParamDef((c // 2,), (None,), init="zeros")},
        "ln1": _ln_def(c // 2),
        "conv2": {"w": _conv_def(3, 3, c // 2, c),
                  "b": ParamDef((c,), (None,), init="zeros")},
        "ln2": _ln_def(c)}}
    for s, (depth, g) in enumerate(zip(cfg.depths, cfg.groups)):
        w = cfg.width(s)
        for b in range(depth):
            defs[f"s{s}b{b}"] = _layer_def(cfg, w, g)
        if s + 1 < len(cfg.depths):
            defs[f"down{s}"] = {"conv": _conv_def(3, 3, w, 2 * w),
                                "ln": _ln_def(2 * w)}
    defs["head"] = head_def(cfg.width(len(cfg.depths) - 1), cfg.num_classes)
    return defs


def init_params(cfg: InternImageConfig, *, seed: int = 0,
                device: str | torch.device | None = None):
    """Seeded params on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_tree(model_def(cfg), gen, dev)


def bucket_layer_dims(cfg: InternImageConfig, res: int) -> dict[str, dict]:
    """Dims of every DCNv3 layer at input resolution ``res``: the stem
    takes the image to res/4, each later stage halves it."""
    dims: dict[str, dict] = {}
    e = res // 4
    for s, (depth, g) in enumerate(zip(cfg.depths, cfg.groups)):
        for b in range(depth):
            dims[f"s{s}b{b}"] = dict(h=e, w=e, c=cfg.width(s), groups=g)
        e = -(-e // 2)
    return dims


# The serving rungs, top first (``serve.dcl_engine``'s ladder): no int8
# datapath and no calibration.
RUNGS = ("fp32_kernel", "fp32_ref")


def rung_configs(cfg: InternImageConfig) -> dict[str, InternImageConfig]:
    """The config each of ``RUNGS`` serves."""
    return {"fp32_kernel": dataclasses.replace(cfg, use_kernel=True),
            "fp32_ref": dataclasses.replace(cfg, use_kernel=False)}


def warm_plans(cfg: InternImageConfig, bucket: int, *, rung: str,
               slots: int, device, spatial_shards: int = 1):
    """Every DCNv3 layer's plan of the ``dv3_`` kernel at ``bucket`` and
    batch ``slots`` (``dcnv3.warm``'s ``(tiles, sources)``), the kernel
    built on CUDA; ``None`` on ``fp32_ref``.  Raises for a spatial bucket:
    the kernel has no height split."""
    if spatial_shards > 1:
        raise ValueError(
            f"spatial_shards={spatial_shards} for bucket {bucket} has no "
            f"InternImage path ({cfg.name}): the DCNv3 kernel has no "
            f"height split")
    if rung != "fp32_kernel":
        return None
    return dcnv3.warm(bucket_layer_dims(cfg, bucket), batch=slots,
                      offset_bound=cfg.offset_bound,
                      kernel_size=cfg.kernel_size, device=device)


def _linear(x: Tensor, p: dict) -> Tensor:
    return F.linear(x, p["w"].t(), p["b"])


def _ln(x: Tensor, p: dict, eps: float) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _conv(x: Tensor, p: dict) -> Tensor:
    """A stem convolution: 3x3, stride 2, one pixel of padding, bias."""
    return conv2d(x, p["w"], stride=2, padding=1) + p["b"]


def dcnv3_block(p: dict, u: Tensor, cfg: InternImageConfig, groups: int,
                device) -> Tensor:
    """The DCNv3 module (module docstring) on u (N, H, W, C)."""
    c, k = u.shape[-1], cfg.kernel_size
    v = _linear(u, p["input_proj"])
    a = conv2d(u, p["dw"]["w"], padding=(k - 1) // 2, groups=c) \
        + p["dw"]["b"]
    a = F.gelu(_ln(a, p["dw_ln"], cfg.ln_eps))
    offsets = _linear(a, p["offset"])
    logits = _linear(a, p["mask"])
    geom = dict(groups=groups, kernel_size=k, offset_bound=cfg.offset_bound)
    if cfg.use_kernel:
        y = ops.dcnv3(v, offsets, logits, device=device, **geom)
    else:
        y = dcnv3.dcnv3_plain(v, offsets, logits, **geom)
    return _linear(y, p["output_proj"])


def _layer(p: dict, x: Tensor, cfg: InternImageConfig, groups: int,
           device) -> Tensor:
    eps = cfg.ln_eps
    x = x + p["gamma1"] * _ln(dcnv3_block(p["dcn"], x, cfg, groups, device),
                              p["norm1"], eps)
    h = _linear(F.gelu(_linear(x, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return x + p["gamma2"] * _ln(h, p["norm2"], eps)


def forward(params, cfg: InternImageConfig, images: Tensor, *,
            device: str | torch.device | None = None):
    """images (N, H, W, 3) on ``device`` -> ``({"cls", "box",
    "features"}, {})``: the head's outputs on the last stage, whose
    output is ``features``."""
    dev = resolve_device(device)
    check_on(dev, images=images)
    eps, st = cfg.ln_eps, params["stem"]
    x = F.gelu(_ln(_conv(images.float(), st["conv1"]), st["ln1"], eps))
    x = _ln(_conv(x, st["conv2"]), st["ln2"], eps)
    for s, (depth, g) in enumerate(zip(cfg.depths, cfg.groups)):
        for b in range(depth):
            x = _layer(params[f"s{s}b{b}"], x, cfg, g, dev)
        if s + 1 < len(cfg.depths):
            d = params[f"down{s}"]
            x = _ln(conv2d(x, d["conv"], stride=2, padding=1), d["ln"], eps)
    cls, box = dense_head(params["head"], x)
    return {"cls": cls, "box": box, "features": x}, {}
