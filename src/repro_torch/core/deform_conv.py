"""Deformable convolution (Dai et al., ICCV'17) in plain PyTorch — Eq. 1-4.

Counterpart of ``repro.core.deform_conv``: the reference semantics of the
deformable convolutional layer (DCL) that the kernels are held against.

    o = f(x, w_o)                      (Eq. 1)  offset-generating conv
    y = f(g(x, o), w_deform)           (Eq. 2)  conv over bilinear samples
    o_max = max_i |o_i|                (Eq. 3)
    RF    = K_C + 2 * ceil(o_max)      (Eq. 4)

Layout is NHWC with HWIO weights.  Offsets are ``(..., K*K, 2)`` with
``[..., 0] = dy`` and ``[..., 1] = dx``.  Samples outside the image
contribute zero.  ``offset_bound`` clamps offsets to ``[-B, B]``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Receptive-field algebra (Eq. 3, Eq. 4)
# ---------------------------------------------------------------------------

def offset_abs_max(offsets: Tensor) -> Tensor:
    """Eq. 3: o_max = max over the offset tensor of |o_i|."""
    return offsets.abs().amax()


def receptive_field(kernel_size: int, o_max: float) -> int:
    """Eq. 4: RF = K_C + 2 * ceil(o_max)."""
    return int(kernel_size + 2 * math.ceil(float(o_max)))


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DCLConfig:
    """Static configuration of one deformable convolutional layer."""

    in_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    dilation: int = 1
    offset_bound: float | None = None
    use_bias: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def taps(self) -> int:
        return self.kernel_size * self.kernel_size

    @property
    def pad(self) -> int:
        return self.dilation * (self.kernel_size // 2)

    def static_rf(self) -> int | None:
        if self.offset_bound is None:
            return None
        return receptive_field(self.kernel_size, self.offset_bound)


def init_dcl_params(cfg: DCLConfig, *, seed: int = 0,
                    device: str | torch.device | None = None
                    ) -> dict[str, Tensor]:
    """Seeded DCL params on ``device`` (default ``cuda``), as JAX's
    ``init_dcl_params`` (``repro/core/deform_conv.py:95``) makes them: a
    zero offset conv (the layer starts as a plain convolution), He-init
    deform weights, and with ``use_bias`` zero biases.  The JAX function
    takes a PRNG key; this one a seed."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    k, c, m = cfg.kernel_size, cfg.in_channels, cfg.out_channels
    gen = torch.Generator().manual_seed(seed)
    w_deform = torch.randn(k, k, c, m, generator=gen) \
        * math.sqrt(2.0 / (k * k * c))
    params = {"w_offset": torch.zeros(k, k, c, 2 * k * k),
              "w_deform": w_deform}
    if cfg.use_bias:
        params["b_offset"] = torch.zeros(2 * k * k)
        params["b_deform"] = torch.zeros(m)
    return {name: t.to(dev) for name, t in params.items()}


# ---------------------------------------------------------------------------
# Standard convolution helper (NHWC x HWIO -> NHWC)
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, stride: int, dilation: int) -> tuple[int, int]:
    """XLA's "SAME" padding along one axis: out = ceil(n / stride) and the
    extra row, when the total is odd, goes to the high side."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def conv2d(x: Tensor, w: Tensor, *, stride: int = 1, dilation: int = 1,
           padding: str | int = "SAME", groups: int = 1) -> Tensor:
    """``lax.conv_general_dilated`` with NHWC/HWIO/NHWC numbers.

    ``groups`` splits the channels as ``F.conv2d`` does: w is (KH, KW,
    C // groups, M), so ``groups=C`` with w (KH, KW, 1, C) is a
    depthwise convolution.

    ``padding="SAME"`` follows XLA, which pads (0, 1) for a 3x3 stride-2
    conv on an even extent, where ``F.conv2d(padding=1)`` pads (1, 1).
    The NHWC tensor is handed to ``F.conv2d`` as a channels-last NCHW
    view, so no layout copy is made.
    """
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    if isinstance(padding, int):
        y = F.conv2d(xn, wn, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)
    elif padding == "SAME":
        kh, kw = w.shape[0], w.shape[1]
        ph = _same_pads(x.shape[1], kh, stride, dilation)
        pw = _same_pads(x.shape[2], kw, stride, dilation)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            y = F.conv2d(xn, wn, stride=stride, padding=(ph[0], pw[0]),
                         dilation=dilation, groups=groups)
        else:
            y = F.conv2d(F.pad(xn, (pw[0], pw[1], ph[0], ph[1])), wn,
                         stride=stride, dilation=dilation, groups=groups)
    else:
        raise ValueError(f"unsupported padding {padding!r}; expected an "
                         f"int or 'SAME'")
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Bilinear sampling (the g(x, o) of Eq. 2)
# ---------------------------------------------------------------------------

def bilinear_sample(x: Tensor, pos_y: Tensor, pos_x: Tensor) -> Tensor:
    """Bilinearly sample ``x`` at float positions, zero outside the image.

    x: (N, H, W, C); pos_y, pos_x: (N, P) pixel coordinates.
    Returns (N, P, C) in x.dtype.  Corners accumulate in fp32 in the
    order (00, 01, 10, 11), as the JAX reference does.
    """
    n, h, w, c = x.shape
    pos_y = pos_y.float()
    pos_x = pos_x.float()
    y0f = torch.floor(pos_y)
    x0f = torch.floor(pos_x)
    ty = pos_y - y0f
    tx = pos_x - x0f
    y0 = y0f.long()
    x0 = x0f.long()

    flat = x.reshape(n, h * w, c)
    rows = torch.arange(n, device=x.device)[:, None]

    def corner(yc: Tensor, xc: Tensor, wgt: Tensor) -> Tensor:
        valid = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        idx = yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)
        v = flat[rows, idx]
        return v.float() * (wgt * valid.float())[..., None]

    out = corner(y0, x0, (1.0 - ty) * (1.0 - tx))
    out = out + corner(y0, x0 + 1, (1.0 - ty) * tx)
    out = out + corner(y0 + 1, x0, ty * (1.0 - tx))
    out = out + corner(y0 + 1, x0 + 1, ty * tx)
    return out.to(x.dtype)


def sample_patches(x: Tensor, offsets: Tensor, cfg: DCLConfig) -> Tensor:
    """g(x, o): gather bilinearly interpolated K*K patches.

    x: (N, H, W, C); offsets: (N, Ho, Wo, K*K, 2).
    Returns (N, Ho, Wo, K*K, C).
    """
    n, h, w, c = x.shape
    k, s, d, p = cfg.kernel_size, cfg.stride, cfg.dilation, cfg.pad
    ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * p - d * (k - 1) - 1) // s + 1
    if tuple(offsets.shape) != (n, ho, wo, k * k, 2):
        raise ValueError(f"offsets {tuple(offsets.shape)} != "
                         f"{(n, ho, wo, k * k, 2)}")
    dev = x.device
    oy = torch.arange(ho, device=dev) * s - p
    ox = torch.arange(wo, device=dev) * s - p
    ky, kx = torch.meshgrid(torch.arange(k, device=dev) * d,
                            torch.arange(k, device=dev) * d, indexing="ij")
    ky = ky.reshape(-1)
    kx = kx.reshape(-1)
    base_y = (oy[:, None, None] + ky[None, None, :]).expand(ho, wo, k * k)
    base_x = (ox[None, :, None] + kx[None, None, :]).expand(ho, wo, k * k)
    pos_y = base_y[None].float() + offsets[..., 0].float()
    pos_x = base_x[None].float() + offsets[..., 1].float()
    pn = ho * wo * k * k
    sampled = bilinear_sample(x, pos_y.reshape(n, pn), pos_x.reshape(n, pn))
    return sampled.reshape(n, ho, wo, k * k, c)


# ---------------------------------------------------------------------------
# Full deformable convolution layer (Eq. 1 + Eq. 2)
# ---------------------------------------------------------------------------

def receptive_field_dynamic(kernel_size: int, o_max: Tensor) -> Tensor:
    """Eq. 4 on a tensor: ``K + 2 ceil(o_max)``."""
    return kernel_size + 2 * torch.ceil(o_max)


def dcl_forward(params: dict[str, Tensor], x: Tensor, cfg: DCLConfig, *,
                return_stats: bool = True):
    """One DCL: offset conv -> clamp (optional) -> sample -> conv.

    Returns ``(y, stats)``, or ``y`` alone without ``return_stats``;
    ``stats['o_max']`` is the Eq. 3 statistic of the unclamped offsets
    and ``stats['rf_dynamic']`` its receptive field (Eq. 4), both
    tensors.
    """
    n = x.shape[0]
    k = cfg.kernel_size
    xc = x.to(cfg.dtype)
    o = conv2d(xc, params["w_offset"].to(cfg.dtype), stride=cfg.stride,
               dilation=cfg.dilation, padding=cfg.pad)
    if "b_offset" in params:
        o = o + params["b_offset"].to(cfg.dtype)
    ho, wo = o.shape[1], o.shape[2]
    offsets = o.reshape(n, ho, wo, k * k, 2)
    o_max = offset_abs_max(offsets)
    if cfg.offset_bound is not None:
        offsets = offsets.clamp(-cfg.offset_bound, cfg.offset_bound)
    patches = sample_patches(xc, offsets, cfg)
    w = params["w_deform"].to(cfg.dtype).reshape(k * k, x.shape[-1],
                                                 cfg.out_channels)
    y = torch.einsum("nhwkc,kcm->nhwm", patches.float(),
                     w.float()).to(cfg.dtype)
    if "b_deform" in params:
        y = y + params["b_deform"].to(cfg.dtype)
    if not return_stats:
        return y
    return y, {"o_max": o_max,
               "rf_dynamic": receptive_field_dynamic(k, o_max)}
