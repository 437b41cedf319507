"""Plain PyTorch reference of ResNet-DCN, the detector of arXiv:2006.05238
(Sec. 3.1, 4.1): ResNet-50 stages, GroupNorm, the last DCLs deformable
with offsets clamped to the Eq. 5 bound, a dense single-scale head.

It is the benchmark's oracle: it imports nothing of the program.  Layout
NHWC with HWIO weights, in the parameter layout the program takes, so
the weights the benchmark draws serve both sides.  Convolutions pad as
XLA's "SAME" does (a 3x3 stride-2 convolution on an even extent pads
one row and column at the high side only); a DCL pads K//2 on each side
and samples bilinearly in the global frame, zero outside the image.

Datapaths of a DCL: ``"fp32"``, and ``"int8"``, the chained int8 layer
the program serves: the input quantized onto its calibrated grid, the
offset conv over the integer input and integer weights (exact, in
float64), the integer plane sampled with fp32 bilinear weights, the
patches rounded back onto the grid, the contraction exact in float64,
rescaled, biased, and the output quantized onto its own grid.
``qmax`` sets the grid (127 for int8, 7 for int4).  Scale tables come
from ``calibrate``, absmax observers over calibration images through the
fp32 forward.

``train_steps`` runs SGD with momentum and weight decay over the
detection loss with the Eq. 5 term, ``(1 - lam) * task + lam * max_l
o_max^l``, in blocks of rows whose sums make the whole batch's loss.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from pb_data import tree_leaves

Tensor = torch.Tensor
EPS = 1e-12


# -- parameters -------------------------------------------------------------

def _conv(kh, kw, cin, cout):
    return ((kh, kw, cin, cout), "normal", 1.0 / math.sqrt(kh * kw * cin))


def _gn(c):
    return {"scale": ((c,), "ones", None), "bias": ((c,), "zeros", None)}


def is_dcn(cfg: dict, block_index: int) -> bool:
    return block_index >= sum(cfg["stage_sizes"]) - cfg["num_dcn"]


def param_specs(cfg: dict) -> dict:
    """``(shape, init, std)`` of every weight.  The offset conv's std
    gives offsets of standard deviation ``offset_std`` on a unit-variance
    ReLU'd input, so taps land between pixels and some beyond the bound;
    biases start at zero."""
    k = cfg["kernel_size"]
    k2 = k * k
    specs = {"stem": {"conv": _conv(7, 7, 3, cfg["stem_width"]),
                      "gn": _gn(cfg["stem_width"])}}
    cin, bi = cfg["stem_width"], 0
    for s, (blocks, width) in enumerate(zip(cfg["stage_sizes"],
                                            cfg["widths"])):
        for b in range(blocks):
            mid = width // 4
            d = {"conv1": _conv(1, 1, cin, mid), "gn1": _gn(mid),
                 "gn2": _gn(mid), "conv3": _conv(1, 1, mid, width),
                 "gn3": _gn(width)}
            if is_dcn(cfg, bi):
                d["dcl"] = {
                    "w_offset": ((k, k, mid, 2 * k2), "normal",
                                 cfg["offset_std"] / math.sqrt(k2 * mid / 2)),
                    "b_offset": ((2 * k2,), "zeros", None),
                    "w_deform": _conv(k, k, mid, mid),
                    "b_deform": ((mid,), "zeros", None)}
            else:
                d["conv2"] = _conv(3, 3, mid, mid)
            if b == 0 or cin != width:
                d["proj"] = _conv(1, 1, cin, width)
                d["gn_proj"] = _gn(width)
            specs[f"s{s}b{b}"] = d
            cin, bi = width, bi + 1
    hw = cfg["head_width"]
    specs["head"] = {"conv": _conv(3, 3, cin, hw), "gn": _gn(hw),
                     "cls": _conv(1, 1, hw, cfg["num_classes"] + 1),
                     "box": _conv(1, 1, hw, 4)}
    return specs


# -- layers -------------------------------------------------------------------

def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x: Tensor, w: Tensor, stride: int = 1, pad=None) -> Tensor:
    """NHWC x HWIO; ``pad`` None is "SAME", an int pads both sides."""
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    if pad is None:
        ph = _same_pads(x.shape[1], w.shape[0], stride)
        pw = _same_pads(x.shape[2], w.shape[1], stride)
        xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
        pad = 0
    return F.conv2d(xn, wn, stride=stride, padding=pad).permute(0, 2, 3, 1)


def group_norm(x: Tensor, p: dict, groups: int) -> Tensor:
    c = x.shape[-1]
    g = min(groups, c)
    while c % g:
        g -= 1
    y = F.group_norm(x.permute(0, 3, 1, 2), g, p["scale"], p["bias"],
                     eps=1e-5)
    return y.permute(0, 2, 3, 1)


def sample(x: Tensor, offsets: Tensor, *, k: int, stride: int,
           bound: float) -> Tensor:
    """Bilinear samples of x (N, H, W, C) at the K*K taps of each output
    position moved by the clamped offsets (N, Ho, Wo, 2*K*K; (dy, dx)
    a tap), zero outside the image: (N, Ho, Wo, K*K, C)."""
    n, h, w, c = x.shape
    _, ho, wo, _ = offsets.shape
    off = offsets.reshape(n, ho, wo, k * k, 2).clamp(-bound, bound)
    dev = x.device
    pad = k // 2
    ky, kx = torch.meshgrid(torch.arange(k, device=dev),
                            torch.arange(k, device=dev), indexing="ij")
    py = (torch.arange(ho, device=dev) * stride - pad)[:, None, None] \
        + ky.reshape(1, 1, -1) + off[..., 0]
    px = (torch.arange(wo, device=dev) * stride - pad)[None, :, None] \
        + kx.reshape(1, 1, -1) + off[..., 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    ty, tx = py - y0, px - x0
    flat = x.reshape(n, h * w, c)
    rows = torch.arange(n, device=dev)[:, None]
    out = 0
    for dy, dx, wgt in ((0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
                        (1, 0, ty * (1 - tx)), (1, 1, ty * tx)):
        yc, xc = (y0 + dy).long(), (x0 + dx).long()
        inside = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).reshape(n, -1)
        v = flat[rows, idx].reshape(n, ho, wo, k * k, c)
        out = out + v * (wgt * inside)[..., None]
    return out


def dcl_fp32(x: Tensor, p: dict, *, k: int, stride: int, bound: float):
    """One DCL in fp32: (y, o_max of the raw offsets)."""
    off = conv(x, p["w_offset"], stride, pad=k // 2) + p["b_offset"]
    patches = sample(x, off, k=k, stride=stride, bound=bound)
    w = p["w_deform"].reshape(k * k, x.shape[-1], -1)
    y = torch.einsum("nhwkc,kcm->nhwm", patches, w) + p["b_deform"]
    return y, off.abs().amax()


def _q(x: Tensor, scale: Tensor, qmax: float) -> Tensor:
    """Integer values of x on the symmetric grid of ``scale``."""
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


def dcl_int(x: Tensor, p: dict, s: dict, *, k: int, stride: int,
            bound: float, qmax: float) -> Tensor:
    """One chained integer DCL (module docstring), its output on the
    ``y_scale`` grid, dequantized."""
    k2 = k * k
    xq = _q(x, s["x_scale"], qmax)
    woq = _q(p["w_offset"], s["w_offset_scale"], qmax)
    wq = _q(p["w_deform"], s["w_scale"], qmax)
    acc = conv(xq.double(), woq.double(), stride, pad=k // 2)
    off = (acc * (s["x_scale"] * s["w_offset_scale"]).double()).float() \
        + p["b_offset"]
    patches = torch.round(sample(xq, off, k=k, stride=stride, bound=bound))
    acc = torch.einsum("nhwkc,kcm->nhwm", patches.double(),
                       wq.reshape(k2, x.shape[-1], -1).double())
    y = (acc * (s["x_scale"] * s["w_scale"]).double()).float() \
        + p["b_deform"]
    return _q(y, s["y_scale"], qmax) * s["y_scale"]


# -- the model ----------------------------------------------------------------

def forward(params: dict, cfg: dict, images: Tensor, *, dcl: str = "fp32",
            scales: dict | None = None, qmax: float = 127.0, tap=None):
    """images (N, H, W, 3) -> (cls, box, o_max of every fp32 DCL).
    ``tap(name, x)`` sees each DCL's input and, as ``name + "/out"``,
    its output."""
    g, k, bound = cfg["gn_groups"], cfg["kernel_size"], cfg["offset_bound"]
    x = conv(images, params["stem"]["conv"], 2, pad=3)
    x = F.relu(group_norm(x, params["stem"]["gn"], g))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1) \
        .permute(0, 2, 3, 1)
    o_maxes = []
    bi = 0
    for s, blocks in enumerate(cfg["stage_sizes"]):
        for b in range(blocks):
            name = f"s{s}b{b}"
            p = params[name]
            stride = 2 if (b == 0 and s > 0) else 1
            h = F.relu(group_norm(conv(x, p["conv1"]), p["gn1"], g))
            if is_dcn(cfg, bi):
                if tap is not None:
                    tap(name, h)
                if dcl == "fp32":
                    h, o_max = dcl_fp32(h, p["dcl"], k=k, stride=stride,
                                        bound=bound)
                    o_maxes.append(o_max)
                else:
                    h = dcl_int(h, p["dcl"], scales[name], k=k,
                                stride=stride, bound=bound, qmax=qmax)
                if tap is not None:
                    tap(name + "/out", h)
            else:
                h = conv(h, p["conv2"], stride)
            h = F.relu(group_norm(h, p["gn2"], g))
            h = group_norm(conv(h, p["conv3"]), p["gn3"], g)
            if "proj" in p:
                x = group_norm(conv(x, p["proj"], stride), p["gn_proj"], g)
            x = F.relu(x + h)
            bi += 1
    hd = params["head"]
    h = F.relu(group_norm(conv(x, hd["conv"]), hd["gn"], g))
    return conv(h, hd["cls"]), conv(h, hd["box"]), o_maxes


def _channel_absmax(w: Tensor) -> Tensor:
    return w.abs().reshape(-1, w.shape[-1]).amax(0)


@torch.no_grad()
def calibrate(params: dict, cfg: dict, images: Tensor,
              qmax: float = 127.0) -> dict:
    """Scale table of every DCL: absmax of its input and output over the
    calibration images through the fp32 forward, exact per-channel
    absmax of its weights, each over ``qmax``."""
    amax: dict[str, float] = {}

    def tap(name, x):
        amax[name] = max(amax.get(name, 0.0), float(x.abs().amax()))

    forward(params, cfg, images, tap=tap)
    table = {}
    for name in (n for n in amax if not n.endswith("/out")):
        d = params[name]["dcl"]
        table[name] = {
            "x_scale": torch.tensor(max(amax[name], EPS) / qmax,
                                    device=images.device),
            "y_scale": torch.tensor(max(amax[name + "/out"], EPS) / qmax,
                                    device=images.device),
            "w_scale": _channel_absmax(d["w_deform"]).clamp_min(EPS) / qmax,
            "w_offset_scale":
                _channel_absmax(d["w_offset"]).clamp_min(EPS) / qmax}
    return table


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuDNN convolutions and cuBLAS products."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- training -----------------------------------------------------------------

def _loss_sums(cls: Tensor, box: Tensor, t: dict) -> dict:
    obj = t["obj"]
    bce = F.binary_cross_entropy_with_logits(cls[..., 0], obj,
                                             reduction="sum")
    logp = F.log_softmax(cls[..., 1:], dim=-1)
    gold = logp.gather(-1, t["cls"].long()[..., None])[..., 0]
    return {"bce": bce, "ce": -(gold * obj).sum(),
            "l1": ((box - t["box"]).abs() * obj[..., None]).sum()}


def loss_and_grads(params: dict, cfg: dict, batch: dict, *, lam: float,
                   block: int):
    """The Eq. 5 loss of the whole batch and its gradient, in blocks of
    ``block`` rows: the detection terms are sums over blocks divided by
    the batch's cell and positive counts, and the penalty ``lam * max
    o_max`` enters the one block that holds the maximum (found first,
    without gradients)."""
    n = batch["images"].shape[0]
    cells = batch["obj"].numel()
    npos = batch["obj"].sum().clamp_min(1.0)
    spans = [(i, min(i + block, n)) for i in range(0, n, block)]
    rows = [{k: v[lo:hi] for k, v in batch.items()} for lo, hi in spans]
    with torch.no_grad():
        maxima = [torch.stack(forward(params, cfg, r["images"])[2]).amax()
                  for r in rows]
    top = int(torch.stack(maxima).argmax())
    flat = list(tree_leaves(params))
    grads = [torch.zeros_like(t) for _, t in flat]
    total = 0.0
    for i, r in enumerate(rows):
        cls, box, o_maxes = forward(params, cfg, r["images"])
        s = _loss_sums(cls, box, r)
        loss = (1 - lam) * (s["bce"] / cells + s["ce"] / npos
                            + 0.5 * s["l1"] / npos)
        if i == top and lam > 0:
            loss = loss + lam * torch.stack(o_maxes).amax()
        gs = torch.autograd.grad(loss, [t for _, t in flat])
        for a, b in zip(grads, gs):
            a.add_(b)
        total += float(loss.detach())
    return total, {path: g for (path, _), g in zip(flat, grads)}


def train_steps(params0: dict, cfg: dict, batches: list[dict], *,
                lam: float, lr: float, momentum: float,
                weight_decay: float, block: int):
    """SGD with momentum over ``batches`` from ``params0`` (left as it
    is): ``(losses, first gradient, params after the last step)``, the
    gradient and params as ``{path: tensor}``."""
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params0)
    flat = list(tree_leaves(params))
    mu = {path: torch.zeros_like(t) for path, t in flat}
    losses, first = [], None
    for batch in batches:
        loss, grads = loss_and_grads(params, cfg, batch, lam=lam,
                                     block=block)
        losses.append(loss)
        if first is None:
            first = grads
        with torch.no_grad():
            for path, p in flat:
                g = grads[path] + weight_decay * p
                mu[path].mul_(momentum).add_(g)
                p.sub_(lr * mu[path])
    return losses, first, {path: p.detach() for path, p in flat}


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
