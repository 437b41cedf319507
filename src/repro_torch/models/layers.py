"""Parameter declarations, the LM layers and the DCL layer (counterpart of
``repro.models.layers``): norms, rotary embeddings, GQA attention with its
dense, chunked and sliding-window paths and KV-cache decode, MLPs,
embeddings, logits and the chunked cross entropy; ``dcl_apply`` with its
fp32, ``qat``, ``int8`` and ``int8_chain`` datapaths, and the int8 ->
int8 chain helpers.

Params are nested dicts of tensors, declared once as a ``ParamDef`` tree
and materialised by ``init_tree`` from an explicit ``torch.Generator``.
Leaves are drawn in sorted-key order (the order JAX flattens dicts in);
the numbers differ from ``jax.random``, so parity tests convert JAX
params with ``repro_torch.convert.params_from_jax`` instead.

Under an active mesh (``distributed.sharding.use_rules(mesh=...)``) the
LM layers do by hand what the JAX layers' sharding hints ask GSPMD for:
attention per shard of query heads (``heads_tp_size``; KV heads split
with them, or replicated per query group where the model axis cannot
split them, ``effective_kv_heads``; query rows where it cannot split the
heads either, ``seq_parallel_attention``), the MLP per column block of
``ff``, the embedding, logits and cross entropy per block of the vocab,
and ``wo`` and the MLP's down projection row-parallel, their partial
sums added in shard order.  Each shard runs ``within`` its mesh
coordinates and reads its block of a placed param (``sharding.Placed``)
with the blocks of the 'embed' dimension gathered onto it (FSDP); a
layer with no per-shard path gathers its leaves whole.  What a shard
sends to the data shard's first position goes through ``sharding.move``
(``_sum_partials``: an all-reduce; pieces put side by side: an
all-gather), so ``count_crossings`` sees it.  The DCL's kernel calls shard over the active mesh
(``dcl_apply``'s ``shard_batch`` and ``shard_spatial``); inside a model's
data shard the batch is the shard's rows and is split no further.

Activations keep the JAX layouts: x (B, S, D), heads (B, S, H, Dh), GQA
queries (B, S, KV, G, Dh).  A JAX einsum with ``preferred_element_type=
float32`` is an fp32 einsum of the operands widened to fp32 (the products
of bf16 values are exact in fp32); any other einsum runs in the operands'
dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.deform_conv import (DCLConfig, conv2d, dcl_forward,
                                          offset_abs_max)
from repro_torch.distributed.sharding import (Placed, data_shard, gather,
                                              logical_spec, mesh_axes, move,
                                              position, shard_coords,
                                              shard_device, within)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import deform_conv_fused_ref
from repro_torch.quant.qat import (fake_quant_dcl_chain_reference,
                                   fake_quant_dcl_reference,
                                   qat_quantize_inputs)
from repro_torch.quant.qtypes import QTensor

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape, logical axes (one name or None a
    dimension, resolved to mesh axes by ``distributed.sharding``), init
    scheme and dtype."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed | uniform
    scale: float | None = None    # stddev / limit override (default: fan-in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef of shape {self.shape} needs one "
                             f"logical axis a dimension, got {self.axes}")


def _fan_in(shape: tuple[int, ...]) -> int:
    return int(shape[0]) if len(shape) <= 1 else int(math.prod(shape[:-1]))


def default_scale(d: ParamDef) -> float:
    """The stddev (``normal``, ``embed``) or limit (``uniform``) of a
    random init: ``d.scale``, else 1 for ``embed`` and 1/sqrt(fan-in)."""
    if d.scale is not None:
        return d.scale
    return 1.0 if d.init == "embed" else 1.0 / math.sqrt(_fan_in(d.shape))


def init_param(gen: torch.Generator, d: ParamDef) -> Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype)
    if d.init in ("normal", "embed"):
        return torch.randn(d.shape, generator=gen).mul_(default_scale(d)) \
            .to(d.dtype)
    if d.init == "uniform":
        lim = default_scale(d)
        return (torch.rand(d.shape, generator=gen) * (2 * lim) - lim) \
            .to(d.dtype)
    raise ValueError(f"unknown init {d.init!r}")


def init_tree(defs, gen: torch.Generator, device: torch.device) -> Any:
    """Materialise a ParamDef tree on ``device`` (drawn on the CPU, so a
    seed gives the same params on every device)."""
    if isinstance(defs, ParamDef):
        return init_param(gen, defs).to(device)
    return {k: init_tree(defs[k], gen, device) for k in sorted(defs)}


def meta_tree(defs) -> Any:
    """A ParamDef tree as ``meta`` tensors: shapes and dtypes, no
    storage (the dry run's parameters)."""
    if isinstance(defs, ParamDef):
        return torch.empty(defs.shape, dtype=defs.dtype, device="meta")
    return {k: meta_tree(defs[k]) for k in sorted(defs)}


def spec_tree(defs) -> Any:
    """A ParamDef tree as partition specs (``sharding.logical_spec`` of
    each leaf under the active rules and mesh)."""
    if isinstance(defs, ParamDef):
        return logical_spec(defs.shape, defs.axes)
    return {k: spec_tree(defs[k]) for k in sorted(defs)}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, *, eps: float = 1e-6) -> Tensor:
    """RMS norm with the JAX package's ``(1 + scale)`` gain (zero-init
    scale), not ``torch.nn.RMSNorm``'s ``scale``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor | None = None,
               *, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm_def(d_model: int, kind: str) -> dict[str, ParamDef]:
    if kind == "rms":
        return {"scale": ParamDef((d_model,), (None,), init="zeros")}
    return {"scale": ParamDef((d_model,), (None,), init="ones"),
            "bias": ParamDef((d_model,), (None,), init="zeros")}


def apply_norm(params: Mapping[str, Tensor], x: Tensor, kind: str) -> Tensor:
    params = {k: gather(v, device=x.device) for k, v in params.items()}
    if kind == "rms":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params.get("bias"))


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split / llama convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, *, theta: float = 10000.0,
               fraction: float = 1.0, device=None) -> Tensor:
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / torch.pow(theta, exps)        # theta taken as fp32


def apply_rope(x: Tensor, positions: Tensor, *, theta: float = 10000.0,
               fraction: float = 1.0) -> Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integer.  The first
    ``fraction`` of each head rotates (halves paired), the rest passes."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta=theta, fraction=fraction, device=x.device)
    rot = inv.shape[0] * 2
    ang = positions.float()[..., None] * inv             # (B, S, rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :rot].float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), x[..., rot:]], -1) \
        if rot < dh else out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, optional sliding window, optional KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    use_rope: bool = True
    qkv_bias: bool = False
    out_bias: bool = False
    window: int | None = None          # sliding-window size (None = full)
    softcap: float | None = None       # grok-style tanh soft-capping
    qk_norm: bool = False              # per-head RMS on q/k (stability)

    @property
    def group(self) -> int:
        return self.n_heads // self.kv_heads


def heads_tp_size() -> int:
    """Size of the mesh axes the 'heads' logical axis maps to under the
    active rules (1 off-mesh), as JAX's."""
    return mesh_axes("heads")[2]


def effective_kv_heads(cfg: AttnConfig) -> int:
    """KV heads carried through attention and the KV cache, as JAX's:
    where the tensor-parallel axis cannot split ``kv_heads`` but splits
    ``n_heads``, KV is replicated per query group (Megatron's fix) and
    the flat head dimension splits; otherwise ``kv_heads``.  A function of
    (cfg, active mesh), so the cache layout and every mode agree."""
    tp = heads_tp_size()
    if tp > 1 and cfg.kv_heads % tp != 0 and cfg.n_heads % tp == 0:
        return cfg.n_heads
    return cfg.kv_heads


def seq_parallel_attention(cfg: AttnConfig) -> bool:
    """Neither KV nor query heads split (musicgen's 24 heads on a 16-way
    axis): each model shard takes a block of query rows instead."""
    tp = heads_tp_size()
    return tp > 1 and cfg.n_heads % tp != 0


def _w(p, x: Tensor, dtype: torch.dtype | None = None) -> Tensor:
    """Param ``p`` whole on ``x``'s device in ``dtype`` (default
    ``x.dtype``): a placed param's blocks gathered (FSDP at rest)."""
    return gather(p, device=x.device, dtype=dtype or x.dtype)


def _part(p, dim: int, lo: int, size: int, device,
          dtype: torch.dtype | None = None) -> Tensor:
    """Rows ``[lo, lo + size)`` of ``p`` along ``dim`` on ``device`` in
    ``dtype``: the block there when ``p`` is placed in blocks of that
    size along ``dim`` (its other split dimensions gathered, FSDP), else
    a slice of ``p`` gathered whole."""
    if isinstance(p, Placed) and p.grid[dim] > 1 \
            and p.block_shape()[dim] == size and lo % size == 0:
        index = [0] * p.ndim
        index[dim] = lo // size
        at = {a: c for a, c in p.coords(index).items() if a in p.axes(dim)}
        return gather(p, at=at, device=device, dtype=dtype)
    w = gather(p, device=device, dtype=dtype)
    return w if lo == 0 and size == w.shape[dim] else w.narrow(dim, lo, size)


def _row_parallel(eq: str, a: Tensor, w: Tensor) -> Tensor:
    """One shard's partial product of a row-parallel projection, in fp32:
    the products of the operands (exact in fp32) summed in fp32 and not
    rounded, so the shards' sum rounds once to the activation dtype, as
    the unsharded product does."""
    return torch.einsum(eq, a.float(), w.float())


def _to_here(t: Tensor, coords: Mapping[str, int], device,
             kind: str) -> Tensor:
    """A shard's tensor (the shard at ``coords``) moved to the current
    position on ``device``: a ``kind`` crossing (``sharding.move``)."""
    return move(t, device, position(coords), position(), kind)


def _sum_partials(parts: Sequence[tuple[Mapping[str, int], Tensor]],
                  dtype: torch.dtype, device) -> Tensor:
    """Row-parallel partial sums, ``(coords, partial)`` of each shard,
    moved to the current position on ``device`` (an all-reduce) and
    added in shard order, in fp32."""
    moved = [_to_here(t, c, device, "all-reduce") for c, t in parts]
    if len(moved) == 1:
        return moved[0]
    acc = moved[0].float()
    for t in moved[1:]:
        acc = acc + t.float()
    return acc.to(dtype)


@dataclasses.dataclass(frozen=True)
class _HeadShard:
    """One model shard of attention: query heads ``[q_lo, q_lo + nq)``,
    the KV heads ``[kv_lo, kv_lo + nkv)`` it projects, and, where KV is
    replicated per query group, the projected KV head of each of its
    query heads (``rep``; KV head ``h // group`` of query head ``h``, as
    ``repeat_interleave``)."""
    coords: dict
    q_lo: int
    nq: int
    kv_lo: int
    nkv: int
    rep: tuple[int, ...] | None

    @property
    def cache_slice(self) -> slice:
        """This shard's heads in the ``effective_kv_heads`` layout."""
        lo = self.kv_lo if self.rep is None else self.q_lo
        return slice(lo, lo + (self.nkv if self.rep is None else self.nq))


def _head_shards(cfg: AttnConfig) -> list[_HeadShard] | None:
    """The query-head shards under the active mesh, or None (off-mesh,
    one shard, or sequence-parallel attention)."""
    _, axes, n = mesh_axes("heads")
    if n == 1 or cfg.n_heads % n:
        return None
    hq, g = cfg.n_heads // n, cfg.group
    replicate = effective_kv_heads(cfg) != cfg.kv_heads
    out = []
    for j in range(n):
        q_lo = j * hq
        if replicate:
            kv_lo = q_lo // g
            nkv = (q_lo + hq - 1) // g + 1 - kv_lo
            rep = tuple(h // g - kv_lo for h in range(q_lo, q_lo + hq))
        else:
            nkv = cfg.kv_heads // n
            kv_lo, rep = j * nkv, None
        out.append(_HeadShard(shard_coords(axes, j), q_lo, hq, kv_lo, nkv,
                              rep))
    return out


def _shard_attn_params(params, cfg: AttnConfig, sh: _HeadShard, device,
                       dtype: torch.dtype) -> dict:
    """A shard's attention params on ``device``: its blocks of the
    query, KV and output projections (and their biases) in ``dtype``, the
    q/k norm scales whole; ``bo`` stays out (added once, after the
    partial sums)."""
    kv = (sh.kv_lo, sh.nkv)
    loc = {"wq": _part(params["wq"], 1, sh.q_lo, sh.nq, device, dtype),
           "wk": _part(params["wk"], 1, *kv, device, dtype),
           "wv": _part(params["wv"], 1, *kv, device, dtype),
           "wo": _part(params["wo"], 0, sh.q_lo, sh.nq, device, dtype)}
    if cfg.qkv_bias:
        loc["bq"] = _part(params["bq"], 0, sh.q_lo, sh.nq, device, dtype)
        loc["bk"] = _part(params["bk"], 0, *kv, device, dtype)
        loc["bv"] = _part(params["bv"], 0, *kv, device, dtype)
    if cfg.qk_norm:
        loc["q_norm"] = gather(params["q_norm"], device=device)
        loc["k_norm"] = gather(params["k_norm"], device=device)
    return loc


def _shard_qkv(params, x: Tensor, cfg: AttnConfig, positions: Tensor,
               sh: _HeadShard):
    """(device, its params, q, k, v) of one head shard; k and v carry the
    shard's heads of the ``effective_kv_heads`` layout."""
    dev = shard_device(sh.coords)
    loc = _shard_attn_params(params, cfg, sh, dev, x.dtype)
    q, k, v = _qkv(loc, x.to(dev), cfg, positions.to(dev))
    if sh.rep is not None:
        idx = torch.tensor(sh.rep, device=dev)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return dev, loc, q, k, v


def attn_def(cfg: AttnConfig) -> dict[str, ParamDef]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    defs: dict[str, ParamDef] = {
        "wq": ParamDef((d, h, dh), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, dh), ("embed", "kv", None)),
        "wv": ParamDef((d, kv, dh), ("embed", "kv", None)),
        "wo": ParamDef((h, dh, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, dh), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((kv, dh), ("kv", None), init="zeros")
        defs["bv"] = ParamDef((kv, dh), ("kv", None), init="zeros")
    if cfg.out_bias:
        defs["bo"] = ParamDef((d,), (None,), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((dh,), (None,), init="zeros")
        defs["k_norm"] = ParamDef((dh,), (None,), init="zeros")
    return defs


def _qkv(params, x: Tensor, cfg: AttnConfig, positions: Tensor):
    """(q, k, v) of x: (B, S, H, Dh) and (B, S, KV, Dh), the heads those
    of ``params`` (a shard's, or all)."""
    q = torch.einsum("bsd,dhk->bshk", x, _w(params["wq"], x))
    k = torch.einsum("bsd,dhk->bshk", x, _w(params["wk"], x))
    v = torch.einsum("bsd,dhk->bshk", x, _w(params["wv"], x))
    if cfg.qkv_bias:
        q = q + _w(params["bq"], x)
        k = k + _w(params["bk"], x)
        v = v + _w(params["bv"], x)
    if cfg.qk_norm:
        q = rms_norm(q, gather(params["q_norm"], device=x.device))
        k = rms_norm(k, gather(params["k_norm"], device=x.device))
    if cfg.use_rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
    return q, k, v


def _scores_mask(q_pos: Tensor, k_pos: Tensor, window: int | None) -> Tensor:
    """(.., Sq, Sk) boolean keep-mask: causal (+ sliding window)."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
          softcap: float | None) -> Tensor:
    """q: (B,Sq,KV,G,Dh); k/v: (B,Sk,KV,Dh); mask: (B,Sq,Sk).  Scores and
    softmax in fp32, the probabilities cast to v's dtype for the PV
    product."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    scores = scores / math.sqrt(dh)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _sdpa_chunked(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                  k_pos: Tensor, window: int | None, softcap: float | None,
                  block: int = 1024) -> Tensor:
    """Online-softmax (flash-style) attention over KV blocks: per step only
    (B, KV, G, Sq, block) scores live.  Exact (same math as ``_sdpa``).
    q: (B,Sq,KV,G,Dh); k,v: (B,Sk,KV,Dh); q_pos: (B,Sq); k_pos: (B,Sk)."""
    b, sq, kv, g, dh = q.shape
    sk = k.shape[1]
    pad = (-sk) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=torch.iinfo(torch.int32).max)
    qf = q.float()
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((b, kv, g, sq), -math.inf, device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    acc = torch.zeros((b, kv, g, sq, dh), device=q.device)
    for k0 in range(0, sk + pad, block):
        kc, vc = k[:, k0:k0 + block], v[:, k0:k0 + block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.float()) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        keep = _scores_mask(q_pos, k_pos[:, k0:k0 + block], window)
        s = torch.where(keep[:, None, None], s, -1e30)
        m2 = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vc.float())
        m = m2
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(3, 1).to(q.dtype)                 # (B,Sq,KV,G,Dh)


def _sdpa_window_blocks(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                        k_pos: Tensor, window: int,
                        softcap: float | None) -> Tensor:
    """Sliding-window attention in diagonal blocks of width ``window``:
    query block i attends KV blocks (i-1, i) only.  Exact for causal
    windows."""
    b, sq, kv, g, dh = q.shape
    if k.shape[1] != sq:
        raise ValueError("the window-block path expects self-attention")
    w = window
    pad = (-sq) % w
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
        k_pos = F.pad(k_pos, (0, pad), value=torch.iinfo(torch.int32).max)
    outs = []
    for i in range(q.shape[1] // w):
        cur, prev = slice(i * w, (i + 1) * w), slice((i - 1) * w, i * w)
        if i == 0:       # the block before the first: zeros, sentinel keys
            kcat = torch.cat([torch.zeros_like(k[:, cur]), k[:, cur]], 1)
            vcat = torch.cat([torch.zeros_like(v[:, cur]), v[:, cur]], 1)
            kpcat = torch.cat([torch.full_like(
                k_pos[:, cur], torch.iinfo(torch.int32).max), k_pos[:, cur]],
                1)
        else:
            kcat = torch.cat([k[:, prev], k[:, cur]], 1)
            vcat = torch.cat([v[:, prev], v[:, cur]], 1)
            kpcat = torch.cat([k_pos[:, prev], k_pos[:, cur]], 1)
        mask = _scores_mask(q_pos[:, cur], kpcat, window)
        outs.append(_sdpa(q[:, cur], kcat, vcat, mask, softcap))
    return torch.cat(outs, 1)[:, :sq]


DENSE_ATTN_MAX_KV = 4096


def attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
              *, window: int | None, softcap: float | None,
              impl: str = "auto") -> Tensor:
    """Dispatch between dense, chunked (flash-style) and window-block
    attention.  All paths are exact; the choice trades memory and work."""
    sk = k.shape[1]
    if impl == "auto":
        if window is not None and sk > 2 * window and q.shape[1] == sk:
            impl = "window"
        elif sk > DENSE_ATTN_MAX_KV:
            impl = "chunked"
        else:
            impl = "dense"
    if impl == "window":
        return _sdpa_window_blocks(q, k, v, q_pos, k_pos, window, softcap)
    if impl == "chunked":
        return _sdpa_chunked(q, k, v, q_pos, k_pos, window, softcap)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _sdpa(q, k, v, _scores_mask(q_pos, k_pos, window), softcap)


def attn_apply(params, x: Tensor, cfg: AttnConfig, *, positions: Tensor,
               mask: Tensor | None = None) -> Tensor:
    """Full-sequence attention (training / prefill).  x: (B, S, D);
    positions: (B, S); ``mask`` overrides the causal(+window) mask; the
    scores are dense."""
    if mask is None:
        mask = _scores_mask(positions, positions, cfg.window)
    return attn_forward(params, x, cfg, positions=positions, mask=mask)[0]


def _attend(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
            cfg: AttnConfig, mask: Tensor | None) -> Tensor:
    """q (B, Sq, H, Dh) grouped over k's heads -> (B, Sq, H, Dh): under
    ``mask`` densely, else through ``attention``'s dispatch."""
    b, sq, h, dh = q.shape
    ekv = k.shape[2]
    qg = q.reshape(b, sq, ekv, h // ekv, dh)
    if mask is not None:
        o = _sdpa(qg, k, v, mask, cfg.softcap)
    else:
        o = attention(qg, k, v, q_pos, k_pos, window=cfg.window,
                      softcap=cfg.softcap)
    return o.reshape(b, sq, h, dh)


def attn_forward(params, x: Tensor, cfg: AttnConfig, *, positions: Tensor,
                 mask: Tensor | None = None
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Full-sequence attention -> (y, k, v), k and v (B, S, KV, Dh) in the
    ``effective_kv_heads`` layout (the prefill cache's).  Under the active
    mesh: per shard of query heads (``wo`` row-parallel), or per block of
    query rows with all of K/V when the heads do not split."""
    shards = _head_shards(cfg)
    if shards is not None:
        home = x.device
        parts, ks, vs = [], [], []
        for sh in shards:
            with within(sh.coords):
                dev, loc, q, k, v = _shard_qkv(params, x, cfg, positions, sh)
                pos = positions.to(dev)
                o = _attend(q, k, v, pos, pos, cfg,
                            None if mask is None else mask.to(dev))
                parts.append((sh.coords, _row_parallel(
                    "bshk,hkd->bsd", o, loc["wo"])))
            # The cache's K/V heads stay with their shard under GSPMD.
            ks.append(k.to(home))
            vs.append(v.to(home))
        y = _sum_partials(parts, x.dtype, home)
        k, v = torch.cat(ks, 2), torch.cat(vs, 2)
    else:
        q, k, v = _qkv(params, x, cfg, positions)
        if seq_parallel_attention(cfg):
            y = _attn_seq_parallel(params, q, k, v, x, cfg, positions, mask)
        else:
            o = _attend(q, k, v, positions, positions, cfg, mask)
            y = torch.einsum("bshk,hkd->bsd", o, _w(params["wo"], x))
    if cfg.out_bias:
        y = y + _w(params["bo"], x)
    return y, k, v


def _attn_seq_parallel(params, q: Tensor, k: Tensor, v: Tensor, x: Tensor,
                       cfg: AttnConfig, positions: Tensor,
                       mask: Tensor | None) -> Tensor:
    """Sequence-parallel attention: model shard j takes the j-th block of
    query rows (their global positions) with all of K/V, and the output
    projection of its rows; the rows meet in order."""
    _, axes, n = mesh_axes("heads")
    home, s = x.device, q.shape[1]
    rows = []
    for j in range(n):
        # torch.tensor_split's blocks: the first s % n one row longer.
        lo = j * (s // n) + min(j, s % n)
        hi = lo + s // n + (j < s % n)
        if hi == lo:
            continue
        coords = shard_coords(axes, j)
        with within(coords):
            dev = shard_device()
            o = _attend(q[:, lo:hi].to(dev), k.to(dev), v.to(dev),
                        positions[:, lo:hi].to(dev), positions.to(dev), cfg,
                        None if mask is None else mask[:, lo:hi].to(dev))
            wo = gather(params["wo"], device=dev, dtype=x.dtype)
            row = torch.einsum("bshk,hkd->bsd", o, wo)
        rows.append(_to_here(row, coords, home, "all-gather"))
    return torch.cat(rows, 1)


def _decode_attend(q: Tensor, k: Tensor, v: Tensor, k_cache: Tensor,
                   v_cache: Tensor, cfg: AttnConfig, pos: Tensor):
    """One token's attention over its cache: the new K/V written at
    ``pos``'s slot of copies of the caches.  q (B, 1, H, Dh); k, v
    (B, 1, KV, Dh); caches (B, S_cache, KV, Dh).  Returns (o (B, 1, H,
    Dh), new k cache, new v cache)."""
    b = q.shape[0]
    s_cache = k_cache.shape[1]
    # A position past a full (non-ring) cache writes the last slot, as
    # JAX's dynamic_update_slice clamps its start.
    slot = pos % s_cache if cfg.window is not None \
        else pos.clamp(max=s_cache - 1)
    rows = torch.arange(b, device=q.device)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    # Absolute position of each cache slot (ring-aware).
    idx = torch.arange(s_cache, device=q.device)[None, :]
    if cfg.window is not None:
        wraps = pos[:, None] // s_cache
        k_pos = torch.where(idx <= (pos[:, None] % s_cache),
                            wraps * s_cache + idx,
                            (wraps - 1) * s_cache + idx)
    else:
        k_pos = idx
    # A slot the ring's first pass has not reached yet holds a negative
    # position: it is no key, though it may lie inside the window.  (The
    # JAX package's decode keeps such slots, so before its ring fills a
    # windowed layer attends to zero keys and its decode leaves its own
    # forward: ROADMAP Queue C.)
    mask = _scores_mask(pos[:, None], k_pos, cfg.window) \
        & (k_pos >= 0)[..., None, :]
    o = _attend(q, k_cache.to(q.dtype), v_cache.to(q.dtype), None, None,
                cfg, mask)
    return o, k_cache, v_cache


def attn_decode(params, x: Tensor, cfg: AttnConfig, *, cache: dict,
                pos: Tensor) -> tuple[Tensor, dict]:
    """Single-token decode with a KV cache.

    x: (B, 1, D); cache: {'k','v': (B, S_cache, KV, Dh)} in the
    ``effective_kv_heads`` layout; pos: (B,) absolute positions of the
    new token.  For windowed attention the cache is a ring buffer of size
    >= window.  Returns (y, new cache); the cache passed in is not
    changed.  Under the active mesh each head shard reads and writes its
    heads of the cache (one query row has no rows to split: a
    sequence-parallel layer runs whole).
    """
    ekv = effective_kv_heads(cfg)
    if cache["k"].shape[2] != ekv:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} KV heads, "
                         f"the layer {ekv}")
    shards = _head_shards(cfg)
    if shards is None:
        q, k, v = _qkv(params, x, cfg, pos[:, None])
        o, k_cache, v_cache = _decode_attend(q, k, v, cache["k"],
                                             cache["v"], cfg, pos)
        y = torch.einsum("bshk,hkd->bsd", o, _w(params["wo"], x))
    else:
        home = x.device
        parts, kcs, vcs = [], [], []
        for sh in shards:
            with within(sh.coords):
                dev, loc, q, k, v = _shard_qkv(params, x, cfg, pos[:, None],
                                               sh)
                cs = sh.cache_slice
                o, kc, vc = _decode_attend(
                    q, k, v, cache["k"][:, :, cs].to(dev),
                    cache["v"][:, :, cs].to(dev), cfg, pos.to(dev))
                parts.append((sh.coords, _row_parallel(
                    "bshk,hkd->bsd", o, loc["wo"])))
            kcs.append(kc.to(home))
            vcs.append(vc.to(home))
        y = _sum_partials(parts, x.dtype, home)
        k_cache, v_cache = torch.cat(kcs, 2), torch.cat(vcs, 2)
    if cfg.out_bias:
        y = y + _w(params["bo"], x)
    return y, {"k": k_cache, "v": v_cache}


def attn_cache_def(cfg: AttnConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> dict[str, ParamDef]:
    s = min(max_len, cfg.window) if cfg.window is not None else max_len
    ekv = effective_kv_heads(cfg)
    return {
        "k": ParamDef((batch, s, ekv, cfg.head_dim),
                      ("batch", None, "kv", None), init="zeros", dtype=dtype),
        "v": ParamDef((batch, s, ekv, cfg.head_dim),
                      ("batch", None, "kv", None), init="zeros", dtype=dtype),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation; F.gelu does not.
    return F.gelu(x, approximate="tanh")


ACTS: dict[str, Callable[[Tensor], Tensor]] = {
    "gelu": _gelu,
    "silu": F.silu,
    "relu": F.relu,
    "relu2": lambda x: F.relu(x).square(),
}


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    kind: str = "swiglu"          # swiglu | geglu | gelu | relu2
    bias: bool = False


def mlp_def(cfg: MLPConfig) -> dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"w_out": ParamDef((f, d), ("ff", "embed"))}
    if cfg.kind in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, f), ("embed", "ff"))
        defs["w_up"] = ParamDef((d, f), ("embed", "ff"))
    else:
        defs["w_in"] = ParamDef((d, f), ("embed", "ff"))
    if cfg.bias:
        defs["b_in"] = ParamDef((f,), ("ff",), init="zeros")
        defs["b_out"] = ParamDef((d,), (None,), init="zeros")
    return defs


def _mlp_body(params, x: Tensor, cfg: MLPConfig, *,
              partial: bool = False) -> Tensor:
    """The MLP without its output bias, on the columns of ``ff`` that
    ``params`` hold (a shard's, or all); a shard's ``partial`` down
    projection in fp32 (``_row_parallel``)."""
    if cfg.kind in ("swiglu", "geglu"):
        act = F.silu if cfg.kind == "swiglu" else _gelu
        g = x @ _w(params["w_gate"], x)
        u = x @ _w(params["w_up"], x)
        if cfg.bias:
            g = g + _w(params["b_in"], x)
        h = act(g) * u
    else:
        act = ACTS["gelu" if cfg.kind == "gelu" else "relu2"]
        h = x @ _w(params["w_in"], x)
        if cfg.bias:
            h = h + _w(params["b_in"], x)
        h = act(h)
    if partial:
        return _row_parallel("bsf,fd->bsd", h, _w(params["w_out"], x))
    return h @ _w(params["w_out"], x)


# The dimension of each MLP leaf that 'ff' names.
_FF_DIM = {"w_gate": 1, "w_up": 1, "w_in": 1, "b_in": 0, "w_out": 0}


def mlp_apply(params, x: Tensor, cfg: MLPConfig) -> Tensor:
    """The MLP; under the active mesh per column block of ``ff`` (gate,
    up and in weights split by columns, down weights by rows, the partial
    sums added in shard order)."""
    _, axes, n = mesh_axes("ff")
    if n > 1 and cfg.d_ff % n == 0:
        f, home = cfg.d_ff // n, x.device
        parts = []
        for j in range(n):
            coords = shard_coords(axes, j)
            with within(coords):
                dev = shard_device()
                loc = {k: _part(params[k], dim, j * f, f, dev, x.dtype)
                       for k, dim in _FF_DIM.items() if k in params}
                parts.append((coords, _mlp_body(loc, x.to(dev), cfg,
                                                partial=True)))
        y = _sum_partials(parts, x.dtype, home)
    else:
        y = _mlp_body(params, x, cfg)
    if cfg.bias:
        y = y + _w(params["b_out"], x)
    return y


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_def(vocab: int, d_model: int) -> dict[str, ParamDef]:
    return {"embedding": ParamDef((vocab, d_model), ("vocab", None),
                                  init="embed", scale=0.02)}


def _vocab_shards(vocab: int) -> list[tuple[int, int, dict]] | None:
    """``(lo, size, coords)`` of each vocab block under the active mesh,
    or None where the vocab does not split."""
    _, axes, n = mesh_axes("vocab")
    if n == 1 or vocab % n:
        return None
    vn = vocab // n
    return [(j * vn, vn, shard_coords(axes, j)) for j in range(n)]


def embed_rows(emb, ids: Tensor, dtype: torch.dtype) -> Tensor:
    """Rows ``ids`` of the (V, D) table ``emb``, cast to ``dtype``.  Under
    the active mesh vocab-parallel: each vocab block looks up the ids in
    its range (the others masked to zero) and the blocks' rows are summed
    in order, which is exact (one term is not zero)."""
    shards = _vocab_shards(emb.shape[0])
    if shards is None:
        # Gather, then cast: the rows the JAX package casts before its take.
        return gather(emb, device=ids.device)[ids].to(dtype)
    out = None
    for lo, vn, coords in shards:
        with within(coords):
            dev = shard_device()
            rel = ids.to(dev) - lo
            inside = (rel >= 0) & (rel < vn)
            rows = _part(emb, 0, lo, vn, dev)[rel.clamp(0, vn - 1)] \
                .to(dtype)
            rows = torch.where(inside[..., None], rows,
                               torch.zeros((), dtype=dtype, device=dev))
        rows = _to_here(rows, coords, ids.device, "all-reduce")
        out = rows if out is None else out + rows
    return out


def embed_apply(params, tokens: Tensor,
                dtype: torch.dtype = torch.bfloat16) -> Tensor:
    return embed_rows(params["embedding"], tokens, dtype)


def _softcap(x: Tensor, cap: float | None) -> Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def vocab_logits(x: Tensor, w, *, tied: bool) -> Tensor:
    """fp32 ``x @ w`` over the vocab, ``w`` (V, D) if ``tied`` else (D, V)
    rounded to ``x.dtype`` first; under the active mesh per vocab block,
    the blocks' logits concatenated in order."""
    vdim = 0 if tied else 1
    shards = _vocab_shards(w.shape[vdim])
    if shards is None:
        wt = _w(w, x).float()
        return x.float() @ (wt.T if tied else wt)
    parts = []
    for lo, vn, coords in shards:
        with within(coords):
            dev = shard_device()
            wt = _part(w, vdim, lo, vn, dev, x.dtype).float()
            part = x.to(dev).float() @ (wt.T if tied else wt)
        parts.append(_to_here(part, coords, x.device, "all-gather"))
    return torch.cat(parts, -1)


def logits_apply(params, x: Tensor, *, softcap: float | None = None
                 ) -> Tensor:
    """Project to vocab with the (possibly tied) embedding matrix; fp32
    logits."""
    return _softcap(vocab_logits(x, params["embedding"], tied=True), softcap)


def unembed_def(vocab: int, d_model: int) -> dict[str, ParamDef]:
    return {"unembedding": ParamDef((d_model, vocab), (None, "vocab"))}


def unembed_apply(params, x: Tensor, *, softcap: float | None = None
                  ) -> Tensor:
    return _softcap(vocab_logits(x, params["unembedding"], tied=False),
                    softcap)


def chunked_cross_entropy(x: Tensor, w, targets: Tensor,
                          mask: Tensor | None = None, *, tied: bool,
                          logit_scale: float = 1.0,
                          softcap: float | None = None,
                          chunk: int = 1024) -> Tensor:
    """Mean CE without materialising (B, S, V) logits.

    A loop over token chunks: each computes a (B, chunk, V) logit block,
    reduces it to per-token NLL and discards it.  Each chunk is
    checkpointed, so the backward recomputes its block instead of saving
    it (JAX's ``jax.checkpoint`` scan body).  The product is
    ``logits_apply``'s: ``w`` rounded to the activation dtype, then
    multiplied in fp32.

    x: (B, S, D) final hidden; w: embedding (V, D) if tied else (D, V).
    """
    nll, m = ce_sums(x, w, targets, mask, tied=tied,
                     logit_scale=logit_scale, softcap=softcap, chunk=chunk)
    return nll / torch.clamp_min(m, 1.0)


def ce_sums(x: Tensor, w, targets: Tensor, mask: Tensor | None = None, *,
            tied: bool, logit_scale: float = 1.0,
            softcap: float | None = None, chunk: int = 1024
            ) -> tuple[Tensor, Tensor]:
    """``chunked_cross_entropy``'s two sums: the masked NLL and the mask
    (data shards add theirs before the one division).  Under the active
    mesh vocab-parallel: each vocab block's logits give its max, its sum
    of exponentials and, where it holds the target, the target's logit;
    the blocks combine in order into the log-sum-exp (the softcap and
    logit scale applied per block, before the combine)."""
    b, s, _ = x.shape
    pad = (-s) % chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    vdim = 0 if tied else 1
    shards = _vocab_shards(w.shape[vdim])
    if shards is None:
        wt = _w(w, x).float()
        wts, los = [wt.T if tied else wt], [0]
    else:
        wts = []
        for lo, vn, coords in shards:
            with within(coords):
                wt = _part(w, vdim, lo, vn, shard_device(), x.dtype).float()
            wts.append(wt.T if tied else wt)
        los = [lo for lo, _, _ in shards]
        here = [position(c) for _, _, c in shards]
        home = position()

    def logits_of(xb: Tensor, wt: Tensor) -> Tensor:
        return _softcap((xb.to(wt.device).float() @ wt) * logit_scale,
                        softcap)

    def body(xb: Tensor, tb: Tensor, mb: Tensor, *wts: Tensor):
        if len(wts) == 1:
            logits = logits_of(xb, wts[0])
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, tb[..., None].long())[..., 0]
        else:
            # The maxima only shift the exponentials: no gradient.
            ms, ss, golds = [], [], []

            def back(t, at):
                # A vocab block's statistic to the combine: an all-reduce.
                return move(t, xb.device, at, home, "all-reduce")
            for lo, wt, at in zip(los, wts, here):
                lg = logits_of(xb, wt)
                m = lg.amax(-1).detach()
                ms.append(back(m, at))
                ss.append(back(torch.exp(lg - m[..., None]).sum(-1), at))
                rel = tb.to(wt.device).long() - lo
                inside = (rel >= 0) & (rel < wt.shape[-1])
                g = lg.gather(-1, rel.clamp(0, wt.shape[-1] - 1)[..., None])
                golds.append(back(torch.where(inside, g[..., 0], 0.0), at))
            top = ms[0]
            for m in ms[1:]:
                top = torch.maximum(top, m)
            total = ss[0] * torch.exp(ms[0] - top)
            gold = golds[0]
            for m, s_, g in zip(ms[1:], ss[1:], golds[1:]):
                total = total + s_ * torch.exp(m - top)
                gold = gold + g
            lse = top + torch.log(total)
        mb = mb.float()
        return torch.sum((lse - gold) * mb), torch.sum(mb)

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    m = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s + pad, chunk):
        part = (x[:, i:i + chunk], targets[:, i:i + chunk],
                mask[:, i:i + chunk], *wts)
        if torch.is_grad_enabled():
            # The body draws no random numbers, so a dry run on meta
            # keeps no RNG snapshot.
            # No early stop: the recomputation runs the whole body, so
            # the vocab combine crosses again (``count_crossings``).
            n_c, m_c = torch.utils.checkpoint.checkpoint(
                body, *part, use_reentrant=False, early_stop=False,
                preserve_rng_state=x.device.type != "meta")
        else:
            n_c, m_c = body(*part)
        nll, m = nll + n_c, m + m_c
    return nll, m


def cross_entropy(logits: Tensor, targets: Tensor,
                  mask: Tensor | None = None) -> Tensor:
    """Mean CE over (possibly masked) targets; logits taken in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)


# ---------------------------------------------------------------------------
# Deformable convolution layer (shared conv-backbone primitive)
# ---------------------------------------------------------------------------

def dcl_def(cin: int, cout: int, k: int = 3) -> dict[str, ParamDef]:
    """One DCL: offset conv (zero-init — offsets start on the regular
    grid) and the deform conv weights."""
    return {
        "w_offset": ParamDef((k, k, cin, 2 * k * k), (None,) * 4,
                             init="zeros"),
        "b_offset": ParamDef((2 * k * k,), (None,), init="zeros"),
        "w_deform": ParamDef((k, k, cin, cout),
                             (None, None, None, "conv_out")),
        "b_deform": ParamDef((cout,), (None,), init="zeros"),
    }


QUANT_MODES = ("none", "qat", "int8", "int8_chain")


def dcl_apply(params: Mapping[str, Tensor], x, *,
              kernel_size: int = 3, stride: int = 1, dilation: int = 1,
              offset_bound: float | None = None, use_kernel: bool = False,
              dataflow: str = "zero_copy", quant: str = "none",
              quant_scales: Mapping[str, Any] | None = None,
              shard_batch: bool | None = None,
              shard_spatial: bool | None = None,
              device: str | torch.device | None = None):
    """One DCL forward pass -> (y, o_max).

    ``use_kernel=True`` with a trained ``offset_bound`` runs the offset
    conv, then the fused kernel (``ops.deform_conv``) under ``dataflow``
    (``"zero_copy"`` or the legacy ``"banded"``); otherwise the plain
    reference ``dcl_forward``.  ``o_max`` (Eq. 3) is taken from the raw
    offsets either way.

    ``quant`` selects the quantized datapaths:

    * ``"qat"`` — training: fake-quantize the deform-conv operands
      (activation per tensor, weights per output channel, STE backward)
      and run the fp32 machinery on the quantized grid (the kernel path
      through ``ops.deform_conv`` and its backward kernel, else the plain
      ``deform_conv_fused_ref``); the offset conv and every gradient stay
      fp32.  Scales are absmax unless ``quant_scales`` pins them.
    * ``"int8"`` — the offset conv stays fp32 (the address path is never
      quantized); the kernel path runs ``ops.deform_conv(precision=
      "int8")``, the plain path the fake-quant reference.  Scales come
      from ``quant_scales`` (``{"x_scale", "w_scale"}``, a calibration
      table entry), else absmax.
    * ``"int8_chain"`` — the offset conv is fused into the kernel and the
      output is emitted int8 (a ``QTensor`` on the table's ``y_scale``)
      when the table has a ``y_scale``; see ``_dcl_chain_layer``.

    ``shard_batch`` and ``shard_spatial`` pass to ``ops.deform_conv`` on
    the kernel paths (the batch and height shards over the active mesh);
    the chained datapath and the plain paths refuse them.  Inside a data
    shard (``sharding.data_shard``, a detector run per shard) the call's
    batch is the shard's rows: the model's split meets ``shard_batch``,
    which then splits nothing and refuses nothing.
    """
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of "
                         f"{QUANT_MODES}")
    if quant == "int8_chain":
        if dataflow != "zero_copy":
            raise ValueError(
                f"quant='int8_chain' supports only the zero-copy "
                f"dataflow (got {dataflow!r}); the fused offset stage "
                f"and int8 emission are band-pipeline plans")
        if shard_batch and data_shard() is None:
            raise ValueError(
                "shard_batch=True is not supported by the chained int8 "
                "inference datapath (it has no batch shard, like the int8 "
                "branch); train chain configs via the STE reference "
                "(use_kernel=False)")
        if shard_spatial:
            raise ValueError(
                "shard_spatial=True is not supported by the chained int8 "
                "datapath — the fused offset stage computes offsets from "
                "the staged band, so halo rows alone cannot reproduce "
                "them at shard seams; use quant='int8' for spatially "
                "sharded buckets")
        return _dcl_chain_layer(params, x, kernel_size=kernel_size,
                                stride=stride, dilation=dilation,
                                offset_bound=offset_bound,
                                use_kernel=use_kernel,
                                quant_scales=quant_scales, device=device)
    kernel_ok = use_kernel and offset_bound is not None
    if shard_spatial and not kernel_ok:
        raise ValueError(
            "shard_spatial=True requires the bounded kernel path "
            "(use_kernel=True with a trained offset_bound) — the "
            "reference paths have no spatial shard")
    cin = x.shape[-1]
    cout = params["w_deform"].shape[-1]
    cfg = DCLConfig(in_channels=cin, out_channels=cout,
                    kernel_size=kernel_size, stride=stride,
                    dilation=dilation, offset_bound=offset_bound,
                    dtype=x.dtype)
    k = kernel_size
    shards = dict(shard_batch=shard_batch, shard_spatial=shard_spatial)
    if quant in ("int8", "qat") or kernel_ok:
        offsets = conv2d(x, params["w_offset"].to(x.dtype), stride=stride,
                         dilation=dilation, padding=cfg.pad)
        offsets = offsets + params["b_offset"].to(x.dtype)
        o_max = offset_abs_max(offsets)
        w = params["w_deform"].to(x.dtype).reshape(k * k, cin, cout)
        scales = quant_scales or {}
        if quant == "qat":
            xq, wq = qat_quantize_inputs(x, w, x_scale=scales.get("x_scale"),
                                         w_scale=scales.get("w_scale"))
            if kernel_ok:
                y = ops.deform_conv(xq, offsets, wq, kernel_size=k,
                                    stride=stride, dilation=dilation,
                                    offset_bound=offset_bound,
                                    dataflow=dataflow, device=device,
                                    **shards)
            else:
                y = deform_conv_fused_ref(xq, offsets, wq, kernel_size=k,
                                          stride=stride, dilation=dilation,
                                          offset_bound=offset_bound)
        elif quant == "int8" and kernel_ok:
            # The dataflow passes through, so a banded config raises in
            # ops instead of running zero-copy.
            y = ops.deform_conv(x, offsets, w, kernel_size=k, stride=stride,
                                dilation=dilation, offset_bound=offset_bound,
                                dataflow=dataflow, precision="int8",
                                x_scale=scales.get("x_scale"),
                                w_scale=scales.get("w_scale"),
                                device=device, **shards)
        elif quant == "int8":
            y = fake_quant_dcl_reference(
                x, offsets, w, kernel_size=k, stride=stride,
                dilation=dilation, offset_bound=offset_bound,
                x_scale=scales.get("x_scale"), w_scale=scales.get("w_scale"))
        else:
            y = ops.deform_conv(x, offsets, w, kernel_size=k, stride=stride,
                                dilation=dilation, offset_bound=offset_bound,
                                dataflow=dataflow, device=device, **shards)
        return y + params["b_deform"].to(x.dtype), o_max
    y, stats = dcl_forward(params, x, cfg)
    return y, stats["o_max"]


def _dcl_chain_layer(params: Mapping[str, Tensor], x, *, kernel_size: int,
                     stride: int, dilation: int, offset_bound: float | None,
                     use_kernel: bool,
                     quant_scales: Mapping[str, Any] | None, device):
    """``quant="int8_chain"`` body of ``dcl_apply`` — one chained DCL.

    x is a fp32 tensor (the chain head, quantized onto the table's
    ``x_scale``) or a ``QTensor`` handed over by the previous chained
    layer, taken verbatim after checking that it was emitted on this
    layer's ``x_scale``.  Returns ``(y, o_max)``: y is a ``QTensor`` on the
    ``y_scale`` grid (kernel path with a calibrated ``y_scale``) or fp32
    (the chain tail, or the reference path); ``o_max`` is None on the
    kernel path, whose offsets never leave the kernel.
    """
    if offset_bound is None:
        raise ValueError(
            "quant='int8_chain' requires a trained offset_bound — the "
            "fused offset-conv stage exists because Eq. 6 bounds the "
            "band (train with the Eq. 5 regularizer first)")
    scales = quant_scales or {}
    x_scale = scales.get("x_scale")
    if x_scale is None:
        raise ValueError(
            "quant='int8_chain' requires calibrated quant_scales with at "
            "least x_scale (repro_torch.quant.calibrate_resnet_dcn records "
            "x/w/w_offset/y scales per DCL block): chained layers "
            "exchange int8 values on a pinned activation grid")
    w_scale = scales.get("w_scale")
    wo_scale = scales.get("w_offset_scale")
    y_scale = scales.get("y_scale")
    cin = x.shape[-1]
    cout = params["w_deform"].shape[-1]
    k = kernel_size
    w = params["w_deform"].float().reshape(k * k, cin, cout)
    w_off = params["w_offset"].float().reshape(k * k, cin, 2 * k * k)

    if use_kernel:
        if isinstance(x, QTensor):
            carried = float(x.scale)
            if not math.isclose(carried, float(x_scale), rel_tol=1e-6):
                raise ValueError(
                    f"int8 input was emitted on scale {carried} but the "
                    f"layer's calibration table decodes x_scale="
                    f"{float(x_scale)} — the consumer's x_scale must BE "
                    f"the producer's y_scale (recalibrate the pair "
                    f"together)")
        xin = x.values if isinstance(x, QTensor) else x.float()
        emit = "int8" if y_scale is not None else "fp32"
        y = ops.deform_conv_chain(
            xin, w, w_off, params["b_offset"], params["b_deform"],
            kernel_size=k, stride=stride, dilation=dilation,
            offset_bound=offset_bound, x_scale=x_scale, w_scale=w_scale,
            w_offset_scale=wo_scale, y_scale=y_scale, emit=emit,
            device=device)
        if emit == "int8":
            y = QTensor(values=y, scale=torch.as_tensor(
                y_scale, dtype=torch.float32, device=y.device))
        return y, None

    xin = x.dequantize() if isinstance(x, QTensor) else x.float()
    y, offsets = fake_quant_dcl_chain_reference(
        xin, w, w_off, params["b_offset"], params["b_deform"],
        kernel_size=k, stride=stride, dilation=dilation,
        offset_bound=offset_bound, x_scale=x_scale, w_scale=w_scale,
        w_offset_scale=wo_scale, y_scale=y_scale)
    return y, offset_abs_max(offsets)


def check_chain_compat(scales_seq: Sequence[Mapping[str, Any]],
                       couts: Sequence[int] | None = None,
                       cins: Sequence[int] | None = None) -> None:
    """Raise unless adjacent chained layers can hand each other int8
    tensors: producer ``i`` emits on its ``y_scale``, consumer ``i+1``
    decodes on its ``x_scale`` (the same number), and, where channel
    extents are given, producer C_out equals consumer C_in."""
    for i in range(len(scales_seq) - 1):
        ys = scales_seq[i].get("y_scale")
        xs = scales_seq[i + 1].get("x_scale")
        if ys is None:
            raise ValueError(
                f"chained layer {i} has no y_scale: the int8 emission "
                f"grid must be calibrated (calibrate_resnet_dcn records "
                f"it from the DCL output observer) before layer {i + 1} "
                f"can consume the tensor")
        if xs is None or not math.isclose(float(ys), float(xs),
                                          rel_tol=1e-6):
            raise ValueError(
                f"adjacent chained layers disagree on the exchange "
                f"grid: layer {i} emits on y_scale={ys} but layer "
                f"{i + 1} decodes on x_scale={xs} — recalibrate the "
                f"pair together (the consumer's x_scale IS the "
                f"producer's y_scale)")
        if couts is not None and cins is not None \
                and couts[i] != cins[i + 1]:
            raise ValueError(
                f"chained layer {i} emits C_out={couts[i]} channels but "
                f"layer {i + 1} expects C_in={cins[i + 1]} — int8 "
                f"chaining hands the tensor over verbatim, so the "
                f"channel extents must match")


def dcl_chain_apply(params_seq: Sequence[Mapping[str, Tensor]], x, *,
                    scales_seq: Sequence[Mapping[str, Any]],
                    kernel_size: int = 3, stride: int = 1,
                    dilation: int = 1, offset_bound: float | None = None,
                    use_kernel: bool = True,
                    device: str | torch.device | None = None):
    """Run back-to-back DCLs chained int8 -> int8: layer ``i`` emits a
    ``QTensor`` on its ``y_scale`` and layer ``i+1`` takes it verbatim.
    The chain head is quantized once and the tail (a table without
    ``y_scale``) emits fp32.  Returns ``(y, o_maxes)``; the o_maxes are
    None on the kernel path."""
    if len(params_seq) != len(scales_seq):
        raise ValueError(
            f"got {len(params_seq)} chained layers but "
            f"{len(scales_seq)} scale-table entries")
    check_chain_compat(
        scales_seq,
        couts=[p["w_deform"].shape[-1] for p in params_seq],
        cins=[p["w_deform"].shape[-2] for p in params_seq])
    o_maxes = []
    y = x
    for params, scales in zip(params_seq, scales_seq):
        y, o_max = dcl_apply(params, y, kernel_size=kernel_size,
                             stride=stride, dilation=dilation,
                             offset_bound=offset_bound,
                             use_kernel=use_kernel, quant="int8_chain",
                             quant_scales=scales, device=device)
        o_maxes.append(o_max)
    return y, o_maxes
