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
params with ``repro_torch.convert.params_from_jax`` instead.  The port
has no GSPMD, so the JAX layers' sharding hints (``logical_constraint``)
have no counterpart here; the DCL's kernel calls shard over the active
mesh (``dcl_apply``'s ``shard_batch`` and ``shard_spatial``).

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
from repro_torch.distributed.sharding import logical_spec
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


def effective_kv_heads(cfg: AttnConfig) -> int:
    """KV heads carried through attention and the KV cache.  The JAX
    package replicates KV per query group when a tensor-parallel mesh axis
    cannot shard them; one device has no such axis, so: ``kv_heads``."""
    return cfg.kv_heads


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
    """(q, k, v) of x: (B, S, H, Dh) and (B, S, KV, Dh)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
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
    positions: (B, S); ``mask`` overrides the causal(+window) mask."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    ekv = k.shape[2]
    q = q.reshape(b, s, ekv, cfg.n_heads // ekv, cfg.head_dim)
    if mask is None:
        mask = _scores_mask(positions, positions, cfg.window)
    out = _sdpa(q, k, v, mask, cfg.softcap)
    out = out.reshape(b, s, cfg.n_heads, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    if cfg.out_bias:
        y = y + params["bo"].to(x.dtype)
    return y


def attn_decode(params, x: Tensor, cfg: AttnConfig, *, cache: dict,
                pos: Tensor) -> tuple[Tensor, dict]:
    """Single-token decode with a KV cache.

    x: (B, 1, D); cache: {'k','v': (B, S_cache, KV, Dh)}; pos: (B,)
    absolute positions of the new token.  For windowed attention the cache
    is a ring buffer of size >= window.  Returns (y, new cache); the cache
    passed in is not changed.
    """
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    q, k, v = _qkv(params, x, cfg, pos[:, None])
    ekv = k.shape[2]
    if cache["k"].shape[2] != ekv:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} KV heads, "
                         f"the layer {ekv}")
    # A position past a full (non-ring) cache writes the last slot, as
    # JAX's dynamic_update_slice clamps its start.
    slot = pos % s_cache if cfg.window is not None \
        else pos.clamp(max=s_cache - 1)
    rows = torch.arange(b, device=x.device)
    k_cache = cache["k"].clone()
    v_cache = cache["v"].clone()
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)

    q = q.reshape(b, 1, ekv, cfg.n_heads // ekv, cfg.head_dim)
    # Absolute position of each cache slot (ring-aware).
    idx = torch.arange(s_cache, device=x.device)[None, :]
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
    out = _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask,
                cfg.softcap)
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    if cfg.out_bias:
        y = y + params["bo"].to(x.dtype)
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


def mlp_apply(params, x: Tensor, cfg: MLPConfig) -> Tensor:
    if cfg.kind in ("swiglu", "geglu"):
        act = F.silu if cfg.kind == "swiglu" else _gelu
        g = x @ params["w_gate"].to(x.dtype)
        u = x @ params["w_up"].to(x.dtype)
        if cfg.bias:
            g = g + params["b_in"].to(x.dtype)
        h = act(g) * u
    else:
        act = ACTS["gelu" if cfg.kind == "gelu" else "relu2"]
        h = x @ params["w_in"].to(x.dtype)
        if cfg.bias:
            h = h + params["b_in"].to(x.dtype)
        h = act(h)
    y = h @ params["w_out"].to(x.dtype)
    if cfg.bias:
        y = y + params["b_out"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_def(vocab: int, d_model: int) -> dict[str, ParamDef]:
    return {"embedding": ParamDef((vocab, d_model), ("vocab", None),
                                  init="embed", scale=0.02)}


def embed_apply(params, tokens: Tensor,
                dtype: torch.dtype = torch.bfloat16) -> Tensor:
    # Gather, then cast: the rows the JAX package casts before its take.
    return params["embedding"][tokens].to(dtype)


def _softcap(x: Tensor, cap: float | None) -> Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def logits_apply(params, x: Tensor, *, softcap: float | None = None
                 ) -> Tensor:
    """Project to vocab with the (possibly tied) embedding matrix; fp32
    logits."""
    emb = params["embedding"].to(x.dtype)
    return _softcap(x.float() @ emb.float().T, softcap)


def unembed_def(vocab: int, d_model: int) -> dict[str, ParamDef]:
    return {"unembedding": ParamDef((d_model, vocab), (None, "vocab"))}


def unembed_apply(params, x: Tensor, *, softcap: float | None = None
                  ) -> Tensor:
    w = params["unembedding"].to(x.dtype)
    return _softcap(x.float() @ w.float(), softcap)


def chunked_cross_entropy(x: Tensor, w: Tensor, targets: Tensor,
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
    b, s, _ = x.shape
    pad = (-s) % chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    wt = w.to(x.dtype).float()
    wt = wt.T if tied else wt

    def body(xb: Tensor, wt: Tensor, tb: Tensor, mb: Tensor):
        logits = _softcap((xb.float() @ wt) * logit_scale, softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tb[..., None].long())[..., 0]
        mb = mb.float()
        return torch.sum((lse - gold) * mb), torch.sum(mb)

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    m = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s + pad, chunk):
        part = (x[:, i:i + chunk], wt, targets[:, i:i + chunk],
                mask[:, i:i + chunk])
        if torch.is_grad_enabled():
            # The body draws no random numbers, so a dry run on meta
            # keeps no RNG snapshot.
            n_c, m_c = torch.utils.checkpoint.checkpoint(
                body, *part, use_reentrant=False,
                preserve_rng_state=x.device.type != "meta")
        else:
            n_c, m_c = body(*part)
        nll, m = nll + n_c, m + m_c
    return nll / torch.clamp_min(m, 1.0)


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
    the chained datapath and the plain paths refuse them.
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
        if shard_batch:
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
