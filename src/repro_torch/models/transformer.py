"""Decoder-only transformer LM: the dense GQA configs of the registry
(counterpart of ``repro.models.transformer`` for patterns of attention
layers without MoE).

Parameters of one pattern period are stacked along a leading
``n_periods`` axis (``params["layers"]``), as in the JAX package, so a
converted JAX tree has the same layout; ``forward`` runs the periods in a
Python loop where JAX scans them (``remat`` and ``scan_layers`` change no
result and are not read).  Three modes share the layer code: 'train'
(full sequence, no cache), 'prefill' (full sequence, emits caches) and
'decode' (one token, carries caches).  Attention is the plain PyTorch
``layers.attention``, as the JAX model's is plain XLA.

The MoE, RWKV-6 and RG-LRU mixers, multi-codebook heads and frontend
embeddings are not ported yet (ROADMAP Queue A item 6): a config that
asks for one raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    norm: str = "rms"                  # rms | layer
    act: str = "swiglu"
    parallel_block: bool = False       # command-r: attn and mlp in parallel
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    window: int | None = None          # sliding window for attn layers
    attn_softcap: float | None = None
    logits_softcap: float | None = None
    logit_scale: float = 1.0
    embed_scale: bool = False          # multiply embeddings by sqrt(d)
    tie_embeddings: bool = True
    qk_norm: bool = False
    pattern: tuple[str, ...] = ("attn",)
    moe: Any = None                    # not ported yet (ROADMAP)
    rwkv: Any = None                   # not ported yet (ROADMAP)
    rglru: Any = None                  # not ported yet (ROADMAP)
    codebooks: int = 1                 # musicgen: 4 parallel codebooks
    frontend_embeds: bool = False      # pixtral: extra (B, P, D) embeds input
    dtype: torch.dtype = torch.bfloat16
    remat: str = "none"                # none | full | dots (no effect here)
    moe_aux_coef: float = 0.01
    scan_layers: bool = True           # no effect here: periods are a loop

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def prefix(self) -> tuple[str, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            kv_heads=self.kv_heads, head_dim=self.hd,
            rope_theta=self.rope_theta, rope_fraction=self.rope_fraction,
            use_rope=self.use_rope, qkv_bias=self.qkv_bias,
            out_bias=self.out_bias, window=self.window,
            softcap=self.attn_softcap, qk_norm=self.qk_norm)

    def mlp_cfg(self) -> L.MLPConfig:
        return L.MLPConfig(d_model=self.d_model, d_ff=self.d_ff,
                           kind=self.act, bias=self.mlp_bias)

    def param_count(self) -> int:
        defs = model_def(self)
        period = defs.pop("period")
        return sum(math.prod(d.shape) for d in T.leaves(defs)) \
            + self.n_periods * sum(math.prod(d.shape)
                                   for d in T.leaves(period))


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config that needs a module the port lacks."""
    missing = [what for what, used in (
        ("MoE (models/moe.py)", cfg.moe is not None),
        ("RWKV-6 (models/rwkv6.py)",
         cfg.rwkv is not None or "rwkv6" in cfg.pattern),
        ("RG-LRU (models/rglru.py)",
         cfg.rglru is not None or "rglru" in cfg.pattern),
        ("multi-codebook heads", cfg.codebooks > 1),
        ("frontend embeddings", cfg.frontend_embeds)) if used]
    if set(cfg.pattern) != {"attn"} and not missing:
        missing.append(f"pattern {cfg.pattern}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; see ROADMAP "
            f"Queue A item 6 (the port runs the dense attention LMs)")


# ---------------------------------------------------------------------------
# Parameter and cache definitions
# ---------------------------------------------------------------------------

def _layer_def(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    out = {"norm1": L.norm_def(d, cfg.norm),
           "attn": L.attn_def(cfg.attn_cfg())}
    if not cfg.parallel_block:
        out["norm2"] = L.norm_def(d, cfg.norm)
    out["ffn"] = L.mlp_def(cfg.mlp_cfg())
    return out


def model_def(cfg: ModelConfig) -> dict:
    """ParamDef tree (period layers declared ONCE; stacked at init)."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab
    defs: dict[str, Any] = {"embed": L.embed_def(v, d)}
    if not cfg.tie_embeddings:
        defs["unembed"] = L.unembed_def(v, d)
    defs["final_norm"] = L.norm_def(d, cfg.norm)
    for i, _ in enumerate(cfg.prefix):
        defs[f"prefix{i}"] = _layer_def(cfg)
    defs["period"] = {f"m{j}": _layer_def(cfg)
                      for j, _ in enumerate(cfg.pattern)}
    return defs


def _stacked(defs, n: int):
    """A period's ParamDef tree with a leading axis of ``n`` (each slice
    drawn at the unstacked leaf's scale)."""
    return T.tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape,
        scale=None if d.init in ("zeros", "ones") else L.default_scale(d)),
        defs)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """Random params from ``seed`` (drawn on the CPU, then moved to
    ``device``; the default is ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    defs = model_def(cfg)
    period = defs.pop("period")
    params = L.init_tree(defs, gen, dev)
    params["layers"] = L.init_tree(_stacked(period, cfg.n_periods), gen, dev)
    return params


def cache_def(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    check_supported(cfg)
    layer = L.attn_cache_def(cfg.attn_cfg(), batch, cache_len,
                             dtype=cfg.dtype)
    defs: dict[str, Any] = {f"prefix{i}": layer
                            for i, _ in enumerate(cfg.prefix)}
    defs["period"] = {f"m{j}": layer for j, _ in enumerate(cfg.pattern)}
    return defs


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: str | torch.device | None = None) -> dict:
    """Zero caches: ``layers`` leaves (n_periods, batch, cache_len, KV, Dh)
    in ``cfg.dtype``."""
    dev = resolve_device(device)
    defs = cache_def(cfg, batch, cache_len)
    period = defs.pop("period")
    cache = L.init_tree(defs, None, dev)
    cache["layers"] = L.init_tree(_stacked(period, cfg.n_periods), None, dev)
    return cache


# ---------------------------------------------------------------------------
# Layer application (one code path for train / prefill / decode)
# ---------------------------------------------------------------------------

def _attn_prefill_cache(cfg: ModelConfig, k: Tensor, v: Tensor,
                        cache_len: int) -> dict:
    """Pack full-sequence K/V into the decode cache layout (ring-aware)."""
    s = k.shape[1]
    if s >= cache_len:
        shift = s % cache_len
        k_c = torch.roll(k[:, s - cache_len:], shift, dims=1)
        v_c = torch.roll(v[:, s - cache_len:], shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, cache_len - s)
        k_c = torch.nn.functional.pad(k, pad)
        v_c = torch.nn.functional.pad(v, pad)
    return {"k": k_c.to(cfg.dtype), "v": v_c.to(cfg.dtype)}


def _apply_attn_layer(params, x: Tensor, cfg: ModelConfig, *, mode: str,
                      cache, positions: Tensor, cache_len: int | None):
    acfg = cfg.attn_cfg()
    h = L.apply_norm(params["norm1"], x, cfg.norm)
    new_cache = None
    if mode == "decode":
        a, new_cache = L.attn_decode(params["attn"], h, acfg, cache=cache,
                                     pos=positions[:, 0])
    else:
        b, s, _ = h.shape
        q, k, v = L._qkv(params["attn"], h, acfg, positions)
        ekv = k.shape[2]
        qg = q.reshape(b, s, ekv, acfg.n_heads // ekv, acfg.head_dim)
        o = L.attention(qg, k, v, positions, positions,
                        window=acfg.window, softcap=acfg.softcap)
        o = o.reshape(b, s, acfg.n_heads, acfg.head_dim)
        a = torch.einsum("bshk,hkd->bsd", o,
                         params["attn"]["wo"].to(x.dtype))
        if acfg.out_bias:
            a = a + params["attn"]["bo"].to(x.dtype)
        if mode == "prefill":
            new_cache = _attn_prefill_cache(cfg, k, v, cache_len)
    if cfg.parallel_block:
        x = x + a + L.mlp_apply(params["ffn"], h, cfg.mlp_cfg())
    else:
        x = x + a
        h2 = L.apply_norm(params["norm2"], x, cfg.norm)
        x = x + L.mlp_apply(params["ffn"], h2, cfg.mlp_cfg())
    return x, new_cache


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    x = L.embed_apply(params["embed"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def _logits(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    if cfg.tie_embeddings:
        logits = L.logits_apply(params["embed"], x)
    else:
        logits = L.unembed_apply(params["unembed"], x)
    logits = logits * cfg.logit_scale
    if cfg.logits_softcap is not None:
        logits = torch.tanh(logits / cfg.logits_softcap) \
            * cfg.logits_softcap
    return logits


def forward(params, cfg: ModelConfig, *, tokens: Tensor, mode: str = "train",
            caches=None, positions: Tensor | None = None,
            cache_len: int | None = None):
    """Returns (logits_or_hidden, new_caches, aux_loss); aux_loss is 0 (no
    MoE).  tokens: (B, S) integer.  Prefill slices to the last position
    before the unembedding, as in JAX."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    new_caches: dict[str, Any] = {}
    for i, _ in enumerate(cfg.prefix):
        c = caches.get(f"prefix{i}") if caches else None
        x, nc = _apply_attn_layer(params[f"prefix{i}"], x, cfg, mode=mode,
                                  cache=c, positions=positions,
                                  cache_len=cache_len)
        if nc is not None:
            new_caches[f"prefix{i}"] = nc
    layer_caches = caches["layers"] if caches else None
    period_caches = []
    for i in range(cfg.n_periods):
        per_new = {}
        for j, _ in enumerate(cfg.pattern):
            name = f"m{j}"
            c = None if layer_caches is None \
                else T.tree_map(lambda a: a[i], layer_caches[name])
            x, nc = _apply_attn_layer(
                T.tree_map(lambda a: a[i], params["layers"][name]), x, cfg,
                mode=mode, cache=c, positions=positions,
                cache_len=cache_len)
            if nc is not None:
                per_new[name] = nc
        if per_new:
            period_caches.append(per_new)
    if period_caches:
        new_caches["layers"] = T.tree_map(lambda *xs: torch.stack(xs),
                                          *period_caches)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if mode == "prefill":
        x = x[:, -1:]
    return _logits(params, cfg, x), (new_caches or None), \
        torch.zeros((), device=x.device)


def prefill(params, cfg: ModelConfig, tokens: Tensor, *, cache_len: int):
    """Returns (last-position logits (B, V), caches)."""
    logits, caches, _ = forward(params, cfg, tokens=tokens, mode="prefill",
                                cache_len=cache_len)
    return logits[:, -1], caches


def decode_step(params, cfg: ModelConfig, tokens: Tensor, caches,
                pos: Tensor):
    """One decode step.  tokens: (B,); pos: (B,) absolute positions.
    Returns (logits (B, V), new caches); the caches passed in are not
    changed."""
    logits, new_caches, _ = forward(
        params, cfg, tokens=tokens[:, None], mode="decode", caches=caches,
        positions=pos[:, None], cache_len=None)
    return logits[:, 0], new_caches
