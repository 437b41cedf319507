"""Decoder-only LM covering the registry's architectures (counterpart of
``repro.models.transformer``): dense GQA transformers, MoE transformers
(dbrx, grok-1), multi-codebook audio decoders (musicgen), prepended
frontend embeddings (pixtral), attention-free RWKV-6 and the RG-LRU /
local-attention hybrid, through a periodic layer ``pattern`` of mixer
kinds ('attn' | 'rwkv6' | 'rglru').

Parameters of one pattern period are stacked along a leading
``n_periods`` axis (``params["layers"]``), as in the JAX package, so a
converted JAX tree has the same layout; ``forward`` runs the periods in a
Python loop where JAX scans them (``scan_layers`` is not read).  A
remainder prefix of the pattern runs before the periods.  ``remat``
recomputes each period's activations in the backward as JAX's
``_maybe_remat`` does: 'full' keeps only the period's inputs, 'dots' also
the weight products, 'none' keeps everything; no mode changes a result.
Three modes share the layer code: 'train' (full sequence, no cache),
'prefill' (full sequence, emits caches) and 'decode' (one token, carries
caches).  Every layer returns its MoE load-balancing loss (0 without
MoE); ``forward`` sums them.  Attention is the plain PyTorch
``layers.attention``, as the JAX model's is plain XLA.  ``loss_fn`` is
the training objective: the chunked cross entropy of the final hidden
state (on the text positions after a frontend; the mean over codebooks)
plus ``moe_aux_coef`` times the summed aux loss.

Under an active mesh (``sharding.use_rules(mesh=...)``) the params may
be placed by their specs (``param_defs`` under the same rules,
``sharding.place_tree``): the batch splits over the mesh's 'batch' axes
(one data shard a block of rows, run at its coordinates), and inside a
shard the attention, MLP, embedding and vocab layers run per model shard
(``models.layers``).  The RG-LRU, RWKV-6 and MoE blocks have no
per-shard path: each gathers its leaves whole where it runs (FSDP at
rest), and an MoE model runs its batch whole, since its routing and
capacity span the batch.  ``loss_fn`` adds the shards' NLL sums and
token counts before its one division, so the loss is the global
token-weighted mean.  Caches stay whole, in the ``effective_kv_heads``
layout of ``cache_defs`` under the same rules.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.utils.checkpoint as ckpt

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (at_coords, batch_mesh_axes,
                                              context, data_shards,
                                              is_placed, restored)
from repro_torch.models import layers as L
from repro_torch.models.moe import (MoEConfig, aux_from_stats, expert_split,
                                    moe_apply, moe_def)
from repro_torch.models.rwkv6 import (RWKVConfig, channel_mix_apply,
                                      channel_mix_def, channel_mix_step,
                                      ff_split, head_split, time_mix_apply,
                                      time_mix_def, time_mix_step)
from repro_torch.models.rglru import (CONV_WIDTH, RGLRUConfig,
                                      rglru_block_apply, rglru_block_def,
                                      rglru_block_step, rnn_split)

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
    moe: MoEConfig | None = None
    rwkv: RWKVConfig | None = None
    rglru: RGLRUConfig | None = None
    codebooks: int = 1                 # musicgen: 4 parallel codebooks
    frontend_embeds: bool = False      # pixtral: extra (B, P, D) embeds input
    dtype: torch.dtype = torch.bfloat16
    remat: str = "none"                # none | full | dots
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

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        experts = sum(math.prod(d.shape) for name, d in
                      moe_def(self.moe).items() if name != "w_router")
        inactive = experts * self.n_layers \
            * (1 - self.moe.top_k / self.moe.num_experts)
        return int(self.param_count() - inactive)


# ---------------------------------------------------------------------------
# Parameter and cache definitions
# ---------------------------------------------------------------------------

def _layer_def(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind == "attn":
        out = {"norm1": L.norm_def(d, cfg.norm),
               "attn": L.attn_def(cfg.attn_cfg())}
        if not cfg.parallel_block:
            out["norm2"] = L.norm_def(d, cfg.norm)
        out["ffn"] = moe_def(cfg.moe) if cfg.moe else L.mlp_def(cfg.mlp_cfg())
        return out
    if kind == "rwkv6":
        return {"norm1": L.norm_def(d, cfg.norm),
                "tm": time_mix_def(cfg.rwkv),
                "norm2": L.norm_def(d, cfg.norm),
                "cm": channel_mix_def(cfg.rwkv)}
    if kind == "rglru":
        return {"norm1": L.norm_def(d, cfg.norm),
                "rec": rglru_block_def(cfg.rglru),
                "norm2": L.norm_def(d, cfg.norm),
                "ffn": L.mlp_def(cfg.mlp_cfg())}
    raise ValueError(kind)


def model_def(cfg: ModelConfig) -> dict:
    """ParamDef tree (period layers declared ONCE; stacked at init).  A
    multi-codebook model has a (CB, V, D) embedding and (CB, D, V)
    heads."""
    d, v = cfg.d_model, cfg.vocab
    defs: dict[str, Any] = {}
    if cfg.codebooks > 1:
        defs["embed"] = {"embedding": L.ParamDef(
            (cfg.codebooks, v, d), (None, "vocab", None), init="embed",
            scale=0.02)}
        defs["heads"] = {"unembedding": L.ParamDef(
            (cfg.codebooks, d, v), (None, None, "vocab"))}
    else:
        defs["embed"] = L.embed_def(v, d)
        if not cfg.tie_embeddings:
            defs["unembed"] = L.unembed_def(v, d)
    defs["final_norm"] = L.norm_def(d, cfg.norm)
    for i, kind in enumerate(cfg.prefix):
        defs[f"prefix{i}"] = _layer_def(cfg, kind)
    defs["period"] = {f"m{j}": _layer_def(cfg, kind)
                      for j, kind in enumerate(cfg.pattern)}
    return defs


def _stacked(defs, n: int):
    """A period's ParamDef tree with a leading axis of ``n`` (each slice
    drawn at the unstacked leaf's scale)."""
    return T.tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, axes=(None,) + d.axes,
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


def _layer_cache_def(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int) -> dict:
    if kind == "attn":
        return L.attn_cache_def(cfg.attn_cfg(), batch, cache_len,
                                dtype=cfg.dtype)
    if kind == "rwkv6":
        h, dh, d = cfg.rwkv.n_heads, cfg.rwkv.head_dim, cfg.d_model
        return {"shift_tm": L.ParamDef((batch, d), ("batch", None),
                                       init="zeros", dtype=cfg.dtype),
                "wkv": L.ParamDef((batch, h, dh, dh),
                                  ("batch", "heads", None, None), init="zeros",
                                  dtype=torch.float32),
                "shift_cm": L.ParamDef((batch, d), ("batch", None),
                                       init="zeros", dtype=cfg.dtype)}
    if kind == "rglru":
        dr = cfg.rglru.d_rnn
        return {"h": L.ParamDef((batch, dr), ("batch", "rnn"), init="zeros",
                                dtype=torch.float32),
                "conv": L.ParamDef((batch, CONV_WIDTH - 1, dr),
                                   ("batch", None, "rnn"), init="zeros",
                                   dtype=cfg.dtype)}
    raise ValueError(kind)


def cache_def(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    defs: dict[str, Any] = {
        f"prefix{i}": _layer_cache_def(cfg, kind, batch, cache_len)
        for i, kind in enumerate(cfg.prefix)}
    defs["period"] = {f"m{j}": _layer_cache_def(cfg, kind, batch, cache_len)
                      for j, kind in enumerate(cfg.pattern)}
    return defs


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: str | torch.device | None = None) -> dict:
    """Zero caches, ``layers`` leaves led by the period axis: attention
    K/V (n_periods, batch, cache_len, KV, Dh) in ``cfg.dtype``; RG-LRU
    ``h`` (n_periods, batch, d_rnn) in fp32 and ``conv`` taps
    (n_periods, batch, 3, d_rnn) in ``cfg.dtype``; RWKV-6 ``shift_tm``
    and ``shift_cm`` (n_periods, batch, D) in ``cfg.dtype`` and ``wkv``
    (n_periods, batch, H, Dh, Dh) in fp32."""
    dev = resolve_device(device)
    defs = cache_def(cfg, batch, cache_len)
    period = defs.pop("period")
    cache = L.init_tree(defs, None, dev)
    cache["layers"] = L.init_tree(_stacked(period, cfg.n_periods), None, dev)
    return cache


def param_defs(cfg: ModelConfig) -> dict:
    """The ParamDef tree of ``init_params``' layout: the period's leaves
    stacked under ``layers`` (a leading None logical axis, as JAX's
    ``param_specs`` prepends)."""
    defs = model_def(cfg)
    defs["layers"] = _stacked(defs.pop("period"), cfg.n_periods)
    return defs


def cache_defs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """The ParamDef tree of ``init_cache``' layout."""
    defs = cache_def(cfg, batch, cache_len)
    defs["layers"] = _stacked(defs.pop("period"), cfg.n_periods)
    return defs


# ---------------------------------------------------------------------------
# Layer application (one code path for train / prefill / decode)
# ---------------------------------------------------------------------------

def _attn_prefill_cache(cfg: ModelConfig, k: Tensor, v: Tensor,
                        cache_len: int) -> dict:
    """Pack full-sequence K/V into the decode cache layout: the rows of
    ``init_cache`` (``min(cache_len, window)`` for a windowed layer, the
    ring ``attn_decode`` writes position p at slot p % rows), so the
    engine takes a prefill whatever ``cache_len`` is.  The JAX package
    packs ``cache_len`` rows, which its own engine cannot take either
    when ``cache_len`` exceeds the window."""
    s = k.shape[1]
    rows = min(cache_len, cfg.window) if cfg.window is not None \
        else cache_len
    if s >= rows:
        shift = s % rows
        k_c = torch.roll(k[:, s - rows:], shift, dims=1)
        v_c = torch.roll(v[:, s - rows:], shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, rows - s)
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
        a, k, v = L.attn_forward(params["attn"], h, acfg,
                                 positions=positions)
        if mode == "prefill":
            new_cache = _attn_prefill_cache(cfg, k, v, cache_len)
    full_cap = mode == "decode"

    def ffn(h):
        if cfg.moe:
            return moe_apply(params["ffn"], h, cfg.moe,
                             full_capacity=full_cap, stats=True)
        return L.mlp_apply(params["ffn"], h, cfg.mlp_cfg()), None
    if cfg.parallel_block:
        f, aux = ffn(h)
        x = x + a + f
    else:
        x = x + a
        f, aux = ffn(L.apply_norm(params["norm2"], x, cfg.norm))
        x = x + f
    return x, new_cache, aux


def _apply_rwkv_layer(params, x: Tensor, cfg: ModelConfig, *, mode: str,
                      cache, positions: Tensor, cache_len: int | None):
    """Train and prefill start from zero state, as JAX's do (its prefill
    reads the cache's ``shift_tm`` and drops it); the caches hold the
    normed inputs of the last token in ``cfg.dtype`` and the fp32 WKV
    state.  Under the mesh the block runs per head shard (or its heads
    met) and ``ff`` block (``rwkv6``)."""
    h = L.apply_norm(params["norm1"], x, cfg.norm)
    if mode == "decode":
        y, (sh_tm, wkv) = time_mix_step(
            params["tm"], h[:, 0], cfg.rwkv, shift_state=cache["shift_tm"],
            wkv_state=cache["wkv"])
        x = x + y[:, None]
        h2 = L.apply_norm(params["norm2"], x, cfg.norm)
        y2, sh_cm = channel_mix_step(params["cm"], h2[:, 0], cfg.rwkv,
                                     shift_state=cache["shift_cm"])
        x = x + y2[:, None]
    else:
        y, (sh_tm, wkv) = time_mix_apply(params["tm"], h, cfg.rwkv)
        x = x + y
        h2 = L.apply_norm(params["norm2"], x, cfg.norm)
        y2, sh_cm = channel_mix_apply(params["cm"], h2, cfg.rwkv)
        x = x + y2
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {"shift_tm": sh_tm.to(cfg.dtype), "wkv": wkv,
                     "shift_cm": sh_cm.to(cfg.dtype)}
    return x, new_cache, None


def _apply_rglru_layer(params, x: Tensor, cfg: ModelConfig, *, mode: str,
                       cache, positions: Tensor, cache_len: int | None):
    """The recurrent block runs per ``rnn`` block and its MLP per ``ff``
    block under the mesh (``rglru``)."""
    h = L.apply_norm(params["norm1"], x, cfg.norm)
    rec = params["rec"]
    if mode == "decode":
        y, state = rglru_block_step(rec, h[:, 0], cfg.rglru, state=cache)
        x = x + y[:, None]
    else:
        y, state = rglru_block_apply(rec, h, cfg.rglru)
        x = x + y
    h2 = L.apply_norm(params["norm2"], x, cfg.norm)
    x = x + L.mlp_apply(params["ffn"], h2, cfg.mlp_cfg())
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {"h": state["h"], "conv": state["conv"].to(cfg.dtype)}
    return x, new_cache, None


_LAYER_APPLY = {
    "attn": _apply_attn_layer,
    "rwkv6": _apply_rwkv_layer,
    "rglru": _apply_rglru_layer,
}


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens: Tensor,
           frontend: Tensor | None) -> Tensor:
    """Token embeddings (a multi-codebook model sums its codebooks' in
    order), scaled by sqrt(D) where the config says, after a prepended
    frontend (B, P, D)."""
    if cfg.codebooks > 1:
        emb = params["embed"]["embedding"]               # (CB, V, D)
        x = sum(L.embed_rows(emb[i], tokens[..., i], cfg.dtype)
                for i in range(cfg.codebooks))
    else:
        x = L.embed_apply(params["embed"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                             device=x.device)
    if frontend is not None:
        x = torch.cat([frontend.to(x.device, cfg.dtype), x], 1)
    return x


def _logits(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """fp32 logits (B, S, V), or (B, S, CB, V) with codebooks."""
    if cfg.codebooks > 1:
        heads = params["heads"]["unembedding"]            # (CB, D, V)
        if is_placed(heads) or L._vocab_shards(cfg.vocab) is not None:
            logits = torch.stack([L.vocab_logits(x, heads[i], tied=False)
                                  for i in range(cfg.codebooks)], 2)
        else:
            w = L._w(heads, x)
            logits = torch.einsum("bsd,cdv->bscv", x.float(), w.float())
    elif cfg.tie_embeddings:
        logits = L.logits_apply(params["embed"], x)
    else:
        logits = L.unembed_apply(params["unembed"], x)
    logits = logits * cfg.logit_scale
    if cfg.logits_softcap is not None:
        logits = torch.tanh(logits / cfg.logits_softcap) \
            * cfg.logits_softcap
    return logits


_aten = torch.ops.aten


def _save_weight_products(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the products
    without a batch dimension (``mm``, ``addmm``, and the batch-1 ``bmm``
    an einsum of activations by a weight becomes), recompute the rest,
    attention's batched products included."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` checkpointed as ``cfg.remat`` says, when autograd records."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_weight_products)}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # The recomputation runs where the backward does (a CUDA
        # device's autograd thread): under this forward's rules, mesh
        # and shard coordinates, so it takes the same per-shard paths.
        ctx = context()

        def again(*a):
            with restored(ctx):
                return fn(*a)
        # No layer draws random numbers, so a dry run on meta keeps no
        # RNG snapshot.  No early stop: the recomputation runs the whole
        # period, so each of its crossings happens again, as JAX's
        # rematerialised gathers do.
        return ckpt.checkpoint(
            again, *args, use_reentrant=False, early_stop=False,
            preserve_rng_state=args[0].device.type != "meta", **kw)
    return run


def shard_plan(cfg: ModelConfig, batch: int | None = None) -> dict:
    """How each layer of ``cfg`` runs under the active mesh: the data
    shards (of a batch of ``batch`` rows), attention per head shard or per
    block of query rows, the MLP per ``ff`` block, the MoE per expert
    shard or per ``ff`` block, the RG-LRU per ``rnn`` block, RWKV-6 per
    head shard (or its heads met) and ``ff`` block, the vocab per block,
    or whole; ``whole`` names the MoE, RG-LRU and RWKV-6 blocks that
    gather their leaves whole where they run."""
    acfg = cfg.attn_cfg()
    shards = None if batch is None else data_shards(batch)
    heads = L._head_shards(acfg)
    _, _, tp = L.mesh_axes("ff")
    plan = {"data_shards": 1 if shards is None else len(shards)}
    kinds = set(cfg.pattern)
    if "attn" in kinds:
        if heads is not None:
            sh = heads[0]
            kv = sh.cache_slice.stop - sh.cache_slice.start
            how = "replicated per query group" if sh.rep else "split"
            plan["attention"] = (f"{len(heads)} head shards of {sh.nq} "
                                 f"query heads, {kv} KV heads (KV {how})")
        elif L.seq_parallel_attention(acfg):
            plan["attention"] = (f"{L.heads_tp_size()} blocks of query "
                                 f"rows, all of K/V (sequence-parallel)")
        else:
            plan["attention"] = "whole"
    if cfg.moe is not None:
        how, _, n = expert_split(cfg.moe)
        e, f = cfg.moe.num_experts, cfg.moe.d_ff
        plan["moe"] = {"experts": f"{n} expert shards of {e // n} experts",
                       "ff": f"{n} ff blocks of {f // n} a expert",
                       "whole": "whole"}[how]
    elif "attn" in kinds or "rglru" in kinds:
        ff_split = tp > 1 and cfg.d_ff % tp == 0
        plan["mlp"] = f"{tp} ff blocks of {cfg.d_ff // tp}" if ff_split \
            else "whole"
    if "rglru" in kinds:
        plan["rglru"] = _rglru_plan(cfg.rglru)
    if "rwkv6" in kinds:
        plan["rwkv6"] = _rwkv_plan(cfg.rwkv)
    vocab = L._vocab_shards(cfg.vocab)
    plan["vocab"] = "whole" if vocab is None else \
        f"{len(vocab)} vocab blocks of {vocab[0][1]}"
    plan["whole"] = sorted(k for k in ("moe", "rglru", "rwkv6")
                           if plan.get(k) == "whole")
    return plan


def _rglru_plan(cfg: RGLRUConfig) -> str:
    split = rnn_split(cfg)
    return "whole" if split is None else \
        f"{split[1]} rnn blocks of {cfg.d_rnn // split[1]}"


def _rwkv_plan(cfg: RWKVConfig) -> str:
    heads, ff = head_split(cfg), ff_split(cfg)
    if heads is None and ff is None:
        return "whole"
    if heads is None:
        tm = "time mix whole"
    else:
        axes, n, whole_heads = heads
        tm = (f"{n} head shards of {cfg.n_heads // n} heads" if whole_heads
              else f"{n} channel blocks of {cfg.d_model // n}, the heads "
                   f"met for the WKV")
    cm = "channel mix whole" if ff is None else \
        f"{ff[1]} ff blocks of {cfg.d_ff // ff[1]}"
    return f"{tm}; {cm}"


def _rows(t, lo: int, hi: int, device, dim: int = 0):
    return None if t is None else t.narrow(dim, lo, hi - lo).to(device)


def _cache_rows(caches, lo: int, hi: int, device):
    """Rows ``[lo, hi)`` of a cache tree (``layers`` leaves are led by
    the period axis)."""
    if caches is None:
        return None
    return {k: T.tree_map(lambda t: _rows(t, lo, hi, device,
                                          1 if k == "layers" else 0), c)
            for k, c in caches.items()}


def _cat_caches(parts: list, device):
    if parts[0] is None:
        return None
    return {k: T.tree_map(lambda *ts: torch.cat(
        [t.to(device) for t in ts], 1 if k == "layers" else 0),
        *(p[k] for p in parts)) for k in parts[0]}


def forward(params, cfg: ModelConfig, *, tokens: Tensor,
            frontend: Tensor | None = None, mode: str = "train",
            caches=None, positions: Tensor | None = None,
            cache_len: int | None = None, return_hidden: bool = False):
    """Returns (logits_or_hidden, new_caches, aux_loss).  tokens: (B, S)
    integer, (B, S, CB) with codebooks; frontend: (B, P, D) embeddings
    prepended to the tokens'.  aux_loss (fp32) sums the layers' MoE
    load-balancing losses, 0 without MoE.  ``return_hidden`` returns the
    final-normed hidden state and skips the unembedding (the training
    loss takes the chunked CE path instead); prefill slices to the last
    position before the unembedding, as in JAX.  Under an active mesh
    each data shard (``sharding.data_shards``) runs at its coordinates and
    the results meet, in shard order, on the first shard's device.  An
    MoE model's batch splits too: its capacity is per row, and its aux
    loss is combined from the shards' sums (``moe.moe_stats``)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    kw = dict(mode=mode, cache_len=cache_len, return_hidden=return_hidden)
    shards = data_shards(tokens.shape[0])
    if shards is None:
        y, c, stats = _forward_shard(params, cfg, tokens=tokens,
                                     frontend=frontend, caches=caches,
                                     positions=positions, **kw)
        return y, c, _aux(cfg, [stats], y.device)
    mesh = batch_mesh_axes()[0]
    outs = []
    for coords, lo, hi in shards:
        dev = mesh.device_at(coords)
        with at_coords(coords):
            outs.append(_forward_shard(
                params, cfg, tokens=_rows(tokens, lo, hi, dev),
                frontend=_rows(frontend, lo, hi, dev),
                caches=_cache_rows(caches, lo, hi, dev),
                positions=_rows(positions, lo, hi, dev), **kw))
    home = mesh.device_at(shards[0][0])
    y = torch.cat([o[0].to(home) for o in outs], 0)
    return (y, _cat_caches([o[1] for o in outs], home),
            _aux(cfg, [o[2] for o in outs], home))


def _aux(cfg: ModelConfig, stats: list, device) -> Tensor:
    """The summed MoE aux loss (fp32) of the data shards' ``moe_stats``
    (each (MoE layers, 2E + 1), or None without MoE): the shards' sums
    meet on ``device``, then each layer's product is taken once."""
    if stats[0] is None:
        return torch.zeros((), device=device)
    total = stats[0].to(device)
    for t in stats[1:]:
        total = total + t.to(device)
    return aux_from_stats(total, cfg.moe.num_experts, cfg.moe.top_k).sum()


def _forward_shard(params, cfg: ModelConfig, *, tokens: Tensor,
                   frontend: Tensor | None, mode: str, caches,
                   positions: Tensor | None, cache_len: int | None,
                   return_hidden: bool):
    """``forward`` of one data shard (or of the whole batch), its aux
    output the MoE layers' ``moe_stats`` stacked in layer order (None
    without MoE)."""
    x = _embed(params, cfg, tokens, frontend)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    kw = dict(mode=mode, positions=positions, cache_len=cache_len)
    stats: list[Tensor] = []
    new_caches: dict[str, Any] = {}
    for i, kind in enumerate(cfg.prefix):
        c = caches.get(f"prefix{i}") if caches else None
        x, nc, a = _LAYER_APPLY[kind](params[f"prefix{i}"], x, cfg, cache=c,
                                      **kw)
        if a is not None:
            stats.append(a)
        if nc is not None:
            new_caches[f"prefix{i}"] = nc

    def period(x, per_params, per_caches):
        per_new, per_stats = {}, []
        for j, kind in enumerate(cfg.pattern):
            name = f"m{j}"
            c = per_caches[name] if per_caches is not None else None
            x, nc, a = _LAYER_APPLY[kind](per_params[name], x, cfg, cache=c,
                                          **kw)
            if a is not None:
                per_stats.append(a)
            if nc is not None:
                per_new[name] = nc
        return x, per_stats, per_new

    body = _maybe_remat(period, cfg)
    layer_caches = caches["layers"] if caches else None
    period_caches = []
    for i in range(cfg.n_periods):
        def take(t):
            return T.tree_map(lambda a: a[i], t, is_leaf=is_placed)
        x, per_stats, per_new = body(x, take(params["layers"]),
                                     None if layer_caches is None
                                     else take(layer_caches))
        stats += per_stats
        if per_new:
            period_caches.append(per_new)
    if period_caches:
        new_caches["layers"] = T.tree_map(lambda *xs: torch.stack(xs),
                                          *period_caches)
    aux = torch.stack(stats) if stats else None
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, (new_caches or None), aux
    if mode == "prefill":
        x = x[:, -1:]
    return _logits(params, cfg, x), (new_caches or None), aux


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """batch: tokens (B, S[, CB]), targets (B, S[, CB]), optional mask
    (B, S), optional frontend (B, P, D).  Returns (loss, {"ce",
    "moe_aux"}): the chunked CE on the text positions (after the
    frontend), the mean over codebooks, plus ``moe_aux_coef`` x aux.  The
    (B, S, V) logits tensor never exists.  Under an active mesh each data
    shard adds its NLL sum and token count, and the CE is their ratio:
    the global token-weighted mean, not a mean of the shards' means; the
    MoE aux loss likewise comes from the shards' summed ``moe_stats``."""
    tokens = batch["tokens"]
    shards = data_shards(tokens.shape[0])
    if shards is None:
        pieces = [({}, None, tokens.device)]
    else:
        mesh = batch_mesh_axes()[0]
        pieces = [(c, (lo, hi), mesh.device_at(c)) for c, lo, hi in shards]
    home = pieces[0][2]
    n_ce = cfg.codebooks
    nll = [None] * n_ce
    count = None
    stats = []
    for coords, rows, dev in pieces:
        def part(key):
            t = batch.get(key)
            return t if rows is None else _rows(t, *rows, dev)
        with at_coords(coords):
            frontend = part("frontend")
            hidden, _, a = _forward_shard(
                params, cfg, tokens=part("tokens"), frontend=frontend,
                mode="train", caches=None, positions=None, cache_len=None,
                return_hidden=True)
            if frontend is not None:
                hidden = hidden[:, frontend.shape[1]:]
            targets, mask = part("targets"), part("mask")
            kw = dict(logit_scale=cfg.logit_scale,
                      softcap=cfg.logits_softcap)
            for i in range(n_ce):
                if cfg.codebooks > 1:
                    w = params["heads"]["unembedding"][i]    # (D, V)
                    ti, tied = targets[..., i], False
                elif cfg.tie_embeddings:
                    w, ti, tied = params["embed"]["embedding"], targets, True
                else:
                    w, ti, tied = (params["unembed"]["unembedding"],
                                   targets, False)
                n_i, m_i = L.ce_sums(hidden, w, ti, mask, tied=tied, **kw)
                nll[i] = n_i.to(home) if nll[i] is None \
                    else nll[i] + n_i.to(home)
                if i == 0:
                    count = m_i.to(home) if count is None \
                        else count + m_i.to(home)
        stats.append(a)
    aux = _aux(cfg, stats, home)
    denom = torch.clamp_min(count, 1.0)
    if cfg.codebooks > 1:
        ce = sum(n / denom for n in nll) / cfg.codebooks
    else:
        ce = nll[0] / denom
    return ce + cfg.moe_aux_coef * aux, {"ce": ce, "moe_aux": aux}


def prefill(params, cfg: ModelConfig, tokens: Tensor, *, cache_len: int,
            frontend: Tensor | None = None):
    """Returns (last-position logits (B, V) or (B, CB, V), caches); the
    caches' positions count the frontend's."""
    logits, caches, _ = forward(params, cfg, tokens=tokens,
                                frontend=frontend, mode="prefill",
                                cache_len=cache_len)
    return logits[:, -1], caches


def decode_step(params, cfg: ModelConfig, tokens: Tensor, caches,
                pos: Tensor):
    """One decode step.  tokens: (B,), or (B, CB) with codebooks; pos:
    (B,) absolute positions.  Returns (logits (B, V) or (B, CB, V), new
    caches); the caches passed in are not changed."""
    t = tokens[:, None] if cfg.codebooks == 1 else tokens[:, None, :]
    logits, new_caches, _ = forward(
        params, cfg, tokens=t, mode="decode", caches=caches,
        positions=pos[:, None], cache_len=None)
    return logits[:, 0], new_caches
