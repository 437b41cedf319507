"""The bytes a step moves between mesh positions, counted from its specs
and shapes alone (the dry run's ``collectives``): an LM's
(``lm_collectives``, below) and a detector's (``dcn_collectives``).

The port runs a mesh in one process (``distributed.sharding``): each data
shard runs at its first position, its model shards ``within`` theirs, and
every tensor that crosses between positions goes through
``sharding.move``, which ``sharding.count_crossings`` counts by kind and
by (source, destination).  This module walks the same step layer by
layer, without tensors, under the same rules and mesh, and adds up what
each crossing point moves:

* every param a layer reads (``layers._part``, ``_w``, ``gather``): the
  blocks it needs, each through ``sharding.fetch_crossings`` (an
  all-gather of a block held elsewhere along the split axes, its
  gradient's reduce-scatter back, and the all-reduce of a gradient taken
  away from the one copy the port holds: the data shards' gradient sum);
* the row-parallel partial sums (fp32, activation-sized, from each model
  shard but the data shard's own) and, in the backward, their gradients;
* the vocab combine (each block's max, sum of exponentials and target
  logit, a chunk of rows at a time; the logits' blocks put side by side;
  the embedding's rows summed);
* MoE's expert exchange (the dispatch rows each expert shard takes and
  the outputs it sends back, all-to-all, both ways again in the
  backward), RWKV-6's r/k/v/g blocks where its heads meet, the RG-LRU's
  gate partials and the sequence-parallel attention's rows.

A training step's periods are recomputed in the backward (``remat``), so
their forward crossings count twice, as JAX's rematerialised gathers do;
the cross entropy's chunks likewise.  Activations that every model shard
of a data shard reads (GSPMD replicates them) and the caches (which stay
with their head shards under GSPMD) are moved by the port but are no
collective, and are counted nowhere.  The real step run under
``count_crossings`` on the same mesh must agree with this count kind by
kind (``tests/test_torch_collectives.py``, ``chip_smoke.py`` phase 21).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed.sharding import (CrossingCounter, Mesh,
                                              _block_grid, _position,
                                              at_coords, data_shards,
                                              fetch_crossings,
                                              mesh_axes, position,
                                              shard_coords, use_rules,
                                              within)
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.moe import _capacity, expert_split
from repro_torch.models.rglru import _FP32, _RNN_DIM, rnn_split
from repro_torch.models.rwkv6 import ff_split, head_split

FP32 = 4


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One param as a layer reads it: its shape, spec, dtype's size and
    block grid on the mesh."""
    shape: tuple
    spec: tuple
    itemsize: int
    grid: tuple

    def row(self) -> "_Leaf":
        """A period's slice of a stacked leaf."""
        return _Leaf(self.shape[1:], self.spec[1:], self.itemsize,
                     self.grid[1:])


def _tree(defs, specs, mesh):
    if isinstance(defs, L.ParamDef):
        shape, spec = tuple(defs.shape), tuple(specs)
        return _Leaf(shape, spec,
                     torch.empty((), dtype=defs.dtype).element_size(),
                     _block_grid(shape, spec, mesh))
    return {k: _tree(defs[k], specs[k], mesh) for k in defs}


def _rows(tree):
    if isinstance(tree, _Leaf):
        return tree.row()
    return {k: _rows(v) for k, v in tree.items()}


class _Walk:
    """The crossing points of one step, added into ``counter``."""

    def __init__(self, mesh: Mesh, counter: CrossingCounter, *, grad: bool,
                 act: int):
        self.mesh, self.c, self.grad, self.act = mesh, counter, grad, act
        self.times = 1              # forward runs (2 where recomputed)

    # -- params ---------------------------------------------------------
    def fetch(self, leaf: _Leaf, size: int | None = None,
              fixed: dict | None = None) -> None:
        """``leaf``'s blocks (those at ``fixed`` {dim: block} along the
        fixed dimensions) read at the current position in ``size`` bytes
        an element (None: its own dtype)."""
        if all(n == 1 for n in leaf.grid) and not self.grad:
            # Held whole at the first position, a copy with every shard:
            # only a gradient crosses (``gather`` of a plain leaf).
            return
        size = leaf.itemsize if size is None else size
        dst = position()
        fixed = fixed or {}
        ranges = [[fixed[d]] if d in fixed else range(n)
                  for d, n in enumerate(leaf.grid)]
        nbytes = size * math.prod(
            d // n for d, n in zip(leaf.shape, leaf.grid))
        for index in np.ndindex(*(len(r) for r in ranges)):
            idx = tuple(r[i] for r, i in zip(ranges, index))
            fwd, back = fetch_crossings(leaf.spec, self.mesh, idx, dst)
            if fwd is not None:
                for _ in range(self.times):
                    self.c.add(*fwd, nbytes)
            if self.grad:
                for b in back:
                    self.c.add(*b, nbytes)

    def part(self, leaf: _Leaf, dim: int, lo: int, size: int,
             dt: int | None = None) -> None:
        """``layers._part``: the block along ``dim`` where ``leaf`` is
        placed in blocks of ``size`` there, else the whole leaf."""
        bs = leaf.shape[dim] // leaf.grid[dim]
        if leaf.grid[dim] > 1 and bs == size and lo % size == 0:
            self.fetch(leaf, dt, {dim: lo // size})
        else:
            self.fetch(leaf, dt)

    def whole(self, tree, dt: int | None = None) -> None:
        if isinstance(tree, _Leaf):
            self.fetch(tree, dt)
        else:
            for v in tree.values():
                self.whole(v, dt)

    # -- activations ----------------------------------------------------
    def to_here(self, kind: str, coords: dict, nbytes: int,
                grad: bool | None = None) -> None:
        """A shard's tensor of ``nbytes`` moved to the current position
        (``layers._to_here``); its gradient back in the backward."""
        src, dst = position(coords), position()
        if src == dst:
            return
        for _ in range(self.times):
            self.c.add(kind, src, dst, nbytes)
        if self.grad if grad is None else grad:
            back = {"all-gather": "reduce-scatter"}.get(kind, kind)
            self.c.add(back, dst, src, nbytes)

    def partials(self, shards, nbytes: int) -> None:
        """``layers._sum_partials`` of fp32 partials of ``nbytes``."""
        for coords in shards:
            self.to_here("all-reduce", coords, nbytes)

    # -- layers ---------------------------------------------------------
    def norm(self, p) -> None:
        self.whole(p)

    def attention(self, p, cfg: L.AttnConfig, b: int, s: int,
                  decode: bool) -> None:
        act, d = self.act, cfg.d_model
        shards = L._head_shards(cfg)
        if shards is not None:
            for sh in shards:
                with within(sh.coords):
                    kv = (sh.kv_lo, sh.nkv)
                    self.part(p["wq"], 1, sh.q_lo, sh.nq, act)
                    self.part(p["wk"], 1, *kv, act)
                    self.part(p["wv"], 1, *kv, act)
                    self.part(p["wo"], 0, sh.q_lo, sh.nq, act)
                    if "bq" in p:
                        self.part(p["bq"], 0, sh.q_lo, sh.nq, act)
                        self.part(p["bk"], 0, *kv, act)
                        self.part(p["bv"], 0, *kv, act)
                    if "q_norm" in p:
                        self.fetch(p["q_norm"])
                        self.fetch(p["k_norm"])
            self.partials([sh.coords for sh in shards], b * s * d * FP32)
        else:
            for k in ("wq", "wk", "wv", "bq", "bk", "bv"):
                if k in p:
                    self.fetch(p[k], act)
            for k in ("q_norm", "k_norm"):
                if k in p:
                    self.fetch(p[k])
            if not decode and L.seq_parallel_attention(cfg):
                _, axes, n = mesh_axes("heads")
                for j in range(n):
                    lo = j * (s // n) + min(j, s % n)
                    rows = s // n + (j < s % n)
                    if not rows:
                        continue
                    coords = shard_coords(axes, j)
                    with within(coords):
                        self.fetch(p["wo"], act)
                    self.to_here("all-gather", coords, b * rows * d * act)
            else:
                self.fetch(p["wo"], act)
        if "bo" in p:
            self.fetch(p["bo"], act)

    def mlp(self, p, cfg: L.MLPConfig, b: int, s: int) -> None:
        act = self.act
        _, axes, n = mesh_axes("ff")
        if n > 1 and cfg.d_ff % n == 0:
            f = cfg.d_ff // n
            shards = [shard_coords(axes, j) for j in range(n)]
            for j, coords in enumerate(shards):
                with within(coords):
                    for k, dim in L._FF_DIM.items():
                        if k in p:
                            self.part(p[k], dim, j * f, f, act)
            self.partials(shards, b * s * cfg.d_model * FP32)
        else:
            for k in ("w_gate", "w_up", "w_in", "b_in", "w_out"):
                if k in p:
                    self.fetch(p[k], act)
        if "b_out" in p:
            self.fetch(p["b_out"], act)

    def moe(self, p, cfg, b: int, s: int, decode: bool) -> None:
        act = self.act
        e, k, d = cfg.num_experts, cfg.top_k, cfg.d_model
        cap = s * k if decode else _capacity(s, cfg)
        self.fetch(p["w_router"], act)
        names = [n for n in ("w_gate", "w_up", "w_in") if n in p] \
            + ["w_out"]
        how, axes, n = expert_split(cfg)
        if how == "whole":
            for name in names:
                self.fetch(p[name], act)
            return
        shards = [shard_coords(axes, j) for j in range(n)]
        if how == "ff":
            f = cfg.d_ff // n
            for j, coords in enumerate(shards):
                with within(coords):
                    for name in names:
                        self.part(p[name], 1 if name == "w_out" else 2,
                                  j * f, f, act)
            self.partials(shards, b * e * cap * d * FP32)
            return
        el = e // n
        rows = b * el * cap * d * act
        for j, coords in enumerate(shards):
            with within(coords):
                for name in names:
                    self.part(p[name], 0, j * el, el, act)
            # The expert exchange: the shard's dispatch rows out, its
            # outputs back, both again in the backward.
            self.to_here("all-to-all", coords, rows)
            self.to_here("all-to-all", coords, rows)

    def rglru(self, p, cfg, b: int, s: int) -> None:
        split = rnn_split(cfg)
        if split is None:
            self.whole(p)
            return
        axes, n = split
        r, act = cfg.d_rnn // n, self.act
        shards = [shard_coords(axes, j) for j in range(n)]
        for j, coords in enumerate(shards):
            with within(coords):
                for k, dim in _RNN_DIM.items():
                    self.part(p[k], dim, j * r, r,
                              None if k in _FP32 else act)
        self.partials(shards, b * s * cfg.d_rnn * FP32)       # w_a
        self.partials(shards, b * s * cfg.d_rnn * FP32)       # w_x
        self.partials(shards, b * s * cfg.d_model * FP32)     # w_out

    def time_mix(self, p, cfg, b: int, t: int) -> None:
        split = head_split(cfg)
        if split is None:
            self.whole(p)
            return
        axes, n, whole_heads = split
        act, w, d = self.act, cfg.d_model // n, cfg.d_model
        for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_w0",
                  "decay_A", "decay_B"):
            self.fetch(p[k])
        shards = [shard_coords(axes, j) for j in range(n)]
        for j, coords in enumerate(shards):
            with within(coords):
                for k in ("w_r", "w_k", "w_v", "w_g"):
                    self.part(p[k], 1, j * w, w, act)
                if whole_heads:
                    self.part(p["bonus_u"], 0, j * w, w)
                    self.part(p["ln_x"], 0, j * w, w)
                    self.part(p["w_o"], 0, j * w, w, act)
            if not whole_heads:
                for _ in range(4):
                    self.to_here("all-gather", coords, b * t * w * act)
        if not whole_heads:
            self.fetch(p["bonus_u"])
            self.fetch(p["ln_x"])
            for j, coords in enumerate(shards):
                with within(coords):
                    self.part(p["w_o"], 0, j * w, w, act)
        self.partials(shards, b * t * d * FP32)

    def channel_mix(self, p, cfg, b: int, t: int) -> None:
        split = ff_split(cfg)
        if split is None:
            self.whole(p)
            return
        axes, n = split
        act, f = self.act, cfg.d_ff // n
        self.fetch(p["mu_k"])
        self.fetch(p["mu_r"])
        shards = [shard_coords(axes, j) for j in range(n)]
        for j, coords in enumerate(shards):
            with within(coords):
                self.part(p["w_k"], 1, j * f, f, act)
                self.part(p["w_v"], 0, j * f, f, act)
        self.partials(shards, b * t * cfg.d_model * FP32)
        self.fetch(p["w_r"], act)

    def layer(self, p, cfg: TT.ModelConfig, kind: str, b: int, s: int,
              decode: bool) -> None:
        self.norm(p["norm1"])
        if kind == "attn":
            self.attention(p["attn"], cfg.attn_cfg(), b, s, decode)
            if not cfg.parallel_block:
                self.norm(p["norm2"])
            if cfg.moe is not None:
                self.moe(p["ffn"], cfg.moe, b, s, decode)
            else:
                self.mlp(p["ffn"], cfg.mlp_cfg(), b, s)
        elif kind == "rwkv6":
            self.time_mix(p["tm"], cfg.rwkv, b, s)
            self.norm(p["norm2"])
            self.channel_mix(p["cm"], cfg.rwkv, b, s)
        else:
            self.rglru(p["rec"], cfg.rglru, b, s)
            self.norm(p["norm2"])
            self.mlp(p["ffn"], cfg.mlp_cfg(), b, s)

    def embed_rows(self, emb: _Leaf, b: int, s: int, d: int) -> None:
        shards = L._vocab_shards(emb.shape[0])
        if shards is None:
            self.fetch(emb)
            return
        for lo, vn, coords in shards:
            with within(coords):
                self.part(emb, 0, lo, vn)
            self.to_here("all-reduce", coords, b * s * d * self.act)

    def vocab_logits(self, w: _Leaf, b: int, s: int, tied: bool) -> None:
        vdim = 0 if tied else 1
        shards = L._vocab_shards(w.shape[vdim])
        if shards is None:
            self.fetch(w, self.act)
            return
        for lo, vn, coords in shards:
            with within(coords):
                self.part(w, vdim, lo, vn, self.act)
            self.to_here("all-gather", coords, b * s * vn * FP32)

    def ce(self, w: _Leaf, b: int, s: int, tied: bool,
           chunk: int = 1024) -> None:
        """``layers.ce_sums``: the blocks' weights once, then each
        chunk's combine (recomputed in the backward)."""
        vdim = 0 if tied else 1
        shards = L._vocab_shards(w.shape[vdim])
        if shards is None:
            self.fetch(w, self.act)
            return
        for lo, vn, coords in shards:
            with within(coords):
                self.part(w, vdim, lo, vn, self.act)
        n_chunks = -(-s // chunk)
        times, self.times = self.times, 2 if self.grad else 1
        for _ in range(n_chunks):
            for _, _, coords in shards:
                # max (no gradient), sum of exponentials, target logit
                self.to_here("all-reduce", coords, b * chunk * FP32,
                             grad=False)
                self.to_here("all-reduce", coords, b * chunk * FP32)
                self.to_here("all-reduce", coords, b * chunk * FP32)
        self.times = times


def lm_collectives(cfg: TT.ModelConfig, mesh: Mesh, *, mode: str,
                   batch: int, seq: int, rules=None, micro: int = 1,
                   frontend: int = 0) -> CrossingCounter:
    """The crossings of one LM step on ``mesh`` under ``rules``:
    ``mode`` 'train' (``loss_fn`` and its gradient, ``micro``
    microbatches), 'forward' (the logits, no gradient), 'prefill' or
    'decode' (one token a row); ``frontend`` prepended positions."""
    counter = CrossingCounter()
    grad = mode == "train"
    decode = mode == "decode"
    with use_rules(rules, mesh=mesh):
        defs = TT.param_defs(cfg)
        tree = _tree(defs, L.spec_tree(defs), mesh)
        walk = _Walk(mesh, counter, grad=grad,
                     act=torch.empty((), dtype=cfg.dtype).element_size())
        rows = batch // micro
        shards = data_shards(rows) or [({}, 0, rows)]
        s = 1 if decode else seq + frontend
        one = walk.c = CrossingCounter()        # one microbatch
        for coords, lo, hi in shards:
            with at_coords(coords):
                _lm_shard(walk, tree, cfg, hi - lo, s, seq, mode)
        counter.merge(one, micro)
    return counter


def _lm_shard(walk: _Walk, tree, cfg: TT.ModelConfig, b: int, s: int,
              seq: int, mode: str) -> None:
    d = cfg.d_model
    decode = mode == "decode"
    t = 1 if decode else seq                  # text tokens
    if cfg.codebooks > 1:
        emb = tree["embed"]["embedding"]
        for _ in range(cfg.codebooks):
            walk.embed_rows(emb.row(), b, t, d)
    else:
        walk.embed_rows(tree["embed"]["embedding"], b, t, d)
    for i, kind in enumerate(cfg.prefix):
        walk.layer(tree[f"prefix{i}"], cfg, kind, b, s, decode)
    # The periods cross alike: one period's count, n_periods times.
    per, main = _rows(tree["layers"]), walk.c
    walk.times = 2 if walk.grad and cfg.remat != "none" else 1
    walk.c = CrossingCounter()
    for j, kind in enumerate(cfg.pattern):
        walk.layer(per[f"m{j}"], cfg, kind, b, s, decode)
    main.merge(walk.c, cfg.n_periods)
    walk.c, walk.times = main, 1
    walk.norm(tree["final_norm"])
    if mode == "train":
        if cfg.codebooks > 1:
            heads = tree["heads"]["unembedding"]
            for _ in range(cfg.codebooks):
                walk.ce(heads.row(), b, t, tied=False)
        elif cfg.tie_embeddings:
            walk.ce(tree["embed"]["embedding"], b, t, tied=True)
        else:
            walk.ce(tree["unembed"]["unembedding"], b, t, tied=False)
        return
    s_out = 1 if mode == "prefill" else s
    if cfg.codebooks > 1:
        heads = tree["heads"]["unembedding"]
        placed = any(n > 1 for n in heads.grid)
        if placed or L._vocab_shards(cfg.vocab) is not None:
            for _ in range(cfg.codebooks):
                walk.vocab_logits(heads.row(), b, s_out, tied=False)
        else:
            walk.fetch(heads, walk.act)
    elif cfg.tie_embeddings:
        walk.vocab_logits(tree["embed"]["embedding"], b, s_out, tied=True)
    else:
        walk.vocab_logits(tree["unembed"]["unembedding"], b, s_out,
                          tied=False)


def spatial_collectives(*, batch_blocks: int, block_rows: int, shards: int,
                        width: int, channels: int, itemsize: int, halo: int,
                        backward: bool = False) -> dict:
    """``distributed.spatial``'s exchange of one height-sharded DCL call
    (``batch_blocks`` blocks of ``block_rows`` images): each shard gets
    ``halo`` rows of (W, C) from each neighbour (a collective-permute);
    the backward exchanges again and sends each halo's gradient rows back
    (``halo - 1`` up, ``halo`` down)."""
    c = CrossingCounter()
    edge = block_rows * width * channels * itemsize
    for blk in range(batch_blocks):
        for i in range(shards - 1):
            up, down = ((blk, i + 1), (blk, i)), ((blk, i), (blk, i + 1))
            for _ in range(2 if backward else 1):
                c.add("collective-permute", *up, halo * edge)
                c.add("collective-permute", *down, halo * edge)
            if backward:
                if halo > 1:
                    c.add("collective-permute", *up, (halo - 1) * edge)
                c.add("collective-permute", *down, halo * edge)
    return c.summary()


def dcn_collectives(cfg, mesh: Mesh, *, batch: int, train: bool
                    ) -> CrossingCounter:
    """A detector step's crossings.  Under a mesh whose 'batch' axes
    divide the batch, every data shard runs the whole network
    (``models.resnet_dcn``) on a copy of every param (GSPMD replicates
    them; the port fetches each from the one it holds at the first
    position, ``sharding.gather``), so a training step sends every leaf's
    gradient, in the leaf's dtype (fp32), from each data shard's position
    but the first back to it: an all-reduce.  Inference moves no param.
    The shards' rows, outputs and loss sums (a few scalars a shard) move
    with ``.to`` and are counted nowhere: under GSPMD the batch already
    lies on its shards.  A QAT config, trained on absmax scales, keeps
    the batch whole and splits only its bounded DCLs' kernel calls: each
    DCL's d_weights (fp32 (K*K, C, M)) summed from the batch shards
    (``ops``' ``BatchShardedDeformConv``).  The registry's cells shard no
    height, so no halo crosses (``spatial_collectives``)."""
    from repro_torch.models import resnet_dcn as R
    from repro_torch.serve.dcl_engine import bucket_layer_dims
    counter = CrossingCounter()
    with use_rules(mesh=mesh):
        shards = data_shards(batch)
        if not train or cfg.shard_batch is False or shards is None:
            return counter
        whole = R._data_shards(cfg, batch) is None
    pos = [_position(mesh, coords) for coords, _, _ in shards]
    if whole:
        if cfg.offset_bound is None or not cfg.use_kernel:
            return counter
        for dims in bucket_layer_dims(cfg, cfg.img_size).values():
            for at in pos[1:]:
                # 3 x 3 taps (``dcl_apply``'s kernel size)
                counter.add("all-reduce", at, pos[0],
                            9 * dims["c"] * dims["m"] * FP32)
        return counter
    leaves = T.leaves(R.model_def(cfg))
    for at in pos[1:]:
        for d in leaves:
            counter.add("all-reduce", at, pos[0], math.prod(d.shape)
                        * torch.empty((), dtype=d.dtype).element_size())
    return counter
