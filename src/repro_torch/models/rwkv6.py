"""RWKV-6 "Finch" blocks (arXiv:2404.05892), the counterpart of
``repro.models.rwkv6``: attention-free time mixing with data-dependent
decay, and the squared-ReLU channel mix.

The same two simplifications as the JAX package: static token-shift lerp
coefficients (the decay LoRA is in full), and the log-decay clamped to
[-2.5, -1e-6], so the chunked scan's exp-factorised form stays in fp32
range (chunk 32: exponents up to 80).

``wkv_chunked`` keeps JAX's form within a chunk: (chunk, chunk) masked
decay-weighted scores, the bonus term, and each chunk's decayed
key-value sum ``kv_end``.  The state crosses the chunks in a Python loop
(64 steps a layer at S = 2048, one fused multiply-add each) where JAX
runs ``lax.scan``; each chunk's contribution from the carried state is
then one batched product.  The scan and its state are fp32.

Under an active mesh the blocks run per model shard, as JAX's hints ask
(the flat channel dimension split as 'heads', the channel mix's as
'ff'): the r, k, v and g projections take column blocks of the channels,
and where the 'heads' axes split whole heads each shard runs the WKV and
the per-head norm on its heads and ``w_o`` is row-parallel.  Where a
block of channels ends inside a head (rwkv6-3b's 40 heads on a 16-way
axis: 2.5 heads a shard) the shards' r, k, v and g blocks meet, the WKV
runs whole, and the gated output splits again for ``w_o``.  The decay's
low-rank product runs whole (``decay_A`` is FSDP over 'embed' only,
``decay_B`` replicated).  The channel mix runs per ``ff`` block
(``w_k`` by columns, ``w_v`` row-parallel); ``w_r`` is whole.  Row-
parallel partials are fp32, summed once (``layers._sum_partials``).  The
WKV state stays whole; each head shard reads and writes its heads.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (gather, gather_tree,
                                              mesh_axes, shard_coords,
                                              shard_device, within)
from repro_torch.models.layers import (ParamDef, _part, _row_parallel,
                                       _sum_partials, _to_here, rms_norm)

Tensor = torch.Tensor

LOG_DECAY_MIN = -2.5
LOG_DECAY_MAX = -1e-6
CHUNK = 32


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    d_ff: int
    head_dim: int = 64
    decay_lora_rank: int = 64

    @property
    def n_heads(self) -> int:
        assert self.d_model % self.head_dim == 0
        return self.d_model // self.head_dim


def time_mix_def(cfg: RWKVConfig) -> dict[str, ParamDef]:
    d, r = cfg.d_model, cfg.decay_lora_rank
    return {
        "mu_r": ParamDef((d,), (None,), init="zeros"),
        "mu_k": ParamDef((d,), (None,), init="zeros"),
        "mu_v": ParamDef((d,), (None,), init="zeros"),
        "mu_w": ParamDef((d,), (None,), init="zeros"),
        "mu_g": ParamDef((d,), (None,), init="zeros"),
        "w_r": ParamDef((d, d), ("embed", "heads")),
        "w_k": ParamDef((d, d), ("embed", "heads")),
        "w_v": ParamDef((d, d), ("embed", "heads")),
        "w_g": ParamDef((d, d), ("embed", "heads")),
        "w_o": ParamDef((d, d), ("heads", "embed")),
        # data-dependent decay: lw = -exp(w0 + tanh(x @ A) @ B)
        "decay_w0": ParamDef((d,), (None,), init="zeros"),
        "decay_A": ParamDef((d, r), ("embed", None), scale=0.01),
        "decay_B": ParamDef((r, d), (None, None), scale=0.01),
        "bonus_u": ParamDef((d,), (None,), init="zeros"),
        "ln_x": ParamDef((d,), (None,), init="zeros"),  # per-head norm scale
    }


def channel_mix_def(cfg: RWKVConfig) -> dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDef((d,), (None,), init="zeros"),
        "mu_r": ParamDef((d,), (None,), init="zeros"),
        "w_k": ParamDef((d, f), ("embed", "ff")),
        "w_v": ParamDef((f, d), ("ff", "embed")),
        "w_r": ParamDef((d, d), ("embed", None)),
    }


def _token_shift(x: Tensor, prev: Tensor | None) -> Tensor:
    """x_{t-1} with an optional carried state for the first position."""
    first = x.new_zeros(x[:, :1].shape) if prev is None \
        else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], 1)


def _lerp(x: Tensor, x_prev: Tensor, mu: Tensor) -> Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)


def _log_decay(params, xw: Tensor) -> Tensor:
    lora = torch.tanh(xw @ params["decay_A"].to(xw.dtype)) \
        @ params["decay_B"].to(xw.dtype)
    raw = params["decay_w0"].float() + lora.float()
    return torch.clamp(-torch.exp(raw), LOG_DECAY_MIN, LOG_DECAY_MAX)


def wkv_chunked(r: Tensor, k: Tensor, v: Tensor, lw: Tensor, u: Tensor,
                state: Tensor | None = None,
                chunk: int = CHUNK) -> tuple[Tensor, Tensor]:
    """Chunked WKV scan.

    r, k, v: (B, S, H, Dh); lw: (B, S, H, Dh) log-decay (<= 0); u: (H, Dh).
    state: (B, H, Dh, Dh) initial [key, value] state.
    Returns (out (B, S, H, Dh) fp32, final state fp32).

    o_t = r_t @ S_{t-1} + (r_t . (u*k_t)) v_t
    S_t = diag(exp(lw_t)) S_{t-1} + k_t (x) v_t
    """
    b, s, h, dh = r.shape
    assert s % chunk == 0, (s, chunk)
    n = s // chunk
    rf, kf, vf, lwf = (t.float().reshape(b, n, chunk, h, dh)
                       for t in (r, k, v, lw))

    c_incl = torch.cumsum(lwf, 2)                    # c_j (inclusive)
    c_excl = c_incl - lwf                            # c_{j-1}
    c_tot = c_incl[:, :, -1:]                        # chunk total

    r_in = rf * torch.exp(c_excl)                    # r'_i
    k_out = kf * torch.exp(-c_incl)                  # k'_j (bounded by clamp)
    k_end = kf * torch.exp(c_tot - c_incl)           # decay to chunk end

    # intra-chunk scores: A[i, j] = r'_i . k'_j for j < i, bonus at j == i.
    scores = torch.einsum("bnihd,bnjhd->bnhij", r_in, k_out)
    scores = scores * torch.tril(torch.ones(chunk, chunk, device=r.device),
                                 -1)
    bonus = (rf * u.float() * kf).sum(-1)            # (B, n, chunk, H)
    o_intra = torch.einsum("bnhij,bnjhd->bnihd", scores, vf) \
        + bonus[..., None] * vf

    # inter-chunk: carry S across chunks; keep the state each chunk sees.
    kv_end = torch.einsum("bnjhd,bnjhe->bnhde", k_end, vf)
    decay = torch.exp(c_tot[:, :, 0])[..., None]     # (B, n, H, Dh, 1)
    S = state.float() if state is not None else \
        r.new_zeros((b, h, dh, dh), dtype=torch.float32)
    seen = []
    for i in range(n):
        seen.append(S)
        S = decay[:, i] * S + kv_end[:, i]
    o_inter = torch.einsum("bnihd,bnhde->bnihe", r_in, torch.stack(seen, 1))
    return (o_intra + o_inter).reshape(b, s, h, dh), S


def wkv_step(r: Tensor, k: Tensor, v: Tensor, lw: Tensor, u: Tensor,
             state: Tensor) -> tuple[Tensor, Tensor]:
    """Single-token recurrence (decode).  r, k, v, lw: (B, H, Dh)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    bonus = (rf * u.float() * kf).sum(-1, keepdim=True)
    out = torch.einsum("bhd,bhde->bhe", rf, state) + bonus * vf
    state = torch.exp(lw.float())[..., None] * state \
        + kf[..., :, None] * vf[..., None, :]
    return out, state


def _projections(params, x: Tensor, xp: Tensor, shape):
    """r, k, v, the gate and the log-decay of time mixing, each reshaped
    to ``shape`` (heads last but one)."""
    xr, xk, xv, xw, xg = (_lerp(x, xp, params[f"mu_{c}"]) for c in "rkvwg")
    r = (xr @ params["w_r"].to(x.dtype)).reshape(shape)
    k = (xk @ params["w_k"].to(x.dtype)).reshape(shape)
    v = (xv @ params["w_v"].to(x.dtype)).reshape(shape)
    g = F.silu(xg @ params["w_g"].to(x.dtype)).reshape(shape)
    lw = _log_decay(params, xw).reshape(shape)
    return r, k, v, g, lw


def _mix_out(params, o: Tensor, g: Tensor, x: Tensor, cfg: RWKVConfig):
    """Per-head group norm, then the gate and the output projection."""
    o = rms_norm(o.to(x.dtype), params["ln_x"].reshape(cfg.n_heads,
                                                        cfg.head_dim))
    return (o * g).reshape(x.shape) @ params["w_o"].to(x.dtype)


def head_split(cfg: RWKVConfig) -> tuple[tuple[str, ...], int, bool] | None:
    """``(axes, n, whole_heads)`` of the channel blocks of time mixing
    under the active mesh, or None (off-mesh, one block, or D does not
    divide)."""
    _, axes, n = mesh_axes("heads")
    if n == 1 or cfg.d_model % n:
        return None
    return axes, n, cfg.n_heads % n == 0


def ff_split(cfg: RWKVConfig) -> tuple[tuple[str, ...], int] | None:
    """``(axes, n)`` of the channel mix's ``ff`` blocks, or None."""
    _, axes, n = mesh_axes("ff")
    return (axes, n) if n > 1 and cfg.d_ff % n == 0 else None


def _time_mix(params, x: Tensor, xp: Tensor, cfg: RWKVConfig, wkv,
              state: Tensor | None):
    """Time mixing of x (B, T, D) with token-shifted ``xp``; ``wkv(r, k,
    v, lw, u, state)`` on (B, T, H', Dh) returns (out fp32, new state).
    Returns (y, new WKV state)."""
    b, t, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    split = head_split(cfg)
    if split is None:
        p = gather_tree(params, x.device)
        r, k, v, g, lw = _projections(p, x, xp, (b, t, h, dh))
        o, S = wkv(r, k, v, lw, p["bonus_u"].reshape(h, dh), state)
        return _mix_out(p, o, g, x, cfg), S
    axes, n, whole_heads = split
    home, dt, w = x.device, x.dtype, d // n
    small = {k: gather(params[k], device=home)
             for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_w0",
                       "decay_A", "decay_B")}
    xr, xk, xv, xw, xg = (_lerp(x, xp, small[f"mu_{c}"]) for c in "rkvwg")
    lw = _log_decay(small, xw)                                # (B, T, D)
    shards = [(shard_coords(axes, j), j * w) for j in range(n)]
    blocks, states = [], []
    for coords, lo in shards:
        with within(coords):
            dev = shard_device()
            r, k, v, g = (
                a.to(dev) @ _part(params[name], 1, lo, w, dev, dt)
                for a, name in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v"),
                                (xg, "w_g")))
            g = F.silu(g)
            if whole_heads:
                hn, h0 = w // dh, lo // dh
                r, k, v, g = (a.reshape(b, t, hn, dh) for a in (r, k, v, g))
                u = _part(params["bonus_u"], 0, lo, w, dev).reshape(hn, dh)
                o, S = wkv(r, k, v, lw[..., lo:lo + w].to(dev).reshape(
                    b, t, hn, dh), u, None if state is None
                    else state[:, h0:h0 + hn].to(dev))
                ln = _part(params["ln_x"], 0, lo, w, dev).reshape(hn, dh)
                og = (rms_norm(o.to(dt), ln) * g).reshape(b, t, w)
                blocks.append(_row_parallel(
                    "btc,cd->btd", og,
                    _part(params["w_o"], 0, lo, w, dev, dt)))
        if whole_heads:
            states.append(S.to(home))
        else:
            blocks.append(tuple(_to_here(a, coords, home, "all-gather")
                                for a in (r, k, v, g)))
    if whole_heads:
        return (_sum_partials(list(zip((c for c, _ in shards), blocks)), dt,
                              home), torch.cat(states, 1))
    # The heads meet: the WKV and the norm whole, w_o per block again.
    r, k, v, g = (torch.cat(parts, -1).reshape(b, t, h, dh)
                  for parts in zip(*blocks))
    u = gather(params["bonus_u"], device=home).reshape(h, dh)
    o, S = wkv(r, k, v, lw.reshape(b, t, h, dh), u, state)
    ln = gather(params["ln_x"], device=home).reshape(h, dh)
    og = (rms_norm(o.to(dt), ln) * g).reshape(b, t, d)
    parts = []
    for coords, lo in shards:
        with within(coords):
            dev = shard_device()
            parts.append((coords, _row_parallel(
                "btc,cd->btd", og[..., lo:lo + w].to(dev),
                _part(params["w_o"], 0, lo, w, dev, dt))))
    return _sum_partials(parts, dt, home), S


def _chunked_wkv(s: int, chunk: int):
    """``_time_mix``'s WKV of a full sequence of ``s`` tokens: padded to
    a multiple of ``chunk`` with k = v = 0 and lw = 0 (decay 1), so the
    final state is the unpadded one."""
    def run(r, k, v, lw, u, state):
        pad = (-s) % chunk
        if pad:
            r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                           for a in (r, k, v, lw))
        o, S = wkv_chunked(r, k, v, lw, u, state=state, chunk=chunk)
        return o[:, :s], S
    return run


def _step_wkv(r, k, v, lw, u, state):
    """``_time_mix``'s WKV of one token (T = 1)."""
    o, S = wkv_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0], u, state.float())
    return o[:, None], S


def time_mix_apply(params, x: Tensor, cfg: RWKVConfig, *,
                   shift_state: Tensor | None = None,
                   wkv_state: Tensor | None = None, chunk: int = CHUNK):
    """x: (B, S, D).  Returns (y, (new_shift_state, new_wkv_state)).  A
    sequence that is not a multiple of ``chunk`` is padded with k = v = 0
    and lw = 0 (decay 1), so the final state is the unpadded one."""
    y, S = _time_mix(params, x, _token_shift(x, shift_state), cfg,
                     _chunked_wkv(x.shape[1], chunk), wkv_state)
    return y, (x[:, -1], S)


def time_mix_step(params, x: Tensor, cfg: RWKVConfig, *,
                  shift_state: Tensor, wkv_state: Tensor):
    """Decode: x (B, D) one token.  Returns (y, (shift, wkv))."""
    y, S = _time_mix(params, x[:, None], shift_state.to(x.dtype)[:, None],
                     cfg, _step_wkv, wkv_state)
    return y[:, 0], (x, S)


def _channel_mix(params, x: Tensor, xp: Tensor, cfg: RWKVConfig) -> Tensor:
    split = ff_split(cfg)
    if split is None:
        p = gather_tree(params, x.device)
        xk = _lerp(x, xp, p["mu_k"])
        xr = _lerp(x, xp, p["mu_r"])
        kv = F.relu(xk @ p["w_k"].to(x.dtype)).square() \
            @ p["w_v"].to(x.dtype)
        return torch.sigmoid(xr @ p["w_r"].to(x.dtype)) * kv
    axes, n = split
    home, dt, f = x.device, x.dtype, cfg.d_ff // n
    xk = _lerp(x, xp, gather(params["mu_k"], device=home))
    xr = _lerp(x, xp, gather(params["mu_r"], device=home))
    parts = []
    for j in range(n):
        coords = shard_coords(axes, j)
        with within(coords):
            dev = shard_device()
            hk = F.relu(xk.to(dev) @ _part(params["w_k"], 1, j * f, f, dev,
                                           dt)).square()
            parts.append((coords, _row_parallel(
                "...f,fd->...d", hk, _part(params["w_v"], 0, j * f, f, dev,
                                         dt))))
    kv = _sum_partials(parts, dt, home)
    return torch.sigmoid(xr @ gather(params["w_r"], device=home,
                                     dtype=dt)) * kv


def channel_mix_apply(params, x: Tensor, cfg: RWKVConfig, *,
                      shift_state: Tensor | None = None):
    """x: (B, S, D).  Returns (y, new_shift_state)."""
    return _channel_mix(params, x, _token_shift(x, shift_state), cfg), \
        x[:, -1]


def channel_mix_step(params, x: Tensor, cfg: RWKVConfig, *,
                     shift_state: Tensor):
    """Decode: x (B, D).  Returns (y, new_shift_state)."""
    return _channel_mix(params, x, shift_state.to(x.dtype), cfg), x
