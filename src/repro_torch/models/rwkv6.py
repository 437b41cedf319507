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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, rms_norm

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


def time_mix_apply(params, x: Tensor, cfg: RWKVConfig, *,
                   shift_state: Tensor | None = None,
                   wkv_state: Tensor | None = None, chunk: int = CHUNK):
    """x: (B, S, D).  Returns (y, (new_shift_state, new_wkv_state)).  A
    sequence that is not a multiple of ``chunk`` is padded with k = v = 0
    and lw = 0 (decay 1), so the final state is the unpadded one."""
    b, s, _ = x.shape
    shape = (b, s, cfg.n_heads, cfg.head_dim)
    r, k, v, g, lw = _projections(params, x, _token_shift(x, shift_state),
                                  shape)
    pad = (-s) % chunk
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    u = params["bonus_u"].reshape(cfg.n_heads, cfg.head_dim)
    o, S = wkv_chunked(r, k, v, lw, u, state=wkv_state, chunk=chunk)
    return _mix_out(params, o[:, :s], g, x, cfg), (x[:, -1], S)


def time_mix_step(params, x: Tensor, cfg: RWKVConfig, *,
                  shift_state: Tensor, wkv_state: Tensor):
    """Decode: x (B, D) one token.  Returns (y, (shift, wkv))."""
    shape = (x.shape[0], cfg.n_heads, cfg.head_dim)
    r, k, v, g, lw = _projections(params, x, shift_state.to(x.dtype), shape)
    u = params["bonus_u"].reshape(cfg.n_heads, cfg.head_dim)
    o, S = wkv_step(r, k, v, lw, u, wkv_state.float())
    return _mix_out(params, o, g, x, cfg), (x, S)


def _channel_mix(params, x: Tensor, xp: Tensor) -> Tensor:
    xk = _lerp(x, xp, params["mu_k"])
    xr = _lerp(x, xp, params["mu_r"])
    kv = F.relu(xk @ params["w_k"].to(x.dtype)).square() \
        @ params["w_v"].to(x.dtype)
    return torch.sigmoid(xr @ params["w_r"].to(x.dtype)) * kv


def channel_mix_apply(params, x: Tensor, cfg: RWKVConfig, *,
                      shift_state: Tensor | None = None):
    """x: (B, S, D).  Returns (y, new_shift_state)."""
    return _channel_mix(params, x, _token_shift(x, shift_state)), x[:, -1]


def channel_mix_step(params, x: Tensor, cfg: RWKVConfig, *,
                     shift_state: Tensor):
    """Decode: x (B, D).  Returns (y, new_shift_state)."""
    return _channel_mix(params, x, shift_state.to(x.dtype)), x
