"""RG-LRU recurrent block of RecurrentGemma / Griffin (arXiv:2402.19427),
the counterpart of ``repro.models.rglru``.

Recurrence (per channel of width d_rnn):

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block wraps the LRU with a width-4 temporal conv and a GeLU gate
branch (Griffin's "recurrent block").  A full sequence runs the
recurrence as a log-depth scan on tensors (Hillis-Steele doubling, 11
steps at S = 2048), where JAX runs ``jax.lax.associative_scan``; decode
carries (h, conv taps) as state.  The gates, the scan and ``h`` are fp32.

Under an active mesh whose 'rnn' axes split d_rnn (JAX's ``rnn ->
model``) the block runs per channel block: model shard j takes its
columns of ``w_gate_in`` and ``w_rec_in`` and its channels of the conv,
the gate products (``w_a`` and ``w_x`` split by rows) are fp32 partials
summed once, of which shard j keeps its channels' columns, the
recurrence runs on its channels, and ``w_out`` is row-parallel.  The
state stays whole; each shard reads and writes its channels of it.
Elsewhere the block's leaves are gathered whole where it runs.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (gather_tree, mesh_axes,
                                              shard_coords, shard_device,
                                              within)
from repro_torch.models.layers import (ParamDef, _gelu, _part, _row_parallel,
                                       _sum_partials)

Tensor = torch.Tensor

LRU_C = 8.0
CONV_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int            # lru width (RecurrentGemma-9B: 4096)


def rglru_block_def(cfg: RGLRUConfig) -> dict[str, ParamDef]:
    d, dr = cfg.d_model, cfg.d_rnn
    return {
        # Griffin recurrent block: two input branches
        "w_gate_in": ParamDef((d, dr), ("embed", "rnn")),     # GeLU branch
        "w_rec_in": ParamDef((d, dr), ("embed", "rnn")),      # conv + LRU
        "conv_w": ParamDef((CONV_WIDTH, dr), (None, "rnn"), scale=0.1),
        "conv_b": ParamDef((dr,), ("rnn",), init="zeros"),
        # RG-LRU gates
        "w_a": ParamDef((dr, dr), ("rnn", None)),
        "b_a": ParamDef((dr,), (None,), init="zeros"),
        "w_x": ParamDef((dr, dr), ("rnn", None)),
        "b_x": ParamDef((dr,), (None,), init="zeros"),
        "lam": ParamDef((dr,), (None,), init="ones"),
        "w_out": ParamDef((dr, d), ("rnn", "embed")),
    }


def _log_a(params, r: Tensor) -> Tensor:
    lam = F.softplus(params["lam"].float())
    return -LRU_C * lam * r.float()


def _decay_and_input(params, x: Tensor, pre=None) -> tuple[Tensor, Tensor]:
    """(a_t, sqrt(1 - a_t^2) * i_t * x_t) in fp32, the gates fp32
    products of ``x`` widened to fp32 (``pre``: those products, where a
    channel block's come from the shards' partial sums)."""
    xf = x.float()
    if pre is None:
        pre = (xf @ params["w_a"].float(), xf @ params["w_x"].float())
    r = torch.sigmoid(pre[0] + params["b_a"].float())
    i = torch.sigmoid(pre[1] + params["b_x"].float())
    log_a = _log_a(params, r)                          # <= 0
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i * xf)
    return torch.exp(log_a), gated


def rg_lru_scan(params, x: Tensor, h0: Tensor | None = None, pre=None):
    """x: (B, S, d_rnn).  Returns (y (B, S, d_rnn) in x's dtype, h_final
    (B, d_rnn) fp32)."""
    a, b = _decay_and_input(params, x, pre)
    if h0 is not None:
        # the carried state enters as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], 1)
        b = torch.cat([h0.float()[:, None], b], 1)
    # h_t = a_t h_{t-1} + b_t: after the step of shift d, (a_t, b_t) is
    # the composition of the 2d steps ending at t,
    # (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2).
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    if h0 is not None:
        b = b[:, 1:]
    return b.to(x.dtype), b[:, -1]


def rg_lru_step(params, x: Tensor, h: Tensor, pre=None):
    """Decode: x (B, d_rnn), h (B, d_rnn) -> (y in x's dtype, h' fp32)."""
    a, gated = _decay_and_input(params, x, pre)
    h = a * h.float() + gated
    return h.to(x.dtype), h


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 state: Tensor | None = None):
    """Width-4 depthwise causal conv.  x: (B, S, dr).
    state: (B, CONV_WIDTH-1, dr) trailing inputs from the previous call."""
    bsz, s, dr = x.shape
    if state is None:
        state = x.new_zeros((bsz, CONV_WIDTH - 1, dr))
    xp = torch.cat([state.to(x.dtype), x], 1)
    out = 0
    for i in range(CONV_WIDTH):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, -(CONV_WIDTH - 1):]


def rnn_split(cfg: RGLRUConfig) -> tuple[tuple[str, ...], int] | None:
    """``(axes, n)`` of the channel blocks under the active mesh, or None
    (off-mesh, one block, or d_rnn does not divide)."""
    _, axes, n = mesh_axes("rnn")
    return (axes, n) if n > 1 and cfg.d_rnn % n == 0 else None


# The dimension of each block leaf that 'rnn' names.
_RNN_DIM = {"w_gate_in": 1, "w_rec_in": 1, "conv_w": 1, "conv_b": 0,
            "w_a": 0, "w_x": 0, "b_a": 0, "b_x": 0, "lam": 0, "w_out": 0}
# The gates' leaves, read in their own dtype (the gates are fp32).
_FP32 = ("w_a", "w_x", "b_a", "b_x", "lam")


def _sharded(params, x: Tensor, cfg: RGLRUConfig, state: dict | None,
             step: bool):
    """The block per channel block (module docstring).  x: (B, S, D);
    ``step`` runs one token's recurrence."""
    axes, n = rnn_split(cfg)
    r = cfg.d_rnn // n
    home, dt = x.device, x.dtype
    shards, parts_a, parts_x = [], [], []
    for j in range(n):
        coords, c = shard_coords(axes, j), slice(j * r, (j + 1) * r)
        with within(coords):
            dev = shard_device()
            loc = {k: _part(params[k], dim, j * r, r, dev,
                            None if k in _FP32 else dt)
                   for k, dim in _RNN_DIM.items()}
            xj = x.to(dev)
            gate = _gelu(xj @ loc["w_gate_in"])
            u = xj @ loc["w_rec_in"]
            u, conv = _causal_conv(u, loc["conv_w"], loc["conv_b"],
                                   None if state is None
                                   else state["conv"][..., c].to(dev))
            parts_a.append((coords, _row_parallel("bsr,re->bse", u,
                                                  loc["w_a"])))
            parts_x.append((coords, _row_parallel("bsr,re->bse", u,
                                                  loc["w_x"])))
        shards.append((coords, c, dev, loc, gate, u, conv))
    pre_a = _sum_partials(parts_a, torch.float32, home)
    pre_x = _sum_partials(parts_x, torch.float32, home)
    outs, hs, convs = [], [], []
    for coords, c, dev, loc, gate, u, conv in shards:
        with within(coords):
            pre = (pre_a[..., c].to(dev), pre_x[..., c].to(dev))
            h0 = None if state is None else state["h"][:, c].to(dev)
            if step:
                y, h = rg_lru_step(loc, u[:, 0], h0,
                                   tuple(t[:, 0] for t in pre))
                y = y[:, None]
            else:
                y, h = rg_lru_scan(loc, u, h0, pre)
            outs.append((coords, _row_parallel("bsr,rd->bsd", y * gate,
                                               loc["w_out"])))
        hs.append(h.to(home))
        convs.append(conv.to(home))
    out = _sum_partials(outs, dt, home)
    return out, {"h": torch.cat(hs, -1), "conv": torch.cat(convs, -1)}


def rglru_block_apply(params, x: Tensor, cfg: RGLRUConfig, *,
                      state: dict | None = None):
    """Griffin recurrent block.  x: (B, S, D).
    state: {'h': (B, d_rnn), 'conv': (B, 3, d_rnn)} or None.
    Returns (y, new_state)."""
    if rnn_split(cfg) is not None:
        return _sharded(params, x, cfg, state, step=False)
    params = gather_tree(params, x.device)
    gate = _gelu(x @ params["w_gate_in"].to(x.dtype))
    u = x @ params["w_rec_in"].to(x.dtype)
    u, conv_state = _causal_conv(u, params["conv_w"], params["conv_b"],
                                 state["conv"] if state else None)
    y, h = rg_lru_scan(params, u, state["h"] if state else None)
    out = (y * gate) @ params["w_out"].to(x.dtype)
    return out, {"h": h, "conv": conv_state}


def rglru_block_step(params, x: Tensor, cfg: RGLRUConfig, *, state: dict):
    """Decode one token.  x: (B, D)."""
    if rnn_split(cfg) is not None:
        out, state = _sharded(params, x[:, None], cfg, state, step=True)
        return out[:, 0], state
    params = gather_tree(params, x.device)
    gate = _gelu(x @ params["w_gate_in"].to(x.dtype))
    u = x @ params["w_rec_in"].to(x.dtype)
    u3, conv_state = _causal_conv(u[:, None], params["conv_w"],
                                  params["conv_b"], state["conv"])
    y, h = rg_lru_step(params, u3[:, 0], state["h"])
    out = (y * gate) @ params["w_out"].to(x.dtype)
    return out, {"h": h, "conv": conv_state}
