"""Flash attention: online-softmax attention without the score matrix in
device memory (TPU kernel 6).

Counterpart of ``repro.kernels.flash_attention``: ``flash_attention_bh``
takes the head-major layout q (BH, Sq, Dh), k/v (BH, Sk, Dh);
``flash_attention`` the GQA layout of ``repro_torch.models.layers``, q
(B, Sq, KV, G, Dh), k/v (B, Sk, KV, Dh).  Inputs are fp32 or bf16 (all
three of one type); scores, softmax statistics and the accumulator are
fp32; the output is in q's dtype.  Causal masking compares absolute
indices from 0 on both sides (top-left aligned, also for Sq != Sk); the
optional softcap is ``tanh(s / cap) * cap``.

On CUDA tensors each wrapper launches the hand-written kernels of
``csrc/flash_attention.cu`` (which read K/V head ``h // G`` in place of
the G-fold broadcast the JAX wrapper builds): bf16 on the tensor cores,
fp32 on CUDA cores.  When the grid of (batch * heads) * ceil(Sq / 64)
query tiles leaves SMs idle (short query sets, decoding), the keys are
split into ``_plan_splits`` contiguous ranges of 64-key units, each range
computed by its own blocks, and a second kernel combines the ranges'
(m, l, acc) in a fixed order; ``flash_attention_split_plain`` is the plain
version of that path.  Either way a call counts **one** launch in
``flash_attention.launches`` / ``flash_attention_bh.launches``.  On CPU
tensors each wrapper runs the plain PyTorch version, the dense oracle
taken over slices of the queries so its score matrix stays near 1 GB.
There is no fallback from one to the other: a failed build or launch
raises.  ``block_q``/``block_k`` are the JAX kernel's grid blocks; they
are checked and change no result (the CUDA kernels pick their own tiles).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.tiling import SM_COUNT
from repro_torch.kernels.ref import flash_attention_ref

Tensor = torch.Tensor

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256           # the kernel's widest head (recurrentgemma's)
_PLAIN_SCORES = 1 << 28      # fp32 scores per slice of the plain version
BLOCK_Q = 64                 # query rows per block of both kernels
SPLIT_UNIT = 64              # keys per unit of the split over K
NEG_INF = -1e30              # the kernels' finite mask value


def load_kernel():
    """Build (first time only) and load the kernel's library."""
    from repro_torch.kernels import _build
    return _build.load("flash_attention")


def _check(q: Tensor, k: Tensor, v: Tensor, *, gqa: bool,
           softcap: float | None, block_q: int, block_k: int) -> None:
    want = "q (B, Sq, KV, G, Dh), k/v (B, Sk, KV, Dh)" if gqa \
        else "q (BH, Sq, Dh), k/v (BH, Sk, Dh)"
    nd = 5 if gqa else 3
    ok = q.dim() == nd and k.dim() == nd - (1 if gqa else 0) \
        and k.shape == v.shape and q.shape[0] == k.shape[0] \
        and q.shape[-1] == k.shape[-1] \
        and (not gqa or q.shape[2] == k.shape[2])
    if not ok:
        raise ValueError(f"flash attention of q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"{want}")
    if k.shape[1] < 1 or q.shape[-1] < 1:
        raise ValueError(f"flash attention needs Sk >= 1 and Dh >= 1; got "
                         f"k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash attention takes q, k and v all float32 or "
                         f"all bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive; got {softcap}")
    if min(block_q, block_k) < 1:
        raise ValueError(f"blocks ({block_q}, {block_k}) must be positive")


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, softcap: float | None = None,
                          block_q: int = 128, block_k: int = 128) -> Tensor:
    """Plain PyTorch version of ``flash_attention``, on any device: the
    dense fp32 oracle (``ref.flash_attention_ref``) over slices of the
    query rows (each row's softmax is its own, so slicing changes no
    result)."""
    _check(q, k, v, gqa=True, softcap=softcap, block_q=block_q,
           block_k=block_k)
    b, sq, kv, g, _ = q.shape
    rows = max(1, _PLAIN_SCORES // (b * kv * g * k.shape[1]))
    if rows >= sq:
        return flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    return torch.cat([
        flash_attention_ref(q[:, r0:r0 + rows], k, v, causal=causal,
                            softcap=softcap, q_offset=r0)
        for r0 in range(0, sq, rows)], dim=1)


def flash_attention_bh_plain(q: Tensor, k: Tensor, v: Tensor, *,
                             causal: bool = True,
                             softcap: float | None = None,
                             block_q: int = 128,
                             block_k: int = 128) -> Tensor:
    """Plain PyTorch version of ``flash_attention_bh``, on any device."""
    _check(q, k, v, gqa=False, softcap=softcap, block_q=block_q,
           block_k=block_k)
    out = flash_attention_plain(q[:, :, None, None], k[:, :, None],
                                v[:, :, None], causal=causal,
                                softcap=softcap, block_q=block_q,
                                block_k=block_k)
    return out[:, :, 0, 0]


def _plan_splits(blocks: int, sk: int) -> int:
    """How many key ranges a call of ``blocks`` query blocks over ``sk``
    keys is split into: 1 when the blocks fill the card's SMs, else enough
    for about two blocks per SM, ``min(ceil(2 * SM_COUNT / blocks),
    ceil(sk / 64))`` (never a range without keys)."""
    if blocks >= SM_COUNT:
        return 1
    return max(1, min(-(-2 * SM_COUNT // blocks), -(-sk // SPLIT_UNIT)))


def kernel_splits(q: Tensor, k: Tensor) -> int:
    """The split count the CUDA path runs for q (B, Sq, KV, G, Dh) and k
    (B, Sk, KV, Dh), or the head-major q (BH, Sq, Dh) and k (BH, Sk, Dh):
    one query block per 64 rows of every query head."""
    heads = q.shape[0] * math.prod(q.shape[2:-1])
    return _plan_splits(heads * -(-q.shape[1] // BLOCK_Q), k.shape[1])


def _split_ranges(sk: int, splits: int) -> list[tuple[int, int]]:
    """The kernels' key ranges: split i takes 64-key units [i * nu //
    splits, (i + 1) * nu // splits) of nu = ceil(sk / 64), clipped to sk."""
    nu = -(-sk // SPLIT_UNIT)
    if not 1 <= splits <= nu:
        raise ValueError(f"splits must lie in [1, {nu}] for Sk={sk}; got "
                         f"{splits}")
    return [(i * nu // splits * SPLIT_UNIT,
             min(sk, (i + 1) * nu // splits * SPLIT_UNIT))
            for i in range(splits)]


def _split_rows(q: Tensor, k: Tensor, v: Tensor, ranges, *, causal: bool,
                softcap: float | None, q_offset: int) -> Tensor:
    """Query rows [q_offset, q_offset + Sq) of the split path, in fp32:
    each key range's (m, l, acc) with the finite -1e30 mask, combined in
    range order."""
    qf = q.float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    rows = torch.arange(q_offset, q_offset + q.shape[1], device=q.device)
    parts = []
    for k0, k1 in ranges:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, k0:k1].float()) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            keys = torch.arange(k0, k1, device=q.device)
            s = torch.where(keys[None, :] <= rows[:, None], s, NEG_INF)
        m = s.amax(dim=-1)                                   # (b, h, g, q)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, k0:k1].float())
        parts.append((m, p.sum(dim=-1), acc))
    m = torch.stack([mi for mi, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        l = l + li * w
        acc = acc + ai * w[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)                        # (b, q, h, g, d)


def flash_attention_split_plain(q: Tensor, k: Tensor, v: Tensor, *,
                                splits: int, causal: bool = True,
                                softcap: float | None = None,
                                block_q: int = 128,
                                block_k: int = 128) -> Tensor:
    """Plain PyTorch version of the split-over-K path (GQA layout), on any
    device: the keys cut into the kernels' ``splits`` ranges of 64-key
    units, each range's row max m, sum l and unnormalised acc computed in
    fp32 with the finite -1e30 mask, then m = max m_i, l = sum l_i
    exp(m_i - m), o = sum acc_i exp(m_i - m) / max(l, 1e-30), ranges in
    order.  A range whose keys are all masked for a row has m_i = -1e30 and
    weight 0.  The output is in q's dtype."""
    _check(q, k, v, gqa=True, softcap=softcap, block_q=block_q,
           block_k=block_k)
    b, sq, kv, g, _ = q.shape
    ranges = _split_ranges(k.shape[1], splits)
    if q.numel() == 0:
        return torch.empty_like(q)
    rows = max(1, _PLAIN_SCORES // (b * kv * g * k.shape[1]))
    return torch.cat([
        _split_rows(q[:, r0:r0 + rows], k, v, ranges, causal=causal,
                    softcap=softcap, q_offset=r0)
        for r0 in range(0, sq, rows)], dim=1).to(q.dtype)


def _launch(q: Tensor, k: Tensor, v: Tensor, *, b: int, kv: int, g: int,
            causal: bool, softcap: float | None, counter) -> Tensor:
    """One call of the kernels on q (B, Sq, KV*G, Dh)-ordered memory and
    k/v (B, Sk, KV, Dh)-ordered memory; returns the output in q's shape.
    An empty output launches nothing; a call is counted once in
    ``counter.launches`` when its launches succeed (the split kernel and
    the combine count as one)."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    sq, sk, dh = q.shape[1], k.shape[1], q.shape[-1]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM}; "
                         f"got Dh={dh}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if sq == 0 or b * kv * g == 0:
        return out
    lib = load_kernel()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    splits = kernel_splits(q, k)
    # Per split and row: the unnormalised acc (Dh), then m and l.
    scratch = torch.empty(splits * b * kv * g * sq * (dh + 2),
                          dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    with torch.cuda.device(q.device):
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, sq, sk, kv, g, dh, int(causal),
            float(softcap or 0.0), splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.fa_error_string(err).decode()} ({err})")
    counter.launches += 1
    return out


def flash_attention_bh(q: Tensor, k: Tensor, v: Tensor, *,
                       causal: bool = True, softcap: float | None = None,
                       block_q: int = 128, block_k: int = 128) -> Tensor:
    """Head-major flash attention: q (BH, Sq, Dh); k, v (BH, Sk, Dh) ->
    (BH, Sq, Dh) in q's dtype.  CPU tensors run the plain version; CUDA
    tensors launch the kernel and count the launch in
    ``flash_attention_bh.launches``."""
    if q.device.type == "cpu":
        return flash_attention_bh_plain(q, k, v, causal=causal,
                                        softcap=softcap, block_q=block_q,
                                        block_k=block_k)
    _check(q, k, v, gqa=False, softcap=softcap, block_q=block_q,
           block_k=block_k)
    return _launch(q, k, v, b=q.shape[0], kv=1, g=1, causal=causal,
                   softcap=softcap, counter=flash_attention_bh)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    softcap: float | None = None, block_q: int = 128,
                    block_k: int = 128) -> Tensor:
    """GQA flash attention: q (B, Sq, KV, G, Dh); k, v (B, Sk, KV, Dh) ->
    (B, Sq, KV, G, Dh) in q's dtype; query head (kv, g) attends K/V head
    kv.  CPU tensors run the plain version; CUDA tensors launch the kernel
    and count the launch in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     softcap=softcap, block_q=block_q,
                                     block_k=block_k)
    _check(q, k, v, gqa=True, softcap=softcap, block_q=block_q,
           block_k=block_k)
    b, _, kv, g, _ = q.shape
    return _launch(q, k, v, b=b, kv=kv, g=g, causal=causal, softcap=softcap,
                   counter=flash_attention)


flash_attention_bh.launches = 0
flash_attention.launches = 0

