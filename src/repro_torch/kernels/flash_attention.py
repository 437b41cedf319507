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

On CUDA tensors each wrapper launches the hand-written kernel of
``csrc/flash_attention.cu`` (which reads K/V head ``h // G`` in place of
the G-fold broadcast the JAX wrapper builds); on CPU tensors it runs the
plain PyTorch version, the dense oracle taken over slices of the queries
so its score matrix stays near 1 GB.  There is no fallback from one to the
other: a failed build or launch raises.  ``block_q``/``block_k`` are the
JAX kernel's grid blocks; they are checked and change no result (the CUDA
kernel picks its own tiles from Dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import flash_attention_ref

Tensor = torch.Tensor

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256           # the kernel's widest head (recurrentgemma's)
_PLAIN_SCORES = 1 << 28      # fp32 scores per slice of the plain version


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


def _launch(q: Tensor, k: Tensor, v: Tensor, *, b: int, kv: int, g: int,
            causal: bool, softcap: float | None, counter) -> Tensor:
    """One launch of the kernel on q (B, Sq, KV*G, Dh)-ordered memory and
    k/v (B, Sk, KV, Dh)-ordered memory; returns the output in q's shape.
    An empty output launches nothing; a launch is counted in
    ``counter.launches`` once the launch succeeds."""
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
    with torch.cuda.device(q.device):
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, sq, sk, kv, g, dh, int(causal),
            float(softcap or 0.0),
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

