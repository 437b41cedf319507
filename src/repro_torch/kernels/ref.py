"""Plain-PyTorch oracles of the kernels (counterpart of
``repro.kernels.ref``): the matmul, the dense attention, and the DCL's
sampling with the reference ``sample_patches``, then its contraction."""
from __future__ import annotations

import math

import torch

from repro_torch.core.deform_conv import DCLConfig, sample_patches

Tensor = torch.Tensor


def matmul_ref(x: Tensor, w: Tensor) -> Tensor:
    """fp32-accumulated matmul oracle: ``x @ w`` in fp32, returned in
    x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, softcap: float | None = None,
                        q_offset: int = 0) -> Tensor:
    """Dense oracle of the flash-attention kernel (GQA layout), in fp32.

    q: (B, Sq, KV, G, Dh); k, v: (B, Sk, KV, Dh) -> (B, Sq, KV, G, Dh) in
    q's dtype.  Causal masking compares absolute indices from 0 on both
    sides (top-left aligned); ``q_offset`` is the absolute index of q's
    first row, so a slice of the queries can be computed on its own.
    """
    dh = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) \
        / math.sqrt(dh)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        rows = torch.arange(q_offset, q_offset + sq, device=q.device)
        keep = torch.arange(sk, device=q.device)[None, :] <= rows[:, None]
        s = torch.where(keep, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.to(q.dtype)


def deform_sample_ref(x: Tensor, offsets: Tensor, *, kernel_size: int = 3,
                      stride: int = 1, dilation: int = 1,
                      offset_bound: float | None = None) -> Tensor:
    """x: (N, H, W, C); offsets: (N, Ho, Wo, 2*K*K) raw, clamped to
    ``offset_bound`` here.  Returns (N, Ho, Wo, K*K, C)."""
    n, _, _, c = x.shape
    k2 = kernel_size * kernel_size
    ho, wo = offsets.shape[1], offsets.shape[2]
    off = offsets.reshape(n, ho, wo, k2, 2)
    if offset_bound is not None:
        off = off.clamp(-offset_bound, offset_bound)
    cfg = DCLConfig(in_channels=c, out_channels=1, kernel_size=kernel_size,
                    stride=stride, dilation=dilation)
    return sample_patches(x, off, cfg)


def deform_conv_fused_ref(x: Tensor, offsets: Tensor, w: Tensor, *,
                          kernel_size: int = 3, stride: int = 1,
                          dilation: int = 1,
                          offset_bound: float | None = None) -> Tensor:
    """w: (K*K, C, M).  Returns (N, Ho, Wo, M)."""
    patches = deform_sample_ref(x, offsets, kernel_size=kernel_size,
                                stride=stride, dilation=dilation,
                                offset_bound=offset_bound)
    y = torch.einsum("nhwkc,kcm->nhwm", patches.float(), w.float())
    return y.to(x.dtype)
