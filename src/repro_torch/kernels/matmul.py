"""Tiled matrix product with fp32 accumulation (TPU kernel 5).

Counterpart of ``repro.kernels.matmul.matmul``: ``x @ w`` for x (M, K)
and w (K, N), fp32 or bf16 inputs, fp32 accumulation, the result in x's
dtype.  On CUDA tensors it launches the hand-written kernel of
``csrc/matmul.cu``; on CPU tensors it runs the plain PyTorch version.
There is no fallback from one to the other: a failed launch raises.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def load_kernel():
    """Build (first time only) and load the kernel's library."""
    from repro_torch.kernels import _build
    return _build.load("matmul")


def _check(x: Tensor, w: Tensor, block_m: int, block_n: int,
           block_k: int) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul of {tuple(x.shape)} and {tuple(w.shape)}: "
                         f"expected (M, K) and (K, N)")
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"blocks ({block_m}, {block_n}, {block_k}) must be "
                         f"positive")


def matmul_plain(x: Tensor, w: Tensor, *, block_m: int = 256,
                 block_n: int = 256, block_k: int = 256) -> Tensor:
    """Plain PyTorch version, on any device: the product in fp32, returned
    in x's dtype (the blocks only shape the kernel's grid)."""
    _check(x, w, block_m, block_n, block_k)
    return (x.float() @ w.float()).to(x.dtype)


def matmul(x: Tensor, w: Tensor, *, block_m: int = 256, block_n: int = 256,
           block_k: int = 256) -> Tensor:
    """``x @ w`` with fp32 accumulation: x (M, K), w (K, N) -> (M, N) in
    x.dtype, any sizes.

    The JAX kernel's blocks shape its grid; the CUDA kernel runs fixed
    64 x 64 x 16 tiles and sums every output over k in order, so the
    blocks are checked and change no result.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (x and w both fp32 or both
    bf16) and count the launch in ``matmul.launches``.
    """
    if x.device.type == "cpu":
        return matmul_plain(x, w, block_m=block_m, block_n=block_n,
                            block_k=block_k)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w, block_m, block_n, block_k)
    if x.dtype != w.dtype or x.dtype not in _KERNEL_DTYPES \
            or w.device != x.device:
        raise ValueError(f"the kernel takes x and w both float32 or both "
                         f"bfloat16 on {x.device}; got {x.dtype} and "
                         f"{w.dtype} on {w.device}")
    m, k = x.shape
    n = w.shape[1]
    if 0 in (m, k, n):
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    lib = load_kernel()
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = lib.mm_f32 if x.dtype == torch.float32 else lib.mm_bf16
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: "
                           f"{lib.mm_error_string(err).decode()} ({err})")
    matmul.launches += 1
    return out


matmul.launches = 0
