"""Tiled matrix product with fp32 accumulation (TPU kernel 5).

Counterpart of ``repro.kernels.matmul.matmul``: ``x @ w`` for x (M, K)
and w (K, N), fp32 or bf16 inputs, fp32 accumulation, the result in x's
dtype.  On CUDA tensors it launches the hand-written kernel of
``csrc/matmul.cu`` (fp32 on CUDA cores, 128 x 128 tiles or 64 x 64 for
outputs of fewer than 132 wide tiles; bf16 on the tensor cores, 128 x 128
tiles), with 16-byte loads where rows and pointers are 16-byte aligned
and element-wise loads elsewhere (``_plan``); on CPU tensors it runs the
plain PyTorch version.  There is no fallback from one to the other: a
failed launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.tiling import SM_COUNT

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


def _plan(m: int, n: int, k: int, dtype: torch.dtype,
          aligned: bool) -> tuple[int, bool]:
    """(block tile, 16-byte loads) of the kernel instance for an (m, k) @
    (k, n) product: fp32 takes 128 x 128 tiles when the output has at
    least one per SM, else 64 x 64; bf16 always 128 x 128.  16-byte loads
    need 16-byte rows (k and n multiples of 4 fp32 or 8 bf16) and
    ``aligned`` base pointers."""
    if dtype == torch.float32:
        wide = -(-m // 128) * -(-n // 128) >= SM_COUNT
        return (128 if wide else 64), aligned and k % 4 == 0 and n % 4 == 0
    return 128, aligned and k % 8 == 0 and n % 8 == 0


def instance(x: Tensor, w: Tensor) -> str:
    """The kernel instance ``matmul(x, w)`` launches, e.g. "128x128
    aligned" (16-byte loads) or "64x64 element-wise"."""
    tile, vec = _plan(x.shape[0], w.shape[1], x.shape[1], x.dtype,
                      x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    return f"{tile}x{tile} {'aligned' if vec else 'element-wise'}"


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

    The JAX kernel's blocks shape its grid; the CUDA kernel picks its own
    tiles (``_plan``), so the blocks are checked and change no result
    (fp32 sums every output over k in order).  CPU tensors run the plain
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
    tile, vec = _plan(m, n, k, x.dtype,
                      x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.float32:
            err = lib.mm_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(), m,
                             n, k, tile, int(vec), stream)
        else:
            err = lib.mm_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(), m,
                              n, k, int(vec), stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: "
                           f"{lib.mm_error_string(err).decode()} ({err})")
    matmul.launches += 1
    return out


matmul.launches = 0
