"""Port parity: ``repro_torch.kernels.matmul`` (TPU kernel 5) and
``ref.matmul_ref`` against the JAX package.

The JAX kernel runs in interpret mode, as its own tests run it, on the
shapes of ``tests/test_kernels.py``.  Tolerances: fp32 1e-5 relative
(fp32 products summed in another order), bf16 3e-2 (as the JAX sweep:
the result is rounded to bf16).  The CUDA kernel is held against the
plain version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.matmul import matmul as jax_matmul
from repro_torch.kernels import matmul as TM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SHAPES = [(8, 8, 8), (128, 128, 128), (300, 200, 100), (512, 1024, 256),
          (1, 7, 3), (257, 129, 65)]


def _inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            rng.randn(k, n).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_matches_jax(m, k, n, dtype):
    x, w = _inputs(m, k, n, seed=m * 31 + n)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                 block_m=128, block_n=128, block_k=128),
                      np.float32)
    before = TM.matmul.launches
    got = TO.matmul(_torch(x, dtype), _torch(w, dtype), block_m=128,
                    block_n=128, block_k=128)
    assert TM.matmul.launches == before            # no kernel on the CPU
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    scale = np.abs(want).max()
    np.testing.assert_allclose(_np(got) / scale, want / scale, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ref_matches_jax(dtype):
    x, w = _inputs(33, 17, 9, seed=2)
    jdt = getattr(jnp, dtype)
    want = np.asarray(JR.matmul_ref(jnp.asarray(x, jdt),
                                    jnp.asarray(w, jdt)), np.float32)
    got = TR.matmul_ref(_torch(x, dtype), _torch(w, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])


def test_matmul_blocks_do_not_change_the_result():
    x, w = _inputs(192, 160, 224, seed=0)
    outs = [TM.matmul(torch.from_numpy(x), torch.from_numpy(w), block_m=bm,
                      block_n=bn, block_k=bk)
            for bm, bn, bk in [(64, 64, 64), (128, 256, 32), (192, 224, 160)]]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_matmul_rejects_what_it_cannot_multiply():
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        TM.matmul(torch.zeros(4, 5), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="positive"):
        TM.matmul(torch.zeros(4, 5), torch.zeros(5, 2), block_k=0)
    with pytest.raises(ValueError, match="no kernel"):
        TM.matmul(torch.zeros(4, 5, device="meta"),
                  torch.zeros(5, 2, device="meta"))


@pytest.mark.parametrize("m,n,k,dtype,aligned,want", [
    (4096, 4096, 4096, torch.float32, True, (128, True)),
    (1536, 1408, 64, torch.float32, True, (128, True)),   # 12 x 11 tiles
    (1536, 1280, 64, torch.float32, True, (64, True)),    # 12 x 10 < 132
    (512, 512, 512, torch.float32, True, (64, True)),
    (257, 65, 129, torch.float32, True, (64, False)),     # k, n not x4
    (256, 256, 256, torch.float32, False, (64, False)),   # misaligned view
    (4096, 4096, 4096, torch.bfloat16, True, (128, True)),
    (512, 512, 512, torch.bfloat16, True, (128, True)),
    (64, 8, 12, torch.bfloat16, True, (128, False)),      # k not x8
    (64, 12, 8, torch.bfloat16, True, (128, False)),      # n not x8
])
def test_kernel_plan(m, n, k, dtype, aligned, want):
    """The instance the CUDA wrapper launches: fp32 128 x 128 tiles once
    the output has one per SM (else 64 x 64), bf16 always 128 x 128;
    16-byte loads only for 16-byte rows and base pointers."""
    assert TM._plan(m, n, k, dtype, aligned) == want


def test_instance_names_the_tile_and_the_loads():
    x = torch.zeros(4 * 64 + 1)
    assert TM.instance(x[:-1].view(4, 64), torch.zeros(64, 8)) \
        == "64x64 aligned"
    assert TM.instance(x[1:].view(4, 64), torch.zeros(64, 8)) \
        == "64x64 element-wise"
    assert TM.instance(torch.zeros(8, 16, dtype=torch.bfloat16),
                       torch.zeros(16, 8, dtype=torch.bfloat16)) \
        == "128x128 aligned"
