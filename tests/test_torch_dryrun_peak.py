"""The dry run's peak counts an op's own temporaries
(``launch.dryrun.op_temp_bytes``): what a CUDA op allocates inside the
call, where no dispatch mode sees it.

On the H100 the allocator showed (torch 2.11): ``_softmax_backward_data``
makes ``grad * output`` and a contiguous copy of each operand that is not
contiguous; attention's softmax gets its grad permuted from an einsum's
backward, so tinyllama-1.1b's 8 x 2048 training step holds two fp32
scores-sized temporaries (8 x 32 x 2048² x 4 B each, 8.59 GB) at its
peak.  ``logsumexp`` makes ``x - max`` beside the max.  The term is
computed from shapes and strides alone, so ``meta`` and CPU tensors count
alike.
"""
import dataclasses

import pytest
import torch

from repro_torch.launch import dryrun, steps
from repro_torch.models import registry as reg
from repro_torch.models.registry import ShapeSpec

aten = torch.ops.aten
DEVICES = ("meta", "cpu")


def _laid_out(shape, order, dtype, device):
    """A tensor of ``shape`` whose memory runs in ``order``."""
    base = torch.zeros([shape[i] for i in order], dtype=dtype, device=device)
    return base.permute([order.index(i) for i in range(len(shape))])


# attention's scores (b, kv, g, q, k); the einsum's grad runs (b, kv, q, g, k)
SCORES = (2, 2, 3, 8, 8)
CONTIG = (0, 1, 2, 3, 4)
EINSUM = (0, 1, 3, 2, 4)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_order,out_order,copies", [
    (CONTIG, CONTIG, 1), (EINSUM, CONTIG, 2), (CONTIG, EINSUM, 2),
    (EINSUM, EINSUM, 3)])
def test_softmax_backward_temporaries_by_layout(device, dtype, grad_order,
                                                out_order, copies):
    """The H100's reading (``grad * output``, then a copy of each
    non-contiguous operand), counted by ``LiveBytes`` while the op runs:
    its peak is the output plus the temporaries."""
    grad = _laid_out(SCORES, grad_order, dtype, device)
    out = _laid_out(SCORES, out_order, dtype, device)
    n = grad.numel() * grad.element_size()
    with dryrun.LiveBytes(known=(grad, out)) as lb:
        res = aten._softmax_backward_data(grad, out, -1, dtype)
    assert dryrun.op_temp_bytes(aten._softmax_backward_data.default,
                                (grad, out, -1, dtype), [res]) == copies * n
    assert lb.temps == {"_softmax_backward_data": copies * n}
    assert lb.peak == n + copies * n and lb.peak_temp == copies * n


@pytest.mark.parametrize("device", DEVICES)
def test_logsumexp_temporaries(device):
    """At the H100's shapes: the CE chunk's logsumexp over (8, 1024,
    32000) fp32 made 1,048,576,000 B of ``x - max`` and 32,768 B of max
    (bf16: half of each); an op not listed makes none."""
    x = torch.empty((8, 1024, 32000), device="meta")
    out = torch.empty((8, 1024), device="meta")
    assert dryrun.op_temp_bytes(aten.logsumexp.default, (x, [-1]), [out]) \
        == 1_048_608_768
    xb = torch.empty((8, 1024, 32000), dtype=torch.bfloat16, device="meta")
    assert dryrun.op_temp_bytes(aten.logsumexp.default, (xb, [-1]),
                                [out.bfloat16()]) == 524_304_384
    s = torch.zeros((4, 8, 16), device=device)
    with dryrun.LiveBytes(known=s) as lb:
        lse = torch.logsumexp(s, -1)
        torch.softmax(s, -1)
    assert lb.temps == {"logsumexp": (s.numel() + lse.numel()) * 4}
    assert lb.peak == lb.peak_temp + lse.numel() * 4
    assert dryrun.op_temp_bytes(aten.mm.default, (s, s), [s]) == 0


def _reduced(shape):
    arch = reg.get("tinyllama-1.1b")
    arch = dataclasses.replace(arch, config=reg.reduced_config(arch))
    return steps.with_shape(arch, "t", shape)


def test_reduced_tinyllama_step_counts_the_temporaries_alike():
    """The reduced tinyllama training step (2 x 16, 4 heads, vocab 128):
    its softmax backward gets the grad the card showed (permuted: two
    copies of a (2, 4, 16, 16) fp32 block) and each CE chunk's logsumexp
    its (2, 1024, 128) logits, on ``meta`` and on CPU tensors alike."""
    arch = _reduced(ShapeSpec("train", 16, 2))
    cfg = arch.config
    b, s = 2, 16
    scores = b * cfg.n_heads * s * s * 4
    logits = b * 1024 * cfg.vocab * 4            # one 1024-token chunk
    want = {"_softmax_backward_data": 2 * scores,
            "logsumexp": logits + b * 1024 * 4}
    step, inputs, _, _ = steps.make_cell_step(arch, "t", None)
    with dryrun.StepCounter(meta_only=True, known=inputs) as dry:
        step(*inputs)
    real = steps.real_inputs(arch, "t", inputs, "cpu", seed=1)
    with dryrun.StepCounter(known=real) as cpu:
        step(*real)
    assert dry.op_temps == cpu.op_temps == want
    assert dry.peak_new_bytes == cpu.peak_new_bytes
    assert dry.peak_temp_bytes == cpu.peak_temp_bytes


def test_full_width_training_peak_holds_the_two_score_copies():
    """tinyllama-1.1b at 8 x 2048 on ``meta``: the record's peak holds
    the two fp32 scores-sized temporaries of a softmax backward (2 x 8 x
    32 x 2048² x 4 B = 8,589,934,592 B): the 8.59 GB that the H100's
    allocator held beyond the dispatch-level count."""
    arch = steps.with_shape(reg.get("tinyllama-1.1b"), "train_8x2048",
                            ShapeSpec("train", 2048, 8))
    trace = dryrun.trace_cell(arch, "train_8x2048")
    rec = dryrun.run_cell(arch.name, "train_8x2048", "card", arch=arch,
                          trace=trace)
    assert rec["peak_op_temp_bytes"] == 2 * 8 * 32 * 2048 * 2048 * 4
    assert rec["peak_live_bytes"] == rec["argument_bytes"] \
        + trace["peak_new_bytes"]
    assert rec["peak_live_bytes"] - rec["peak_op_temp_bytes"] \
        == 32_402_702_348    # the live bytes at that op, as before the term
