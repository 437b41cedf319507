"""The comparison's control on the card, at each cell's own size: the
reference one precision below the configuration's (int4 for the int8
chain, TF32 for fp32) in the program's place must come out not
correct, where the program itself comes out correct.  A short window
at the cell's own load; run on the card with ``-m cuda``:

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/test_pb_chip.py
"""
import pathlib
import sys
import time

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pb_spec  # noqa: E402

DOC = pb_spec.load_benchmark()
CELLS = [w["name"] for w in DOC["workloads"]]


def _run(cell: str, seed: int, control: bool):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    w = pb_spec.workload(DOC, cell)
    cfg = pb_spec.config(DOC, w["config"])
    return pb_spec.driver(cfg).run(
        cfg, pb_spec.traffic(w["traffic"]), seed=seed, seconds=2.0,
        trace=False, device="cuda", t0=time.monotonic(), control=control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3_300_000_017, 3_300_000_018,
                                  3_300_000_019])
def test_control_fails_on_the_card(cell, seed):
    out = _run(cell, seed, control=True)
    assert not out.correct, out.checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_on_the_card(cell):
    out = _run(cell, 3_300_000_023, control=False)
    assert out.correct, out.checks
