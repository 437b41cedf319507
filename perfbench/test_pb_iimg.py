"""CPU tests of the InternImage driver (``pb_iimg``) and its reference
(``pb_ref_iimg``): the reference against the program's forward on seeded
weights at the driver's CPU cut (the plain path and the kernel rung's
CPU path), the reference's parameter layout, the yardstick's counts at
the published configuration, the ``dv3_`` kernels' time in a trace and
the six per-layer metrics of the cell on a made-up traced run, and the
comparison against a changed answer."""
import dataclasses
import pathlib
import sys
import time

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pb_data  # noqa: E402
import pb_dcn  # noqa: E402
import pb_iimg  # noqa: E402
import pb_ref_iimg as ref  # noqa: E402
import pb_spec  # noqa: E402
import run as runner  # noqa: E402
import test_pb_harness as H  # noqa: E402

DOC = pb_spec.load_benchmark()
CONFIG = "iimgb-b2-fp32"
CELL = "det512-iimgb-fp32-batch"


def published() -> dict:
    return pb_spec.config(DOC, CONFIG)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_path", "kernel_rung"])
def test_reference_matches_the_programs_forward(use_kernel):
    from repro_torch.models import internimage as I
    cfg = H.reduced(CONFIG)
    params = pb_data.make_params(ref.param_specs(cfg), 7, "cpu")
    imgs = torch.as_tensor(pb_data.detection_batch(64, 3, 8, 7, 0)["images"])
    pcfg = dataclasses.replace(pb_iimg.program_config(cfg),
                               use_kernel=use_kernel)
    out, stats = I.forward(params, pcfg, imgs, device="cpu")
    cls, box = ref.forward(params, cfg, imgs)
    assert stats == {}
    assert out["cls"].shape == cls.shape == (3, 2, 2, 9)
    assert pb_dcn._rel(out["cls"], cls) < 1e-5
    assert pb_dcn._rel(out["box"], box) < 1e-5


def test_reference_layout_is_the_programs():
    from repro_torch.models import internimage as I
    for cfg in (H.reduced(CONFIG), published()):
        pcfg = pb_iimg.program_config(cfg)
        ours = {p: s[0] for p, s in pb_data.tree_leaves(
            ref.param_specs(cfg))}
        theirs = {p: d.shape for p, d in pb_data.tree_leaves(
            I.model_def(pcfg))}
        assert ours == theirs


def test_yardstick_counts_at_the_published_config():
    cfg = published()
    assert pb_iimg.forward_macs(cfg, 512) == pytest.approx(83.8e9, rel=0.01)
    assert pb_iimg.dcnv3_bytes(cfg, 512, 32) == pytest.approx(10.18e9,
                                                              rel=1e-3)
    bound = pb_iimg.dcnv3_bound_s(cfg, 512, 32)
    assert bound == pytest.approx(pb_iimg.dcnv3_bytes(cfg, 512, 32)
                                  / pb_iimg.pb_yard.PEAK_HBM_BYTES_PER_S)
    assert [(s["e"], s["c"], s["groups"]) for s in pb_iimg.stages(cfg, 512)] \
        == [(128, 112, 7), (64, 224, 14), (32, 448, 28), (16, 896, 56)]


def test_dv3_time_counts_the_window_alone():
    ev = [{"cat": "user_annotation", "name": "bench/window", "ts": 0,
           "dur": 100},
          {"cat": "kernel", "name": "void (anonymous namespace)::"
           "dv3_kernel(float const*, Dv3Plan)", "ts": 10, "dur": 20},
          {"cat": "kernel", "name": "dv3_kernel", "ts": 95, "dur": 20},
          {"cat": "kernel", "name": "dv3_kernel", "ts": 150, "dur": 5},
          {"cat": "kernel", "name": "dcf_kernel<1>", "ts": 40, "dur": 30}]
    seconds, launches = pb_iimg.dv3_time(ev)
    assert seconds == pytest.approx(25e-6) and launches == 2
    assert pb_iimg.dv3_time(ev[1:]) == (0.0, 0)


def traced_run():
    return pb_iimg.IimgRun(
        kind="serve_closed", window_s=2.0, images=64, steps=2, rows=64,
        slots=32, flops_per_image=1.676e11, dcnv3_bound_s=6.08e-3,
        trace={"window_s": 2.0, "busy_s": 1.6, "dcl_s": 0.0,
               "dcl_launches": 0, "dv3_s": 0.02, "dv3_launches": 66,
               "device_ops": [["k", 1.0]],
               "idle_gaps": [["bench/step", 0.05], ["serve/batch", 0.25],
                             ["serve/forward", 0.08]]})


def test_the_cells_per_layer_metrics():
    cell = pb_spec.workload(DOC, CELL)
    out = pb_dcn.Outcome(values={"images_per_s": 32.0, "setup_s": 20.0},
                         run=traced_run(),
                         checks={"out_gap": (1e-6, 1e-4)}, attempted=64,
                         failed=0, memory_peak_bytes=1)
    line = runner.assemble(DOC, cell, out, trace=True, device={})
    got = {k: m["value"] for k, m in line["metrics"].items()}
    assert set(got) == {"dcnv3_roofline.iimg", "dcnv3_share.iimg",
                        "mfu.iimg", "launch_idle.iimg", "build_idle.iimg",
                        "device_idle.iimg"}
    assert all(0 < v <= 100 for v in got.values())
    assert got["dcnv3_roofline.iimg"] == pytest.approx(30.4)
    assert got["dcnv3_share.iimg"] == pytest.approx(1.25)
    assert got["device_idle.iimg"] == pytest.approx(20.0)
    assert got["build_idle.iimg"] == pytest.approx(12.5)
    assert got["launch_idle.iimg"] == pytest.approx(4.0)
    assert got["mfu.iimg"] == pytest.approx(
        100 * 64 * 1.676e11 / 2.0 / 989e12)
    untraced = runner.assemble(DOC, cell, out, trace=False, device={})
    assert set(untraced["metrics"]) == {"images_per_s", "setup_s"}


def test_altered_answer_fails(monkeypatch):
    from repro_torch.models import internimage as I
    forward = I.forward

    def altered(*a, **kw):
        out, stats = forward(*a, **kw)
        return dict(out, box=out["box"] * 1.01), stats

    monkeypatch.setattr(I, "forward", altered)
    out = H.run_cell(CELL)
    assert not out.correct and out.failed == 0
    assert out.checks["out_gap"][0] > 5e-3


def test_a_checkout_without_the_model_fails_at_once(monkeypatch):
    """The parent commit has no ``models.internimage``: the driver fails
    before it builds anything."""
    import repro_torch.models
    monkeypatch.setitem(sys.modules, "repro_torch.models.internimage", None)
    monkeypatch.delattr(repro_torch.models, "internimage", raising=False)
    t0 = time.monotonic()
    with pytest.raises(ImportError):
        pb_iimg.run(published(), pb_spec.traffic("closed-32"), seed=1,
                    seconds=20.0, trace=False, device="cpu", t0=t0)
    assert time.monotonic() - t0 < 5.0
