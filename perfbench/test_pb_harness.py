"""CPU tests of the benchmark harness: each cell's driver end to end at a
reduced size on the CPU (the program's plain kernel versions), its
comparison against planted faults, the result line, the names and
units of ``BENCHMARK.json``, the import check, the readers and the
trace reduction.  The reference is held against the program at that
size too."""
import dataclasses
import inspect
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pb_data  # noqa: E402
import pb_dcn  # noqa: E402
import pb_guard  # noqa: E402
import pb_ref_dcn as ref  # noqa: E402
import pb_spec  # noqa: E402
import pb_trace  # noqa: E402
import pb_yard  # noqa: E402
import run as runner  # noqa: E402

DOC = pb_spec.load_benchmark()
SEED = 2**31 + 11


def reduced(name: str, doc: dict = DOC, root=pb_spec.ROOT) -> dict:
    """Configuration ``name`` cut for the CPU by the driver it names."""
    cfg = pb_spec.config(doc, name, root)
    return pb_spec.driver(cfg).cpu_config(cfg)


def tiny(cell: str, doc: dict = DOC, root=pb_spec.ROOT) -> dict:
    """The cell's traffic shrunk for the CPU by its configuration's
    driver."""
    w = pb_spec.workload(doc, cell)
    cfg = pb_spec.config(doc, w["config"], root)
    return pb_spec.driver(cfg).cpu_traffic(
        pb_spec.traffic(w["traffic"], root))


def run_cell(cell: str, *, doc: dict = DOC, root=pb_spec.ROOT,
             trace: bool = False, **kw):
    """One run of a cell on the CPU, through the driver its configuration
    names, at that driver's cut."""
    w = pb_spec.workload(doc, cell)
    driver = pb_spec.driver(pb_spec.config(doc, w["config"], root))
    torch.set_num_threads(2)
    return driver.run(reduced(w["config"], doc, root), tiny(cell, doc, root),
                      seed=SEED, seconds=0.6, trace=trace, device="cpu",
                      t0=time.monotonic(), **kw)


def assert_sound(out, cell: str, doc: dict = DOC) -> None:
    """A correct run that reports every end-to-end metric of its cell."""
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    names = {m["name"] for m in pb_spec.metrics_of(doc, "end_to_end", cell)}
    assert names <= set(out.values)
    assert all(v > 0 and math.isfinite(v) for v in out.values.values())


CELLS = [w["name"] for w in DOC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_on_cpu(cell):
    assert_sound(run_cell(cell), cell)


STUB_DRIVER = '''"""The driver of a made-up architecture: it records what the
harness hands it."""
import types

calls = []


def cpu_config(cfg):
    calls.append("cpu_config")
    return dict(cfg, width=cfg["width"] // 8)


def cpu_traffic(traffic):
    calls.append("cpu_traffic")
    return dict(traffic, batch=1)


def run(cfg, traffic, *, seed, seconds, trace, device, t0, control=False):
    calls.append(("run", cfg["width"], traffic["batch"], device, control))
    return types.SimpleNamespace(
        correct=True, attempted=3, failed=0, checks={"gap": (0.0, 1.0)},
        values={"widgets_per_s": 5.0, "setup_s": 1.0}, notes={})
'''


def test_a_configuration_runs_through_the_driver_it_names(tmp_path,
                                                           monkeypatch):
    """A configuration that names another driver module joins with new
    files only, and the harness's cell path runs it by that module, at
    that module's CPU cut, without importing ``pb_dcn``."""
    for d in ("perfbench/configs", "perfbench/traffic", "drivers"):
        (tmp_path / d).mkdir(parents=True)
    (tmp_path / "drivers" / "pb_stub_arch.py").write_text(STUB_DRIVER)
    (tmp_path / "perfbench/configs/stub-arch.json").write_text(json.dumps(
        {"driver": "pb_stub_arch", "width": 256}))
    (tmp_path / "perfbench/traffic/stub-mix.json").write_text(json.dumps(
        {"kind": "stub", "batch": 8}))
    metric = {"unit": "widgets/s", "better": "higher", "bound": 0.05,
              "source": "host_clock"}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(dict(
        DOC,
        configs=[{"name": "stub-arch", "source": "https://example.org/stub",
                  "file": "perfbench/configs/stub-arch.json", "reduced": [],
                  "why": "a made-up architecture"}],
        workloads=[{"name": "stub-cell", "config": "stub-arch",
                    "traffic": "stub-mix", "chips": 1, "why": "a stub"}],
        end_to_end=[dict(metric, name="widgets_per_s"),
                    dict(metric, name="setup_s", unit="s",
                         better="lower")])))
    monkeypatch.syspath_prepend(str(tmp_path / "drivers"))
    monkeypatch.setitem(sys.modules, "pb_dcn", None)    # an import fails
    monkeypatch.setitem(sys.modules, "pb_stub_arch", None)
    del sys.modules["pb_stub_arch"]          # removed again at teardown
    doc = pb_spec.load_benchmark(root=tmp_path)
    assert pb_spec.problems(doc) == []
    out = run_cell("stub-cell", doc=doc, root=tmp_path)
    stub = sys.modules["pb_stub_arch"]
    assert stub.calls == ["cpu_config", "cpu_traffic",
                          ("run", 32, 1, "cpu", False)]
    assert_sound(out, "stub-cell", doc)
    line = runner.assemble(doc, pb_spec.workload(doc, "stub-cell"), out,
                           trace=False, device={})
    assert set(line["metrics"]) == {"widgets_per_s", "setup_s"}


@pytest.mark.parametrize("name", [c["name"] for c in DOC["configs"]])
def test_every_driver_keeps_the_contract(name):
    driver = pb_spec.driver(pb_spec.config(DOC, name))
    for fn in ("run", "cpu_config", "cpu_traffic"):
        assert callable(getattr(driver, fn, None)), fn
    params = inspect.signature(driver.run).parameters
    assert {"seed", "seconds", "trace", "device", "t0", "control"} <= set(
        params)


@pytest.mark.parametrize("cell", ["det512-int8-batch", "det512-int8-open"])
def test_int4_control_fails(cell):
    out = run_cell(cell, control=True)
    assert not out.correct
    assert out.checks["out_gap"][0] > 0.1


def test_altered_answer_fails(monkeypatch):
    from repro_torch.models import resnet_dcn as R
    forward = R.forward

    def altered(*a, **kw):
        out, o_max = forward(*a, **kw)
        return dict(out, cls=out["cls"] * 1.01), o_max

    monkeypatch.setattr(R, "forward", altered)
    assert not run_cell("det512-fp32-batch").correct


def test_unchanged_state_fails(monkeypatch):
    from repro_torch.launch import train as launch_train
    make = launch_train.train_optimizer

    def frozen(*a, **kw):
        opt = make(*a, **kw)
        return dataclasses.replace(opt, update=lambda g, s, p, step: (p, s))

    monkeypatch.setattr(launch_train, "train_optimizer", frozen)
    out = run_cell("det512-fp32-train")
    assert not out.correct
    assert out.checks["step_gap"][0] >= 0.99


def test_half_batch_fails(monkeypatch):
    from repro_torch.models import resnet_dcn as R
    train_loss = R.train_loss

    def half(params, cfg, batch, **kw):
        n = batch["images"].shape[0] // 2
        return train_loss(params, cfg, {k: v[:n] for k, v in batch.items()},
                          **kw)

    monkeypatch.setattr(R, "train_loss", half)
    assert not run_cell("det512-fp32-train").correct


def test_result_line():
    cell = pb_spec.workload(DOC, "det512-int8-batch")
    run = pb_dcn.Run(kind="serve_closed", window_s=2.0, images=64, steps=2,
                     rows=64, slots=32, flops_per_image=4.6e10,
                     dcl_bound_s=5e-4,
                     trace={"window_s": 2.0, "busy_s": 1.5, "dcl_s": 0.1,
                            "dcl_launches": 24,
                            "device_ops": [["k", 1.0]],
                            "idle_gaps": [["bench/step", 0.1],
                                          ["serve/batch", 0.3],
                                          ["serve/forward", 0.1]]})
    out = pb_dcn.Outcome(values={"images_per_s": 32.0, "setup_s": 20.0},
                         run=run, checks={"out_gap": (1e-4, 1e-2)},
                         attempted=64, failed=0, memory_peak_bytes=1)
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": 1}
    line = runner.assemble(DOC, cell, out, trace=False, device=device)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    traced = runner.assemble(DOC, cell, out, trace=True, device=device)
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert traced["device"]["busy_s"] == 1.5
    assert set(traced["metrics"]) == {
        m["name"] for m in pb_spec.metrics_of(DOC, "per_layer",
                                              cell["name"])}
    for m in traced["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100
    got = {k: m["value"] for k, m in traced["metrics"].items()}
    assert got["device_idle.batch"] == pytest.approx(25.0)
    assert got["build_idle.batch"] == pytest.approx(15.0)
    assert got["launch_idle.batch"] == pytest.approx(5.0)


def test_benchmark_names_and_units():
    assert pb_spec.problems(DOC) == []
    bad = {k: v for k, v in DOC.items()}
    bad["end_to_end"] = DOC["end_to_end"] + [
        {"name": "tokens per s", "unit": "tokens per second",
         "better": "up", "bound": 0.1, "source": "host_clock"},
        {"name": "setup_s", "unit": "µs", "better": "lower", "bound": 0.1,
         "source": "host_clock"}]
    found = " ".join(pb_spec.problems(bad))
    for text in ("'tokens per s'", "'tokens per second'", "'up'", "'µs'",
                 "'setup_s' twice"):
        assert text in found


def test_every_cell_reports_what_it_must():
    for w in DOC["workloads"]:
        e2e = {m["name"] for m in pb_spec.metrics_of(DOC, "end_to_end",
                                                    w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = pb_spec.metrics_of(DOC, "per_layer", w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
        assert pb_spec.traffic(w["traffic"])
        assert pb_spec.config(DOC, w["config"])
    for m in DOC["per_layer"]:
        assert callable(pb_spec.reader(m["name"]))


def test_import_guard_whole_names():
    loaded = ["repro_torch", "repro_torch.models", "repro", "repro.core",
              "jaxlib.xla_client", "jax", "flax.linen", "jaxtyping",
              "reproduce", "numpy"]
    assert pb_guard.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro", "repro.core"]


def test_harness_and_program_load_nothing_forbidden():
    drivers = sorted({pb_spec.config(DOC, c["name"])["driver"]
                      for c in DOC["configs"]})
    refs = sorted(p.stem for p in HERE.glob("pb_ref_*.py"))
    code = ("import sys; import pb_spec, pb_trace, run; "
            f"import {', '.join(drivers + refs)}; "
            "import repro_torch.serve, repro_torch.train, "
            "repro_torch.launch.train, repro_torch.quant.calibrate; "
            "import pb_guard; print(pb_guard.forbidden_modules(sys.modules))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE), str(HERE.parent / "src")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    refs = sorted(p.name for p in HERE.glob("pb_ref_*.py"))
    assert "pb_ref_dcn.py" in refs
    for name in refs + ["pb_data.py", "pb_yard.py"]:
        text = (HERE / name).read_text()
        assert "import repro" not in text and "from repro" not in text


def test_reference_layout_is_the_programs():
    from repro_torch.models import resnet_dcn as R
    cfg = reduced("r50dcn-b2-fp32")
    pcfg = pb_dcn.program_config(cfg)
    ours = {p: s[0] for p, s in pb_data.tree_leaves(ref.param_specs(cfg))}
    theirs = {p: d.shape for p, d in pb_data.tree_leaves(R.model_def(pcfg))}
    assert ours == theirs


@pytest.mark.parametrize("quant", ["none", "int8_chain"])
def test_reference_matches_the_programs_plain_path(quant):
    from repro_torch.models import resnet_dcn as R
    from repro_torch.quant.calibrate import calibrate_resnet_dcn
    cfg = reduced("r50dcn-b2-int8")
    params = pb_data.make_params(ref.param_specs(cfg), 5, "cpu")
    imgs = torch.as_tensor(pb_data.detection_batch(64, 3, 8, 5, 0)["images"])
    pcfg = dataclasses.replace(pb_dcn.program_config(cfg), quant=quant)
    if quant == "none":
        out, _ = R.forward(params, pcfg, imgs, device="cpu")
        cls, box, _ = ref.forward(params, cfg, imgs)
    else:
        table = calibrate_resnet_dcn(params, pcfg, [imgs[:2].numpy()],
                                     device="cpu")
        from repro_torch.quant.calibrate import scale_table_on
        out, _ = R.forward(params, pcfg, imgs, device="cpu",
                           quant_scales=scale_table_on(table, "cpu"))
        scales = ref.calibrate(params, cfg, imgs[:2])
        cls, box, _ = ref.forward(params, cfg, imgs, dcl="int",
                                  scales=scales)
    limit = 1e-4 if quant == "none" else pb_dcn.CPU_INT8_GAP
    assert pb_dcn._rel(out["cls"], cls) < limit
    assert pb_dcn._rel(out["box"], box) < limit


def test_reference_gradient_matches_the_programs():
    from repro_torch.models import resnet_dcn as R
    cfg = reduced("r50dcn-b2-fp32")
    params = pb_data.make_params(ref.param_specs(cfg), 6, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             pb_data.detection_batch(64, 3, 8, 6, 0).items()}
    leaves = [t.requires_grad_(True) for _, t in pb_data.tree_leaves(params)]
    loss, _ = R.train_loss(params, pb_dcn.program_config(cfg), batch,
                           lam=0.005, device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    ours, g = ref.loss_and_grads(params, cfg, batch, lam=0.005, block=2)
    assert abs(float(loss) - ours) < 1e-5 * abs(ours)
    # Leaves whose gradient is nought to rounding (a bias under a
    # one-channel GroupNorm group) are left out, by the benchmark's rule.
    norms = {p: float(t.norm()) for p, t in g.items()}
    median = sorted(norms.values())[len(norms) // 2]
    for (path, _), theirs in zip(pb_data.tree_leaves(params), grads):
        if norms[path] >= 1e-3 * median:
            assert pb_dcn._rel(theirs, g[path]) < 1e-3, path


def test_readers_of_an_empty_run_return_nothing():
    empty = pb_dcn.Run(kind="serve_closed", window_s=1.0)
    for m in DOC["per_layer"]:
        assert pb_spec.reader(m["name"])(empty) is None


def test_trace_reduction():
    ev = [{"cat": "user_annotation", "name": "bench/window", "ts": 0,
           "dur": 100},
          {"cat": "user_annotation", "name": "bench/step", "ts": 10,
           "dur": 50},
          {"cat": "user_annotation", "name": "bench/fill", "ts": 60,
           "dur": 40},
          {"cat": "kernel", "name": "void (anonymous namespace)::"
           "dcq_kernel<64, 2>(signed char const*)", "ts": 20, "dur": 10},
          {"cat": "kernel", "name": "sm80_xmma_fprop", "ts": 25, "dur": 20},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90, "dur": 20}]
    t = pb_trace.reduce(ev)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(35e-6)      # 20-45, 90-100
    assert t["dcl_s"] == pytest.approx(10e-6) and t["dcl_launches"] == 1
    gaps = dict(t["idle_gaps"])
    assert set(gaps) == {"outside any span", "bench/fill"}
    assert gaps["outside any span"] == pytest.approx(20e-6)   # 0-20
    assert gaps["bench/fill"] == pytest.approx(45e-6)    # 45-90, mid 67.5


def test_yardstick_counts():
    cfg = pb_spec.config(DOC, "r50dcn-b2-int8")
    layers = pb_yard.dcl_layers(cfg, 512)
    assert len(layers) == 12
    assert [(L["h"], L["c"], L["stride"]) for L in layers][:4] == [
        (64, 128, 1), (64, 128, 1), (64, 128, 1), (64, 256, 2)]
    assert 4.5e10 < pb_yard.forward_flops(cfg, 512) < 4.8e10
    one, many = (pb_yard.dcl_bound_s(cfg, 512, n, "fp32") for n in (1, 32))
    assert 16 * one < many < 32 * one
    assert pb_yard.dcl_bound_s(cfg, 512, 32, "int8_chain") < many
    assert pb_yard.is_dcl_kernel("(anonymous namespace)::dqt_kernel(Mat)")
    assert not pb_yard.is_dcl_kernel("void at::native::reduce_kernel<512>")


def test_percentile_counts_failures_as_late():
    assert pb_dcn._percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert pb_dcn._percentile([1.0] * 19 + [math.inf], 95) == 1.0
    assert pb_dcn._percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf


def test_open_loop_arrivals_share_their_gaps_across_seeds():
    a, b = (pb_dcn.arrivals(500, 4.0, s, 7) for s in (SEED, SEED + 1))
    assert len(a) == 500 and a[-1] == pytest.approx(4.0)
    ga, gb = (np.diff(np.r_[0.0, x]) for x in (a, b))
    shift = int(np.argmin([np.abs(np.roll(ga, k) - gb).max()
                           for k in range(500)]))
    assert np.roll(ga, shift) == pytest.approx(gb)
    assert not (a == b).all()
    assert ga.std() / ga.mean() == pytest.approx(1.0, abs=0.1)
