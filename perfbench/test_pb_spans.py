"""CPU tests of the readers of device idle under the program's spans
(``pb_spans``: ``build_idle``, ``launch_idle``, ``optimizer_idle``) on
made-up traces, and of a reduced traced run whose idle gaps carry the
serving engine's labels."""
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pb_dcn  # noqa: E402
import pb_spans  # noqa: E402
import pb_spec  # noqa: E402
import pb_trace  # noqa: E402
import test_pb_harness as H  # noqa: E402

NEW = ("build_idle", "launch_idle", "optimizer_idle")


def _run(gaps, window_s=2.0):
    return pb_dcn.Run(kind="serve_closed", window_s=window_s,
                      trace={"window_s": window_s, "busy_s": 1.0,
                             "dcl_s": 0.0, "dcl_launches": 0,
                             "device_ops": [], "idle_gaps": gaps})


def read(name, run):
    return pb_spec.reader(name)(run)


def test_readers_share_of_the_window():
    run = _run([["bench/step", 0.1], ["serve/batch", 0.5],
                ["serve/forward", 0.2], ["train/backward", 0.1],
                ["train/optimizer", 0.3]])
    assert read("build_idle.batch", run) == pytest.approx(25.0)
    assert read("build_idle.open", run) == pytest.approx(25.0)
    # serve/forward, and a training step's forward and backward.
    assert read("launch_idle.batch", run) == pytest.approx(15.0)
    assert read("optimizer_idle.train", run) == pytest.approx(15.0)
    train = _run([["train/forward", 0.2], ["train/backward", 0.4],
                  ["train/sentinel", 0.6], ["train/step", 0.1]])
    assert read("launch_idle.train", train) == pytest.approx(30.0)
    assert read("optimizer_idle.train", train) == 0.0


def test_readers_return_nothing_where_nothing_can_be_read():
    assert all(read(f"{n}.batch", pb_dcn.Run(kind="serve_closed",
                                             window_s=1.0)) is None
               for n in NEW)
    # Only the benchmark's own labels: the program opened no span.
    parent = _run([["bench/step", 0.7], ["bench/fill", 0.01],
                   ["train/step", 0.2], ["train/forward", 0.1],
                   ["outside any span", 0.01]])
    assert all(read(f"{n}.batch", parent) is None for n in NEW)
    # A short list without the label: no idle there.
    short = _run([["bench/step", 0.1], ["serve/step", 0.2]])
    assert [read(f"{n}.batch", short) for n in NEW] == [0.0] * 3
    # A full list without it: the label may have been cut off.
    full = _run([[f"serve/x{i}", 0.1] for i in range(pb_spans.TOP)])
    assert pb_spans.TOP == 10
    assert all(read(f"{n}.batch", full) is None for n in NEW)


def test_traced_cpu_run_labels_idle_by_the_engines_spans(monkeypatch):
    """The CPU has no device kernels, so the CPU's operators stand in
    for them: the gaps between them are the idle the labels split."""
    monkeypatch.setattr(pb_trace, "DEVICE_CATS", ("cpu_op",))
    out = H.run_cell("det512-int8-batch", trace=True)
    assert out.correct
    labels = {name for name, _ in out.run.trace["idle_gaps"]}
    # The readers' labels hold the step's long gaps.  A gap is labelled
    # at its middle, so the short retire loop and readback may or may not
    # own one, with the host's timing: every label is still the engine's
    # or the benchmark's.
    engine = {"serve/step", "serve/batch", "serve/forward",
              "serve/readback", "serve/retire"}
    assert {"serve/batch", "serve/forward"} <= labels
    assert labels <= engine | pb_spans.BENCH_LABELS
    idle = read("device_idle.batch", out.run)
    for name in ("build_idle.batch", "launch_idle.batch"):
        assert 0 < read(name, out.run) <= idle
