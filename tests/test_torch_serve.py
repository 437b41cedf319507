"""The port's DCL serving engine: buckets, slots, deadlines on a fake
clock, admission policies, the ladder (all four rungs, the int8 ones on a
calibrated scale table), and parity with both the port's own direct
forward (bit-equal) and the JAX engine (outcomes equal, results within
1e-4 * max|ref|)."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fakeclock import FakeClock
from repro.models import resnet_dcn as JR
from repro.serve import DCLServeConfig as JServeConfig
from repro.serve import DCLServingEngine as JEngine
from repro_torch.launch import serve as launch
from repro_torch.models import resnet_dcn as R
from repro_torch.quant.calibrate import calibrate_resnet_dcn
from repro_torch.serve import (LADDER, OUTCOMES, DCLServeConfig,
                               DCLServingEngine, bucket_layer_dims, ladder)

torch.set_num_threads(2)

BUCKET = 32
SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=BUCKET,
             offset_bound=2.0)


def _perturb(params, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for block in params.values():
        if "dcl" in block:
            d = block["dcl"]
            c = d["w_offset"].shape[2]
            d["w_offset"] = torch.randn(d["w_offset"].shape,
                                        generator=gen) / (4.5 * c) ** 0.5
            d["b_offset"] = torch.randn(d["b_offset"].shape,
                                        generator=gen) * 0.5
    return params


@pytest.fixture(scope="module")
def model():
    cfg = R.ResNetDCNConfig(**SMALL, use_kernel=True)
    return cfg, _perturb(R.init_params(cfg, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def table(model):
    cfg, params = model
    rng = np.random.RandomState(99)
    return calibrate_resnet_dcn(
        params, cfg, [rng.randn(2, BUCKET, BUCKET, 3).astype(np.float32)],
        device="cpu")


def _engine(model, table=None, **kw):
    cfg, params = model
    kw.setdefault("buckets", (BUCKET,))
    kw.setdefault("slots", 2)
    kw.setdefault("quant", "fp32_kernel")
    extra = {k: kw.pop(k) for k in ("clock", "sleep", "step_hook",
                                    "admit_hook") if k in kw}
    return DCLServingEngine(params, cfg, DCLServeConfig(**kw),
                            scale_table=table, device="cpu", **extra)


def _img(seed, side=BUCKET):
    return np.random.RandomState(seed).randn(side, side, 3) \
        .astype(np.float32)


def _direct(model, rung, images, slots=2, side=BUCKET, table=None):
    cfg, params = model
    batch = np.zeros((slots, side, side, 3), np.float32)
    for i, im in enumerate(images):
        batch[i, :im.shape[0], :im.shape[1]] = im
    int8 = rung in ("int8_chain", "int8")
    cfg = dataclasses.replace(cfg, use_kernel=(rung != "fp32_ref"),
                              quant=rung if int8 else "none")
    with torch.no_grad():
        out, _ = R.forward(params, cfg, torch.from_numpy(batch),
                           quant_scales=table if int8 else None,
                           device="cpu")
    return out["cls"].numpy(), out["box"].numpy()


# -- datapath ------------------------------------------------------------------

@pytest.mark.parametrize("rung", LADDER)
def test_results_bit_equal_to_direct_forward(model, table, rung):
    eng = _engine(model, table, quant=rung)
    imgs = [_img(1), _img(2), _img(3)]
    reqs = [eng.submit(im) for im in imgs]
    eng.run_until_drained()
    assert eng.steps == 2                      # slots=2: 2 + 1
    assert all(r.outcome == "ok" and r.ladder == rung and not r.degraded
               for r in reqs)
    cls01, box01 = _direct(model, rung, imgs[:2], table=table)
    cls2, _ = _direct(model, rung, imgs[2:], table=table)
    assert np.array_equal(reqs[0].result["cls"], cls01[0])
    assert np.array_equal(reqs[1].result["box"], box01[1])
    assert np.array_equal(reqs[2].result["cls"], cls2[0])


def test_kernel_and_reference_rungs_agree(model):
    imgs = [_img(4), _img(5)]
    k_cls, _ = _direct(model, "fp32_kernel", imgs)
    r_cls, _ = _direct(model, "fp32_ref", imgs)
    assert np.abs(k_cls - r_cls).max() <= 1e-4 * np.abs(r_cls).max()


def test_matches_jax_engine_outcomes_and_results(model):
    """Same params, same traffic (one request expires at admission, one
    in the queue): the same outcomes, and results close to the JAX
    engine's kernel rung."""
    cfg, params = model
    jparams = {k: {kk: jnp.asarray(vv.numpy()) if torch.is_tensor(vv) else
                   {k3: jnp.asarray(v3.numpy()) for k3, v3 in vv.items()}
                   for kk, vv in v.items()} for k, v in params.items()}
    jcfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True)
    outs = {}
    for name in ("jax", "torch"):
        clock = FakeClock()
        if name == "jax":
            eng = JEngine(jparams, jcfg,
                          JServeConfig(buckets=(BUCKET,), slots=2,
                                       quant="fp32_kernel"), clock=clock)
        else:
            eng = _engine(model, clock=clock)
        rs = [eng.submit(_img(10), deadline=-1.0),
              eng.submit(_img(11), deadline=5.0),
              eng.submit(_img(12)), eng.submit(_img(13))]
        eng.step()                         # serves 11 and 12
        rs.append(eng.submit(_img(14), deadline=1.0))
        clock.advance(2.0)
        eng.run_until_drained()            # 14 expires in the queue
        outs[name] = rs
    assert [r.outcome for r in outs["jax"]] == \
        [r.outcome for r in outs["torch"]] == \
        ["deadline_exceeded", "ok", "ok", "ok", "deadline_exceeded"]
    for rj, rt in zip(outs["jax"], outs["torch"]):
        assert rj.ladder == rt.ladder
        if rj.outcome == "ok":
            for key in ("cls", "box"):
                ref = np.asarray(rj.result[key])
                assert np.abs(rt.result[key] - ref).max() \
                    <= 1e-4 * np.abs(ref).max()


# -- the batch build -----------------------------------------------------------

def _fresh_batch(images, slots=2, side=BUCKET):
    """The batch as a fresh zero-filled array with each image copied in."""
    batch = np.zeros((slots, side, side, 3), np.float32)
    for i, im in enumerate(images):
        arr = np.asarray(im, np.float32)
        batch[i, :arr.shape[0], :arr.shape[1], :] = arr
    return batch


def _typed(seed, dtype, side=BUCKET):
    rng = np.random.RandomState(seed)
    if dtype == "uint8":
        return rng.randint(0, 256, (side, side, 3)).astype(np.uint8)
    return rng.randn(side, side, 3).astype(dtype)


# Steps of one engine, each a list of images: every dtype the old build
# converted, an image torch cannot view (negative strides), a full step
# then a partial one, a full-bucket image then a smaller one in its row.
BUILDS = {
    "float32": [[_typed(1, "float32"), _typed(2, "float32")]],
    "float64": [[_typed(3, "float64"), _typed(4, "float64")]],
    "uint8": [[_typed(5, "uint8"), _typed(6, "uint8")]],
    "flipped": [[_typed(7, "float32")[::-1, ::-1]]],
    "full_then_partial": [[_img(8), _img(9)], [_img(10)]],
    "full_then_smaller": [[_img(11), _img(12)], [_img(13)[:24, :28]],
                          [_img(14)[:20, :32], _img(15)[:32, :17]]],
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_batch_build_equals_a_fresh_zero_padded_batch(model, case):
    """Each step's input equals, bit for bit, a fresh ``np.zeros`` batch
    with the requests copied in, across reuse of the bucket's buffer:
    no row or margin of an earlier step leaks into a later one; every
    step counts one ``host`` batch."""
    eng = _engine(model, strict_buckets=False)
    seen = []
    forward = eng._forward

    def recording(rung, x, bucket=None):
        seen.append(x.clone())
        return forward(rung, x, bucket)
    eng._forward = recording
    for images in BUILDS[case]:
        reqs = [eng.submit(im) for im in images]
        eng.step()
        assert all(r.outcome == "ok" for r in reqs)
    assert len(seen) == eng.steps == len(BUILDS[case])
    for x, images in zip(seen, BUILDS[case]):
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        want = _fresh_batch(images)
        assert np.array_equal(x.numpy().view(np.uint32),
                              want.view(np.uint32))
    staged = eng.metrics.counter("serve_staged_batches_total")
    assert staged.value(path="host", bucket=str(BUCKET)) == eng.steps
    assert staged.value(path="pinned", bucket=str(BUCKET)) == 0
    counters = eng.telemetry()["metrics"]["counters"]
    assert counters["serve_staged_batches_total"]["values"] == [
        {"labels": {"bucket": str(BUCKET), "path": "host"},
         "value": eng.steps}]


# -- buckets, slots, admission -------------------------------------------------

def test_unbucketable_request_is_typed_not_raised(model):
    eng = _engine(model)
    r = eng.submit(_img(0, side=20))
    assert r.outcome == "unbucketable" and "nearest" in r.error
    eng.submit(_img(1))
    assert [q.outcome for q in eng.run_until_drained()] == \
        ["unbucketable", "ok"]


def test_strict_buckets_false_pads_up(model):
    eng = _engine(model, strict_buckets=False)
    small = _img(2)[:24, :28]
    r = eng.submit(small)
    eng.run_until_drained()
    padded = np.zeros((BUCKET, BUCKET, 3), np.float32)
    padded[:24, :28] = small
    eng2 = _engine(model)
    r2 = eng2.submit(padded)
    eng2.run_until_drained()
    assert r.bucket == BUCKET
    assert np.array_equal(r.result["cls"], r2.result["cls"])


def test_two_buckets_and_plans(model):
    eng = _engine(model, buckets=(BUCKET, 64))
    reqs = [eng.submit(_img(20 + i, side=(BUCKET, 64)[i % 2]))
            for i in range(4)]
    eng.run_until_drained()
    assert eng.steps == 2 and all(r.outcome == "ok" for r in reqs)
    tel = eng.telemetry()
    assert tel["served_per_bucket"] == {"32": 2, "64": 2}
    assert tel["steps_per_bucket"] == {"32": 1, "64": 1}
    assert set(tel["plans"]["64"]) == {"s2b0", "s3b0"}
    assert set(bucket_layer_dims(model[0], 64)) == {"s2b0", "s3b0"}
    assert all(r["outcome"] in OUTCOMES for r in tel["requests"])
    json.dumps(tel)                         # plain JSON


def test_reject_new_and_shed_oldest(model):
    eng = _engine(model, queue_capacity=2)
    r0, r1, r2 = (eng.submit(_img(30 + i)) for i in range(3))
    assert r2.outcome == "rejected" and "capacity 2" in r2.error
    eng = _engine(model, queue_capacity=2, shed_policy="shed_oldest")
    r0, r1, r2 = (eng.submit(_img(40 + i)) for i in range(3))
    assert r0.outcome == "shed"
    eng.run_until_drained()
    assert eng.counters == {"shed": 1, "ok": 2}


def test_malformed_request_is_typed(model):
    eng = _engine(model)
    assert eng.submit(np.zeros(5, np.float32)).outcome == "malformed"
    assert eng.submit("not an image").outcome == "malformed"


# -- deadlines on a fake clock -------------------------------------------------

def test_slow_step_drops_result_past_deadline(model):
    clock = FakeClock()
    eng = _engine(model, clock=clock,
                  step_hook=lambda step, ctx: clock.advance(1.0))
    r = eng.submit(_img(23), deadline=0.5)
    eng.run_until_drained()
    assert r.outcome == "deadline_exceeded" and "result dropped" in r.error
    assert r.result is None


def test_batch_window_holds_partial_batches(model):
    clock = FakeClock()
    eng = _engine(model, batch_window=2.0, clock=clock)
    r = eng.submit(_img(95))
    assert eng.step() == 0 and r.outcome == "pending"
    clock.advance(2.0)
    eng.step()
    assert r.outcome == "ok"


# -- the ladder ----------------------------------------------------------------

def test_transient_kernel_fault_is_retried(model):
    from repro_torch.kernels import ops
    calls = {"n": 0}

    def fail_once(ctx):
        if calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("transient")
    eng = _engine(model, max_retries=2)
    with ops.dispatch_hook_scope(fail_once):
        r = eng.submit(_img(50))
        eng.run_until_drained()
    assert r.outcome == "ok" and r.retries == 1 and not r.degraded
    assert r.ladder == "fp32_kernel"


def test_persistent_kernel_fault_degrades_with_backoff(model):
    from repro_torch.kernels import ops
    sleeps = []

    def always(ctx):
        raise RuntimeError("persistent")
    eng = _engine(model, max_retries=2, retry_backoff=0.05,
                  sleep=sleeps.append)
    with ops.dispatch_hook_scope(always):
        r = eng.submit(_img(51))
        eng.run_until_drained()
    assert sleeps == [0.05, 0.1]
    assert r.outcome == "ok" and r.degraded and r.ladder == "fp32_ref"
    assert eng.counters["degraded_batches"] == 1
    r2 = eng.submit(_img(52))
    eng.run_until_drained()
    assert r2.ladder == "fp32_kernel" and not r2.degraded


@pytest.mark.parametrize("device,entry,rungs", [
    ("cuda", "fp32_kernel", ("fp32_kernel",)),
    ("cuda", "fp32_ref", ("fp32_ref",)),
    ("cpu", "fp32_kernel", ("fp32_kernel", "fp32_ref")),
    ("cpu", "fp32_ref", ("fp32_ref",)),
    ("cuda", "int8_chain", ("int8_chain",)),
    ("cuda", "int8", ("int8",)),
    ("cpu", "int8_chain", ("int8_chain", "int8", "fp32_kernel", "fp32_ref")),
    ("cpu", "int8", ("int8", "fp32_kernel", "fp32_ref")),
])
def test_ladder_never_drops_to_the_plain_path_on_cuda(device, entry, rungs):
    assert ladder(entry, torch.device(device)) == rungs


def test_int8_rungs_need_a_scale_table(model):
    for rung in ("int8_chain", "int8"):
        with pytest.raises(ValueError, match="scale table"):
            _engine(model, quant=rung)
    cfg, params = model
    with pytest.raises(ValueError, match="offset_bound"):
        DCLServingEngine(params, dataclasses.replace(cfg, offset_bound=None),
                         DCLServeConfig(buckets=(BUCKET,)),
                         scale_table={}, device="cpu")
    assert DCLServeConfig(buckets=(BUCKET,)).quant == "int8_chain"


def test_scale_table_loads_from_a_path(model, table, tmp_path):
    from repro_torch.quant.calibrate import save_scale_table
    save_scale_table(table, str(tmp_path / "scales.json"))
    eng = _engine(model, str(tmp_path / "scales.json"), quant="int8")
    assert eng.scale_table["s2b0"]["x_scale"] == table["s2b0"]["x_scale"]
    r = eng.submit(_img(70))
    eng.run_until_drained()
    assert r.outcome == "ok" and r.ladder == "int8"


@pytest.mark.parametrize("rung", ["int8_chain", "int8"])
def test_persistent_int8_kernel_fault_fails_on_the_cuda_ladder(model, table,
                                                               rung):
    """On the CUDA ladder a failing int8 kernel retires its batch
    ``failed``; no other rung serves it."""
    from repro_torch.kernels import ops
    seen = []

    def always(ctx):
        seen.append(ctx["op"])
        raise RuntimeError("int8 kernel launch failed")
    eng = _engine(model, table, quant=rung, max_retries=1)
    eng.rungs = ladder(rung, torch.device("cuda"))
    with ops.dispatch_hook_scope(always):
        r = eng.submit(_img(54))
        eng.run_until_drained()
    assert set(seen) == {"deform_conv_chain" if rung == "int8_chain"
                         else "deform_conv"}
    assert r.outcome == "failed" and "int8 kernel launch failed" in r.error
    assert not r.degraded and r.result is None and r.retries == 2


def test_qtensor_on_the_wrong_scale_raises(model, table):
    from repro_torch.models.layers import dcl_apply
    from repro_torch.quant.qtypes import QTensor
    cfg, params = model
    entry = table["s2b0"]
    c = params["s2b0"]["dcl"]["w_deform"].shape[2]
    x = QTensor(values=torch.zeros(2, 8, 8, c, dtype=torch.int8),
                scale=torch.tensor(3.0 * entry["x_scale"]))
    with pytest.raises(ValueError, match="emitted on scale"):
        dcl_apply(params["s2b0"]["dcl"], x, offset_bound=2.0,
                  use_kernel=True, quant="int8_chain", quant_scales=entry,
                  device="cpu")
    ok = QTensor(values=x.values, scale=torch.tensor(entry["x_scale"]))
    y, _ = dcl_apply(params["s2b0"]["dcl"], ok, offset_bound=2.0,
                     use_kernel=True, quant="int8_chain", quant_scales=entry,
                     device="cpu")
    assert isinstance(y, QTensor) and y.values.shape == (2, 8, 8, c)


@pytest.mark.parametrize("rung", ["int8_chain", "int8"])
def test_int8_rungs_match_jax_engine(model, table, rung):
    """The same params, scale table and traffic through the JAX engine's
    int8 rung (Pallas, interpret mode) and the port's: the same outcomes,
    results within 1e-3 * max|ref|."""
    cfg, params = model
    jparams = {k: {kk: jnp.asarray(vv.numpy()) if torch.is_tensor(vv) else
                   {k3: jnp.asarray(v3.numpy()) for k3, v3 in vv.items()}
                   for kk, vv in v.items()} for k, v in params.items()}
    jeng = JEngine(jparams, JR.ResNetDCNConfig(**SMALL, use_kernel=True),
                   JServeConfig(buckets=(BUCKET,), slots=2, quant=rung),
                   scale_table=table)
    teng = _engine(model, table, quant=rung)
    outs = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        rs = [eng.submit(_img(80 + i)) for i in range(3)]
        eng.run_until_drained()
        outs[name] = rs
    for rj, rt in zip(outs["jax"], outs["torch"]):
        assert rj.outcome == rt.outcome == "ok"
        assert rj.ladder == rt.ladder == rung and not rt.degraded
        for key in ("cls", "box"):
            ref = np.asarray(rj.result[key])
            assert np.abs(rt.result[key] - ref).max() \
                <= 1e-3 * np.abs(ref).max()


def test_persistent_kernel_fault_fails_on_the_cuda_ladder(model):
    """With the CUDA ladder (the kernel rung alone) a kernel that keeps
    failing retires the batch ``failed`` with its error; the plain path
    never serves it."""
    from repro_torch.kernels import ops

    def always(ctx):
        raise RuntimeError("kernel launch failed")
    eng = _engine(model, max_retries=2)
    eng.rungs = ladder("fp32_kernel", torch.device("cuda"))
    with ops.dispatch_hook_scope(always):
        r = eng.submit(_img(53))
        eng.run_until_drained()
    assert r.outcome == "failed" and "kernel launch failed" in r.error
    assert r.retries == 3 and not r.degraded and r.result is None
    assert "degraded_batches" not in eng.counters
    assert eng.telemetry()["counters"] == {"failed": 1, "retries": 3}


# -- configuration -------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(spatial_shards=((32, 2),))])
def test_unported_features_raise(kw):
    """Spatial buckets are ported (``test_torch_spatial.py``); what a
    one-device engine cannot serve raises at construction, and a shard
    count for a bucket the engine lacks at configuration."""
    with pytest.raises(ValueError, match="not in buckets"):
        DCLServeConfig(buckets=(64,), **kw)
    cfg = DCLServeConfig(buckets=(32,), **kw)
    assert cfg.spatial_shards_for(32) == 2
    model = R.ResNetDCNConfig(**SMALL, use_kernel=True)
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        DCLServingEngine(R.init_params(model, seed=0, device="cpu"), model,
                         dataclasses.replace(cfg, quant="fp32_kernel"),
                         device="cpu")


def test_config_validation():
    with pytest.raises(ValueError, match="batch_window"):
        DCLServeConfig(buckets=(32,), batch_window=-1.0)
    with pytest.raises(ValueError, match="slots"):
        DCLServeConfig(buckets=(32,), slots=0)
    with pytest.raises(ValueError, match="unknown serve datapath"):
        DCLServeConfig(buckets=(32,), quant="bf16")


def test_engine_without_cuda_and_without_device_raises(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DCLServingEngine(params, cfg, DCLServeConfig(buckets=(BUCKET,)))


def test_launcher_serves_on_cpu(tmp_path):
    cfg = R.ResNetDCNConfig(**SMALL)
    args = launch.build_parser().parse_args(
        ["--arch", "resnet50_dcn_bounded", "--buckets", "32,64",
         "--requests", "4", "--slots", "2", "--device", "cpu"])
    eng, images, seconds = launch.serve_detection(cfg, args)
    assert len(images) == 4 and eng.steps == 2
    assert eng.counters == {"ok": 4}
    assert eng.scfg.quant == "int8_chain"        # the JAX launcher's default
    assert set(eng.scale_table) == {"s2b0", "s3b0", "_meta"}
    text = launch.report(eng, seconds)
    assert "served 4/4" in text and "on cpu" in text


def test_tracer_records_steps_and_request_events(model):
    from repro_torch.obs.trace import Tracer, get_tracer, tracer_scope
    clock = FakeClock()
    with tracer_scope(Tracer(clock=clock)) as tr:
        eng = _engine(model, clock=clock)
        eng.submit(_img(60))
        eng.run_until_drained()
    assert not get_tracer().enabled            # the default stays off
    recs = tr.records()
    steps = [r for r in recs if r["name"] == "serve/step"]
    assert len(steps) == 1 and steps[0]["attrs"]["bucket"] == BUCKET
    spans = {r["span_id"]: r for r in recs if r["type"] == "span"}
    retire = [r for r in recs
              if r["type"] == "event" and r["name"] == "serve/retire"]
    assert retire[0]["attrs"]["outcome"] == "ok"
    assert spans[retire[0]["parent_id"]]["name"] == "serve/retire"
    assert spans[retire[0]["parent_id"]]["parent_id"] == \
        steps[0]["span_id"]
    hist = eng.telemetry()["metrics"]["histograms"]["serve_latency_seconds"]
    assert hist["values"][0]["count"] == 1
