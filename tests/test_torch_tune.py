"""The port's tuned-tile cache and autotuner: the JAX file format with the
port's keys (batch and a ``cuda_sm90`` / ``cpu`` platform), the
resilience contract (a missing file is cold and silent, a corrupt or
wrong-version one warns once and goes analytic), ``plan.resolve_tiles``
consulting the installed cache (explicit tiles win, an entry the kernel
would not take goes analytic with one warning, ``tile_cache_scope(None)``
shadows an installed cache), ``tiling.neighbor_kernel_tiles`` and the
tuner end to end on the CPU, and the serving engine's plans read from
the cache."""
import json
import logging

import numpy as np
import pytest
import torch

from repro.tune import TileCache as JTileCache
from repro_torch.core import tiling
from repro_torch.core.tiling import (KernelTiles, choose_kernel_tiles,
                                     neighbor_kernel_tiles, tiles_fit)
from repro_torch.kernels import ops, plan
from repro_torch.models import resnet_dcn as R
from repro_torch.serve import (DCLServeConfig, DCLServingEngine,
                               bucket_layer_dims)
from repro_torch.tune import (CACHE_VERSION, TileCache, TileCacheError,
                              active_tile_cache, entry_key,
                              install_tile_cache, load_tile_cache,
                              measure_best_of, platform_of,
                              reset_cache_warnings, tile_cache_scope,
                              tune_deform_conv)

torch.set_num_threads(2)
CPU = torch.device("cpu")
GEOM = dict(kernel_size=3, stride=1, dilation=1, offset_bound=2.0)


@pytest.fixture(autouse=True)
def clean_tune_state():
    reset_cache_warnings()
    install_tile_cache(None)
    plan.reset_tuned_stats()
    yield
    reset_cache_warnings()
    install_tile_cache(None)
    plan.reset_tuned_stats()


def _key(**over):
    kw = dict(n=2, h=8, w=8, c=8, m=8, offset_bound=2.0,
              objective="forward", dtype=None, platform="cpu")
    kw.update(over)
    return kw


def _resolve(dtype="fp32", device=CPU, n=2, **tiles):
    return plan.resolve_tiles(n, 8, 8, 8, 8, dtype=dtype, device=device,
                              **GEOM, **tiles)


def _analytic(dtype="fp32", n=2):
    kt = choose_kernel_tiles(n, 8, 8, 8, 8, dtype=dtype, **GEOM)
    return kt.tile_h, kt.tile_w, kt.tile_c, kt.tile_m


# -- the file ---------------------------------------------------------------

def test_cache_round_trip_in_the_jax_format(tmp_path):
    cache = TileCache()
    key = cache.put({"tiles": [4, 4, 8, 8], "measured_us": 1.5}, **_key())
    assert key == "dcl/2x8x8x8->8/k3s1d1/B2/forward/fp32/cores1/cpu"
    path = cache.save(str(tmp_path / "tiles.json"))
    payload = json.loads(open(path).read())
    assert set(payload) == {"version", "note", "entries"}
    assert payload["version"] == CACHE_VERSION
    # The JAX package reads the file, and the port reads JAX's.
    jcache = JTileCache.load(path)
    assert jcache.entries[key]["tiles"] == [4, 4, 8, 8]
    jpath = str(tmp_path / "jax.json")
    jcache.save(jpath)
    assert TileCache.load(jpath).lookup(**_key())["measured_us"] == 1.5
    assert TileCache.load(path).lookup(**_key(n=4)) is None


def test_key_holds_the_batch_and_the_platform():
    keys = {entry_key(**_key(**kw)) for kw in (
        {}, {"n": 4}, {"platform": "cuda_sm90"}, {"dtype": "int8"},
        {"objective": "training"}, {"stride": 2})}
    assert len(keys) == 6
    assert platform_of("cpu") == "cpu" and platform_of(CPU) == "cpu"


def test_missing_file_is_cold_and_silent(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune"):
        assert load_tile_cache(str(tmp_path / "nope.json")) is None
    assert not caplog.records


def test_corrupt_file_warns_once_and_falls_back(tmp_path, caplog):
    path = tmp_path / "tiles.json"
    path.write_text("{not json")
    with pytest.raises(TileCacheError):
        TileCache.load(str(path))
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune"):
        assert load_tile_cache(str(path)) is None
        assert load_tile_cache(str(path)) is None
    assert len([r for r in caplog.records
                if "falling back" in r.message]) == 1
    install_tile_cache(str(path))
    assert active_tile_cache() is None
    assert _resolve() == _analytic()


@pytest.mark.parametrize("payload,match", [
    ({"version": CACHE_VERSION + 1, "entries": {}}, "version"),
    ({"version": CACHE_VERSION, "entries": []}, "entries"),
], ids=["version", "schema"])
def test_incompatible_files_raise_on_load(tmp_path, payload, match):
    path = tmp_path / "tiles.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(TileCacheError, match=match):
        TileCache.load(str(path))
    assert load_tile_cache(str(path)) is None


# -- resolution --------------------------------------------------------------

def test_resolve_tiles_reads_the_entry_and_the_scope_restores():
    cache = TileCache()
    cache.put({"tiles": [4, 4, 4, 8]}, **_key())
    with tile_cache_scope(cache):
        assert _resolve() == (4, 4, 4, 8)
        assert plan.tile_source(2, 8, 8, 8, 8, device=CPU, **GEOM) == \
            "tuned"
        info = plan.tile_cache_info()
        assert info["tuned_hits"] == 1 and info["tuned_cache"]["installed"]
        # Another batch, a datapath without an entry, no device: analytic.
        assert _resolve(n=4) == _analytic(n=4)
        assert _resolve(dtype="int8") == _analytic("int8")
        assert _resolve(device=None) == _analytic()
        # tile_cache_scope(None) shadows the installed cache.
        with tile_cache_scope(None):
            assert active_tile_cache() is None
            assert _resolve() == _analytic()
        assert active_tile_cache() is cache
    assert active_tile_cache() is None
    assert _resolve() == _analytic()


def test_a_card_entry_is_never_served_on_the_cpu():
    cache = TileCache()
    cache.put({"tiles": [4, 4, 4, 8]}, **_key(platform="cuda_sm90"))
    with tile_cache_scope(cache):
        assert _resolve() == _analytic()
        assert plan.tile_source(2, 8, 8, 8, 8, device=CPU, **GEOM) == \
            "analytic"


def test_explicit_tiles_beat_the_entry():
    cache = TileCache()
    cache.put({"tiles": [4, 4, 4, 8]}, **_key())
    with tile_cache_scope(cache):
        assert _resolve(tile_h=2, tile_w=8, tile_c=8, tile_m=8) == \
            (2, 8, 8, 8)
        # A partial request goes to the chooser around it.
        assert _resolve(tile_h=2)[0] == 2


@pytest.mark.parametrize("dtype,tiles", [
    (None, [4, 4, 3, 8]),           # tile_c does not divide C
    (None, [8, 16, 8, 8]),          # 128 pixels: past the kernels' 64
    (None, [4, 4, 8, "8"]),         # not an int
    ("int8", [4, 4, 2, 8]),         # int8 tile_c not a multiple of 4
], ids=["tile_c", "pixels", "type", "int8_tile_c"])
def test_an_entry_the_kernel_would_not_take_goes_analytic(dtype, tiles,
                                                          caplog):
    cache = TileCache()
    cache.put({"tiles": tiles}, **_key(dtype=dtype))
    path_dtype = dtype or "fp32"
    with tile_cache_scope(cache), \
            caplog.at_level(logging.WARNING, logger="repro_torch.tune"):
        for _ in range(2):
            assert _resolve(path_dtype) == _analytic(path_dtype)
    assert plan.tile_cache_info()["tuned_incompatible"] == 2
    assert len([r for r in caplog.records
                if "incompatible" in r.message]) == 1


@pytest.mark.parametrize("dtype", ["int8", "int8_chain"])
def test_an_int8_entry_with_other_spatial_tiles_goes_analytic(dtype,
                                                              caplog):
    """Its spatial tiles move the band frame the int8 patches round in
    (``test_int8_results_move_with_spatial_tiles_only``), so it would
    change the rung's integers: refused though the kernel takes it; the
    chooser's spatial tiles with other channel tiles serve."""
    th, tw, _, tm = _analytic(dtype)
    other = [th // 2, tw, 4, tm]
    assert tiles_fit(*other, c=8, m=8, dtype=dtype, **GEOM)
    cache = TileCache()
    cache.put({"tiles": other}, **_key(dtype=dtype))
    with tile_cache_scope(cache), \
            caplog.at_level(logging.WARNING, logger="repro_torch.tune"):
        assert _resolve(dtype) == _analytic(dtype)
        assert plan.tile_source(2, 8, 8, 8, 8, dtype=dtype, device=CPU,
                                **GEOM) == "analytic"
    assert plan.tile_cache_info()["tuned_incompatible"] == 1
    assert any("incompatible" in r.message for r in caplog.records)
    cache.put({"tiles": [th, tw, 4, tm]}, **_key(dtype=dtype))
    with tile_cache_scope(cache):
        assert _resolve(dtype) == (th, tw, 4, tm)


def test_one_resolution_gives_the_tiles_and_their_source():
    """``resolve_tiles_and_source``: explicit, tuned or analytic, counted
    once; ``tile_source`` and ``count=False`` count nothing;
    ``warm_tile_cache`` resolves each layer once."""
    cache = TileCache()
    cache.put({"tiles": [4, 4, 4, 8]}, **_key())
    kw = dict(dtype="fp32", device=CPU, **GEOM)
    with tile_cache_scope(cache):
        assert plan.resolve_tiles_and_source(2, 8, 8, 8, 8, **kw) == \
            ((4, 4, 4, 8), "tuned")
        assert plan.resolve_tiles_and_source(4, 8, 8, 8, 8, **kw) == \
            (_analytic(n=4), "analytic")
        assert plan.resolve_tiles_and_source(
            2, 8, 8, 8, 8, tile_h=2, tile_w=8, tile_c=8, tile_m=8,
            **kw) == ((2, 8, 8, 8), "explicit")
        counted = dict(plan.tile_cache_info())
        assert plan.resolve_tiles_and_source(2, 8, 8, 8, 8, count=False,
                                             **kw)[1] == "tuned"
        assert plan.tile_source(2, 8, 8, 8, 8, device=CPU, **GEOM) == \
            "tuned"
        assert plan.tile_cache_info() == counted
        assert (counted["tuned_hits"], counted["analytic_resolves"]) == \
            (1, 1)
        plan.reset_tuned_stats()
        layers = {"a": dict(h=8, w=8, c=8, m=8),
                  "b": dict(h=16, w=16, c=8, m=8)}
        tiles, sources = plan.warm_tile_cache(layers, batch=2,
                                              offset_bound=2.0, device=CPU)
    assert tiles["a"] == (4, 4, 4, 8) and sources == {"a": "tuned",
                                                      "b": "analytic"}
    info = plan.tile_cache_info()
    assert (info["tuned_hits"], info["analytic_resolves"]) == (1, 1)


def test_shared_memory_past_a_block_goes_analytic():
    h = w = 64
    big = [8, 8, 256, 128]          # a 256-channel chunk: too much smem
    assert not tiles_fit(*big, c=256, m=128, dtype="fp32", **GEOM)
    cache = TileCache()
    cache.put({"tiles": big}, **_key(h=h, w=w, c=256, m=128))
    with tile_cache_scope(cache):
        got = plan.resolve_tiles(2, h, w, 256, 128, device=CPU, **GEOM)
    kt = choose_kernel_tiles(2, h, w, 256, 128, **GEOM)
    assert got == (kt.tile_h, kt.tile_w, kt.tile_c, kt.tile_m)


def test_the_backward_reads_a_training_entry():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 8, 8, generator=g, requires_grad=True)
    off = (torch.randn(2, 8, 8, 18, generator=g) * 2).requires_grad_(True)
    w = (torch.randn(9, 8, 8, generator=g) * 0.1).requires_grad_(True)

    def grads():
        y = ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
        return torch.autograd.grad(y.sum(), (x, off, w))
    default = grads()
    seed = _analytic("fp32_bwd")
    tuned = [2, 4, 2, seed[3]]
    assert list(seed) != tuned
    cache = TileCache()
    cache.put({"tiles": tuned}, **_key(objective="training"))
    with tile_cache_scope(cache):
        assert _resolve("fp32_bwd") == tuple(tuned)
        assert _resolve("fp32") == _analytic()      # the forward's own
        got = grads()
        assert plan.tile_cache_info()["tuned_hits"] >= 1
    for a, b in zip(default, got):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


# -- candidates and the tuner ---------------------------------------------

@pytest.mark.parametrize("dtype", tiling.TUNABLE)
def test_neighbor_tiles(dtype):
    n, h, c, m = 4, 16, 32, 48
    seed = choose_kernel_tiles(n, h, h, c, m, dtype=dtype, **GEOM)
    cands = neighbor_kernel_tiles(n, h, h, c, m, seed, dtype=dtype, **GEOM)
    assert cands[0] == seed and len(cands) == len(set(cands)) > 1
    for kt in cands:
        assert c % kt.tile_c == 0 and m % kt.tile_m == 0
        assert kt.tile_h * kt.tile_w <= tiling.PIX_LANES[-1]
        assert tiles_fit(kt.tile_h, kt.tile_w, kt.tile_c, kt.tile_m, c=c,
                         m=m, dtype=dtype, **GEOM)
    if dtype in ("int8", "int8_chain"):
        assert all(kt.tile_c % 4 == 0 for kt in cands)
        assert {(kt.tile_h, kt.tile_w) for kt in cands} == \
            {(seed.tile_h, seed.tile_w)}
    # The seed is kept even where the filter would refuse it.
    odd = KernelTiles(8, 16, 3, 48)
    assert neighbor_kernel_tiles(n, h, h, c, m, odd, dtype=dtype,
                                 **GEOM)[0] == odd
    with pytest.raises(ValueError, match="tunable"):
        tiles_fit(4, 4, 4, 4, c=4, m=4, dtype="sample", **GEOM)


def test_int8_results_move_with_spatial_tiles_only():
    """Why the tuner keeps the int8 spatial tiles: channel tiles regroup
    exact integer sums, while a spatial tile moves the band-local frame in
    which the sampling positions round, which can round a patch to
    another int8 value."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 32, 32, generator=g)
    w = torch.randn(9, 32, 32, generator=g) * 0.1
    w_off = torch.randn(9, 32, 18, generator=g) * 0.3
    b_off = torch.randn(18, generator=g)

    def run(th, tw, tc, tm):
        return ops.deform_conv_chain(
            x, w, w_off, b_off, offset_bound=2.0, emit="fp32",
            x_scale=x.abs().max() / 127, tile_h=th, tile_w=tw, tile_c=tc,
            tile_m=tm, device="cpu")
    base = run(4, 4, 16, 32)
    for tiles in ((4, 4, 4, 32), (4, 4, 16, 8), (4, 4, 32, 16)):
        assert torch.equal(run(*tiles), base), tiles
    assert not torch.equal(run(8, 8, 16, 32), base)


def test_measure_best_of_keeps_its_own_registry():
    from repro_torch.obs import Tracer, tracer_scope
    calls = []
    with tracer_scope(Tracer()) as tr:
        s = measure_best_of(lambda: calls.append(1), (), reps=3,
                            context=dict(op="deform_conv", shape=(1, 8, 8,
                                                                  8), m=8,
                                         offset_bound=2.0, device="cpu"))
    assert len(calls) == 4 and s >= 0       # one untimed call, then 3
    assert len([sp for sp in tr.spans if sp.name == "kernel/dispatch"]) \
        == 3


def test_tune_end_to_end_sweeps_the_serving_datapaths():
    cache = TileCache()
    res = tune_deform_conv(h=8, w=8, c=8, m=8, batch=2, objective="forward",
                           reps=1, max_candidates=3, cache=cache,
                           device="cpu")
    assert res["platform"] == "cpu" and res["n_candidates"] >= 1
    assert res["tuned_vs_analytic_ratio"] >= 1.0     # argmin with the seed
    assert set(res["quant_sweep"]) == {"int8", "int8_chain"}
    assert res["analytic"]["tiles"] == list(_analytic())
    for dtype in (None, "int8", "int8_chain"):
        entry = cache.lookup(**_key(dtype=dtype))
        assert entry["cores"] == 1 and entry["batch"] == 2
        assert entry["dw_flush_every_step"] is None
        with tile_cache_scope(cache):
            assert list(_resolve(dtype or "fp32")) == entry["tiles"]
    res2 = tune_deform_conv(h=8, w=8, c=8, m=8, batch=2,
                            objective="training", reps=1, max_candidates=2,
                            cache=cache, device="cpu")
    assert "quant_sweep" not in res2
    assert res2["analytic"]["tiles"] == list(_analytic("fp32_bwd"))
    assert cache.lookup(**_key(objective="training")) is not None
    assert cache.lookup(**_key(objective="training", dtype="int8")) is None


def test_a_failing_candidate_is_counted_listed_and_warned(monkeypatch,
                                                         caplog):
    """Every candidate passed ``tiles_fit``, so one that raises is a
    fault: the result says how many of how many were measured and which
    failed, and the tuner warns."""
    real = tiling.neighbor_kernel_tiles

    def with_a_bad_one(*args, **kw):
        cands = real(*args, **kw)
        seed = cands[0]
        return [seed, KernelTiles(seed.tile_h, seed.tile_w, 3,
                                  seed.tile_m)]
    monkeypatch.setattr(tiling, "neighbor_kernel_tiles", with_a_bad_one)
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune"):
        res = tune_deform_conv(h=8, w=8, c=8, m=8, batch=2,
                               objective="forward", sweep_quant=(None,),
                               reps=1, device="cpu")
    seed = _analytic()
    assert (res["n_given"], res["n_candidates"]) == (2, 1)
    (bad,) = res["failed"]
    assert bad["tiles"] == [seed[0], seed[1], 3, seed[3]]
    assert bad["error"].startswith("ValueError")
    assert any("candidate" in r.message and r.levelno == logging.WARNING
               for r in caplog.records)
    monkeypatch.undo()
    ok = tune_deform_conv(h=8, w=8, c=8, m=8, batch=2, objective="forward",
                          sweep_quant=(None,), reps=1, max_candidates=2,
                          device="cpu")
    assert ok["n_candidates"] == ok["n_given"] and ok["failed"] == []


def test_tune_rejects_bad_combinations():
    with pytest.raises(ValueError, match="inference"):
        tune_deform_conv(h=8, w=8, c=8, m=8, objective="training",
                         dtype="int8_chain", device="cpu")
    with pytest.raises(ValueError, match="quant mode"):
        tune_deform_conv(h=8, w=8, c=8, m=8, objective="forward",
                         sweep_quant=("fp8",), device="cpu")
    with pytest.raises(ValueError, match="objective"):
        tune_deform_conv(h=8, w=8, c=8, m=8, objective="latency",
                         device="cpu")


# -- the serving engine ----------------------------------------------------

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)


@pytest.mark.parametrize("rung", ["fp32_kernel", "int8_chain"])
def test_engine_serves_the_tuned_plans(rung):
    from repro_torch.quant.calibrate import calibrate_resnet_dcn
    bucket = 32
    cfg = R.ResNetDCNConfig(**SMALL, use_kernel=True)
    params = R.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    table = calibrate_resnet_dcn(
        params, cfg, [rng.randn(2, bucket, bucket, 3).astype(np.float32)],
        device="cpu") if rung == "int8_chain" else None
    dtype = "int8_chain" if rung == "int8_chain" else "fp32"
    cache, tuned = TileCache(), {}
    for name, d in bucket_layer_dims(cfg, bucket).items():
        kt = choose_kernel_tiles(2, d["h"], d["w"], d["c"], d["m"],
                                 stride=d["stride"], dtype=dtype,
                                 kernel_size=3, offset_bound=2.0)
        # Other tiles the kernel takes: channel tiles only for int8 (see
        # test_int8_results_move_with_spatial_tiles_only).
        tuned[name] = (kt.tile_h, kt.tile_w, 4, kt.tile_m // 2) \
            if dtype == "int8_chain" else \
            (max(1, kt.tile_h // 2), kt.tile_w, kt.tile_c // 2, kt.tile_m)
        cache.put({"tiles": list(tuned[name])}, **_key(
            h=d["h"], w=d["w"], c=d["c"], m=d["m"], stride=d["stride"],
            dtype=None if dtype == "fp32" else dtype))
    images = [rng.randn(bucket, bucket, 3).astype(np.float32)
              for _ in range(2)]

    def serve():
        eng = DCLServingEngine(params, cfg, DCLServeConfig(
            buckets=(bucket,), slots=2, quant=rung), scale_table=table,
            device="cpu")
        for im in images:
            eng.submit(im)
        eng.run_until_drained()
        return eng
    analytic = serve()
    with tile_cache_scope(cache):
        eng = serve()
    tel = eng.telemetry()
    assert eng.plans[bucket] == tuned
    assert set(tel["plan_sources"][str(bucket)].values()) == {"tuned"}
    assert tel["plan_cache"]["tuned_hits"] >= len(tuned)
    assert set(analytic.telemetry()["plan_sources"][str(bucket)]
               .values()) == {"analytic"}
    for a, b in zip(analytic.completed, eng.completed):
        for key in ("cls", "box"):
            want, got = a.result[key], b.result[key]
            if rung == "int8_chain":        # integer sums: any grouping
                assert np.array_equal(want, got)
            else:
                assert np.abs(want - got).max() <= \
                    1e-5 * np.abs(want).max()
