"""Port parity: the dry run's rule experiments (``launch.dryrun``'s
``run_cell(rules=)`` and its ``--set-rule``, ``--tag`` and
``--skip-existing``) against the JAX package.

* Under explicit rules the port's spec trees equal those JAX's builders
  hand to ``jax.jit`` under ``_merged_rules(arch, rules)``, leaf for leaf,
  on both production meshes (JAX's under a stand-in mesh of the axis
  sizes, as ``test_torch_dryrun.py`` does).
* A training cell's record under a rule carries it in ``rule_overrides``
  and takes its argument and collective bytes from the same rules; a
  prefill cell keeps the serving rules, as JAX's does.
* The CLI writes a tagged record beside the untagged one, and
  ``--skip-existing`` skips a record without an error and reruns one
  that holds an error.
"""
import dataclasses
import json
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.distributed import sharding as JS
from repro.launch import steps as JSteps
from repro.models import registry as JReg
from repro.optim import default_optimizer_for as j_default_optimizer
from repro.optim import opt_state_specs as j_opt_state_specs
from repro_torch import tree as T
from repro_torch.distributed import sharding as TS
from repro_torch.launch import collectives, dryrun, roofline, steps
from repro_torch.models import registry as reg
from repro_torch.models.registry import ShapeSpec

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# (arch, rule, whether a leaf moves from the arch's own layout): dbrx's
# own override is experts -> model; grok's 8 experts do not divide over
# model = 16, so the rule leaves them whole; the defaults given
# explicitly replace dbrx's override.
EXPERIMENTS = [("dbrx-132b", {"experts": "model"}, False),
               ("grok-1-314b", {"experts": "model"}, False),
               ("tinyllama-1.1b", {"embed": None}, True),
               ("dbrx-132b", {"experts": None}, True)]


def _rules(override: dict) -> dict:
    """What ``--set-rule`` builds: the defaults with ``override``."""
    return {**TS.DEFAULT_RULES, **override}


def _standin(kind):
    shape, names = MESHES[kind]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _jax_train_specs(arch, shape_name, mesh, rules):
    """The spec trees JAX's ``make_train_step`` hands to ``jax.jit``
    under ``rules``."""
    with JS.use_rules(rules=JSteps._merged_rules(arch, rules), mesh=mesh):
        p = JSteps.arch_param_specs(arch)
        opt = j_default_optimizer(arch.name, JSteps.arch_param_count(arch))
        o = j_opt_state_specs(opt, p)
        b = JReg.input_shardings(arch, shape_name, mesh)["batch"]
    return (p, o, P(), b)


def _flat(tree):
    """(path, spec tuple) of every leaf of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(tuple(k.key for k in p), tuple(s)) for p, s in leaves]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("name,override,moves", EXPERIMENTS,
                         ids=[f"{n}-{k}={v}" for n, o, _ in EXPERIMENTS
                              for k, v in o.items()])
def test_rule_experiment_specs_equal_jax(name, override, moves, mesh_kind):
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    rules = _rules(override)
    arch = reg.get(name)
    mesh = dryrun.meta_mesh(mesh_kind)
    _, inputs, specs, _ = steps.make_cell_step(arch, "train_4k", mesh,
                                               rules=rules)
    want = _jax_train_specs(JReg.get(name), "train_4k",
                            _standin(mesh_kind), rules)
    _, _, default, _ = steps.make_cell_step(arch, "train_4k", mesh)
    moved = 0
    for got_tree, exp_tree, base_tree in zip(specs, want, default):
        if isinstance(got_tree, tuple):
            assert got_tree == tuple(exp_tree)
            continue
        got = T.leaves_with_paths(got_tree)
        exp = _flat(exp_tree)
        assert [p for p, _ in got] == [p for p, _ in exp]
        for (path, g), (_, e) in zip(got, exp):
            assert g == e, (mesh_kind, path, g, e)
        moved += sum(g != b for (_, g), (_, b) in
                     zip(got, T.leaves_with_paths(base_tree)))
    assert (moved > 0) == moves
    for tree, spec in zip(inputs, specs):
        dryrun.tree_shard_bytes(tree, spec, mesh)


def _reduced_cell(name, shape):
    arch = reg.get(name)
    arch = dataclasses.replace(arch, config=reg.reduced_config(arch))
    return steps.with_shape(arch, "t", shape)


def test_training_record_follows_the_rules():
    """A reduced tinyllama training cell on 16x16 under ``embed=None``:
    ``rule_overrides`` holds the rule; argument bytes a device are the
    shards' under the rules (the params no longer FSDP-sharded over
    ``data``: more than the default record's); collective bytes are
    ``lm_collectives``' under the rules."""
    arch = _reduced_cell("tinyllama-1.1b", ShapeSpec("train", 16, 2))
    rules = _rules({"embed": None})
    trace = dryrun.trace_cell(arch, "t")
    rec = dryrun.run_cell(arch.name, "t", "single", arch=arch, trace=trace,
                          rules=rules)
    base = dryrun.run_cell(arch.name, "t", "single", arch=arch, trace=trace)
    assert rec["rule_overrides"] == {"embed": None}
    assert "rule_overrides" not in base
    mesh = dryrun.meta_mesh("single")
    _, inputs, specs, _ = steps.make_cell_step(arch, "t", mesh, rules=rules)
    assert rec["argument_bytes"] == sum(
        dryrun.tree_shard_bytes(t, s, mesh) for t, s in zip(inputs, specs))
    assert rec["argument_bytes"] > base["argument_bytes"]
    assert rec["argument_bytes_by_group"]["batch"] \
        == base["argument_bytes_by_group"]["batch"]
    want = collectives.lm_collectives(
        arch.config, mesh, mode="train", batch=2, seq=16, rules=rules,
        micro=steps.microbatches(arch)).summary()
    assert rec["collectives"] == want
    assert rec["collective_bytes"] == want["total_bytes"] / 256
    assert rec["collective_bytes"] != base["collective_bytes"]
    # the trace does not depend on the rules
    assert rec["flops"] == base["flops"] == trace["flops"]


def test_prefill_record_keeps_the_serving_rules():
    arch = _reduced_cell("tinyllama-1.1b", ShapeSpec("prefill", 16, 2))
    trace = dryrun.trace_cell(arch, "t")
    rec = dryrun.run_cell(arch.name, "t", "single", arch=arch, trace=trace,
                          rules=_rules({"embed": None, "heads": None}))
    base = dryrun.run_cell(arch.name, "t", "single", arch=arch, trace=trace)
    assert rec["rule_overrides"] == {"embed": None, "heads": None}
    assert "rule_overrides" not in base
    for k in ("argument_bytes", "argument_bytes_by_group", "output_bytes",
              "collectives", "collective_bytes"):
        assert rec[k] == base[k], k


def test_cli_tag_and_skip_existing(tmp_path, capsys):
    """``--set-rule`` (repeatable, ``none``), ``--tag`` and
    ``--skip-existing`` on one registry cell."""
    cell = ["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh",
            "single", "--dir", str(tmp_path)]
    untagged = tmp_path / "tinyllama-1.1b__decode_32k__single.json"
    untagged.write_text('{"kept": true}')
    args = cell + ["--set-rule", "experts=model", "--set-rule", "embed=none",
                   "--tag", "x"]
    dryrun.main(args)
    tagged = tmp_path / "tinyllama-1.1b__decode_32k@x__single.json"
    assert tagged == dryrun.record_path("tinyllama-1.1b", "decode_32k",
                                        "single", "x", tmp_path)
    rec = json.loads(tagged.read_text())
    assert rec["shape"] == "decode_32k@x"
    assert rec["rule_overrides"] == {"experts": "model", "embed": None}
    assert json.loads(untagged.read_text()) == {"kept": True}
    # the roofline reads a tagged record by its shape
    row = next(r for r in roofline.load_all("single", tmp_path)
               if r["shape"] == "decode_32k@x")
    assert row["model_flops_per_device"] > 0
    capsys.readouterr()
    stamp = tagged.stat().st_mtime_ns
    dryrun.main(args + ["--skip-existing"])
    assert "[skip] tinyllama-1.1b decode_32k@x single" \
        in capsys.readouterr().out
    assert tagged.stat().st_mtime_ns == stamp
    # a record that holds an error is run again
    tagged.write_text(json.dumps({**rec, "error": "planted"}))
    dryrun.main(args + ["--skip-existing"])
    assert "[skip]" not in capsys.readouterr().out
    again = json.loads(tagged.read_text())
    assert "error" not in again and again["argument_bytes"] \
        == rec["argument_bytes"]
    assert dryrun.parse_rules([]) is None
    assert dryrun.parse_rules(["embed=None"])["embed"] is None
