"""``repro_torch.launch.serve --ckpt [--reduced]``: a params-only
checkpoint written by the JAX package and a Trainer bundle written by
``repro_torch.launch.train`` both serve; the restored params equal JAX's
restore of the same directory (exact: checkpoints hold the bits); a
checkpoint of another width raises the checkpoint's own error and never
serves seeded weights.  Also the reference fault the port does not
share: the JAX launcher restores a Trainer bundle into ``{"params": ...}``
and fails (ROADMAP Queue C)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro import optim as JOPT
from repro.models import registry as jreg
from repro.models import resnet_dcn as JR
from repro_torch import checkpoint as TC
from repro_torch import tree as T
from repro_torch.configs import resnet50_dcn as configs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as reg
from repro_torch.models import resnet_dcn as R
from repro_torch.models import transformer as TF

torch.set_num_threads(2)

ARCH = "resnet50_dcn_bounded"


def _jax_reduced():
    return jreg.reduced_config(jreg.get(ARCH))


def _serve_args(ckpt, *extra):
    return launch.build_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--ckpt", str(ckpt), "--buckets",
         "64", "--requests", "2", "--slots", "2", "--device", "cpu",
         "--quant", "fp32_kernel", *extra])


def _seeded(cfg):
    return R.init_params(launch._served_cfg(cfg), seed=0, device="cpu")


def _equal(a, b) -> bool:
    la, lb = T.leaves_with_paths(a), T.leaves_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_reduced_config_is_the_jax_launchers():
    cfg = launch.detection_config(_serve_args("x"))
    jcfg = _jax_reduced()
    for f in ("stage_sizes", "widths", "stem_width", "num_dcn",
              "num_classes", "img_size", "offset_bound"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full = launch.detection_config(launch.build_parser().parse_args(
        ["--arch", ARCH]))
    assert full == configs.get(ARCH)


def test_params_checkpoint_written_by_jax_serves(tmp_path, capsys):
    jparams = JR.init_params(jax.random.PRNGKey(4), _jax_reduced())
    JC.save_checkpoint(tmp_path, 7, jparams)
    args = _serve_args(tmp_path)
    cfg = launch.detection_config(args)
    restored = launch.load_params(lambda: _seeded(cfg), args)
    assert "restored params from step 7" in capsys.readouterr().out
    assert _equal(restored, params_from_jax(_np(jparams), device="cpu"))
    assert not _equal(restored, _seeded(cfg))
    # End to end through main(): served from the restored params.
    launch.main(["--arch", ARCH, "--reduced", "--ckpt", str(tmp_path),
                 "--buckets", "64", "--requests", "2", "--slots", "2",
                 "--device", "cpu", "--quant", "fp32_kernel"])
    out = capsys.readouterr().out
    assert "restored params from step 7" in out and "served 2/2" in out


def _train_two_steps(ckpt):
    args = launch_train.build_parser().parse_args(
        ["--arch", ARCH, "--steps", "2", "--global-batch", "2",
         "--device", "cpu", "--log-every", "1", "--ckpt", str(ckpt)])
    return launch_train.train_detection(configs.get(ARCH), args)


def test_trainer_bundle_serves_and_equals_jax_restore(tmp_path):
    trainer = _train_two_steps(tmp_path)
    args = _serve_args(tmp_path)
    cfg = launch.detection_config(args)
    restored, step = launch.restore_params(tmp_path, _seeded(cfg), ARCH)
    assert step == 2
    assert _equal(restored, T.tree_map(lambda t: t.detach(),
                                       trainer.params))
    # JAX's restore of the same directory into its Trainer's bundle.
    jparams = JR.init_params(jax.random.PRNGKey(0), _jax_reduced())
    n = sum(p.size for p in jax.tree_util.tree_leaves(jparams))
    jopt = JOPT.default_optimizer_for(ARCH, n)
    bundle = {"params": jparams, "opt": jopt.init(jparams), "ef": None,
              "step": jnp.asarray(0)}
    jrestored, jstep = JC.restore_checkpoint(tmp_path, bundle)
    assert jstep == 2 and int(jrestored["step"]) == 2
    assert _equal(restored,
                  params_from_jax(_np(jrestored["params"]), device="cpu"))
    # The served results are those of the trained params in memory.
    eng, _, _ = launch.serve_detection(cfg, args)
    mem, _, _ = launch.serve_detection(
        cfg, _serve_args(tmp_path), params=T.tree_map(
            lambda t: t.detach(), trainer.params))
    for a, b in zip(eng.completed, mem.completed):
        assert a.outcome == b.outcome == "ok"
        assert np.array_equal(a.result["cls"], b.result["cls"])
        assert np.array_equal(a.result["box"], b.result["box"])


def test_jax_launcher_cannot_restore_a_trainer_bundle(tmp_path):
    """The reference fault: ``repro.launch.serve`` restores into
    ``{"params": params}`` (src/repro/launch/serve.py:44-49), which a
    Trainer bundle ({params, opt, ef, step}) does not fit."""
    jparams = JR.init_params(jax.random.PRNGKey(0), _jax_reduced())
    n = sum(p.size for p in jax.tree_util.tree_leaves(jparams))
    opt = JOPT.default_optimizer_for(ARCH, n)
    JC.save_checkpoint(tmp_path, 3, {"params": jparams,
                                     "opt": opt.init(jparams), "ef": None,
                                     "step": jnp.asarray(3)})
    with pytest.raises(ValueError, match="leaves"):
        JC.restore_checkpoint(tmp_path, {"params": jparams})
    restored, step = launch.restore_params(
        tmp_path, _seeded(launch.detection_config(_serve_args("x"))), ARCH)
    assert step == 3
    assert _equal(restored, params_from_jax(_np(jparams), device="cpu"))


def test_width_mismatch_raises_and_serves_no_seeded_weights(tmp_path):
    _train_two_steps(tmp_path / "reduced")
    # A reduced bundle at the published widths: another tree.
    full = launch.build_parser().parse_args(
        ["--arch", ARCH, "--ckpt", str(tmp_path / "reduced"), "--device",
         "cpu", "--buckets", "64", "--requests", "1"])
    with pytest.raises(ValueError, match="leaves"):
        launch.serve_detection(launch.detection_config(full), full)
    # The same tree at other widths: the shapes differ.
    jcfg = _jax_reduced()
    narrow = jcfg.__class__(**{**jcfg.__dict__,
                               "widths": (16, 32, 64, 128),
                               "stem_width": 8})
    JC.save_checkpoint(tmp_path / "narrow", 1,
                       JR.init_params(jax.random.PRNGKey(0), narrow))
    args = _serve_args(tmp_path / "narrow")
    with pytest.raises(ValueError, match="shape"):
        launch.serve_detection(launch.detection_config(args), args)


def test_port_params_checkpoint_under_either_layout(tmp_path):
    cfg = launch.detection_config(_serve_args("x"))
    params = R.init_params(launch._served_cfg(cfg), seed=5, device="cpu")
    TC.save_checkpoint(tmp_path / "bare", 4, params)
    TC.save_checkpoint(tmp_path / "wrapped", 6, {"params": params})
    for name, want in (("bare", 4), ("wrapped", 6)):
        got, step = launch.restore_params(tmp_path / name, _seeded(cfg),
                                          ARCH)
        assert step == want and _equal(got, params)


def test_lm_branch_serves_a_checkpoint(tmp_path, capsys):
    arch = reg.get("tinyllama-1.1b")
    cfg = reg.reduced_config(arch)
    params = TF.init_params(cfg, seed=3, device="cpu")
    TC.save_checkpoint(tmp_path, 9, params)
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--ckpt",
            str(tmp_path), "--requests", "2", "--max-new-tokens", "3",
            "--device", "cpu"]
    args = launch.build_parser().parse_args(argv)
    eng, _, _ = launch.serve_lm(cfg, args)
    assert "restored params from step 9" in capsys.readouterr().out
    mem, _, _ = launch.serve_lm(cfg, args, params=params)
    assert [r.output for r in eng.completed] == \
        [r.output for r in mem.completed]
    launch.main(argv)
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out
