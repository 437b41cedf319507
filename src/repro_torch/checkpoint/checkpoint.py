"""Checkpoints: atomic, keep-k, async, verified (counterpart of
``repro.checkpoint.checkpoint``, same layout on disk).

    <dir>/step_00000120/
        manifest.json        {step, paths, leaves: [{index, shape, dtype,
                              crc32}]}
        000.npy ... NNN.npy  one file per leaf

Leaves are the tree's in JAX's flatten order (sorted dict keys, ``None``
an empty subtree).  The port records each leaf's key path (``paths``) in
place of JAX's ``treedef`` string and checks it on restore; a checkpoint
written by the JAX package has no paths and is restored by leaf order
and shape.  Writes go to ``step_X.tmp`` and are renamed into place, so a
crash mid-write never damages the latest checkpoint; ``keep`` bounds the
steps kept.  Every leaf's CRC32 is verified on restore: a damaged
checkpoint raises ``CheckpointCorruptError``, and the restore of the
latest step falls back to the previous complete one.  The manager sweeps
stale ``step_*.tmp`` directories when it is created and writes in a
background thread, one write at a time.

A leaf laid out on a mesh (``distributed.sharding.Placed``) is gathered
whole before it is written, so the files carry no mesh: a checkpoint of a
sharded Trainer has the layout of a flat one's.  ``shardings`` (a tree of
``sharding.Sharding``, JAX's ``NamedSharding``) lays each restored leaf
out on a mesh, whatever mesh wrote it (the elastic restore); without
one, a leaf goes where its template lies, a placed template's leaf
placed as the template is.
"""
from __future__ import annotations

import json
import logging
import os
import pathlib
import re
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed.sharding import gather, is_placed, place

PathLike = str | os.PathLike

_log = logging.getLogger("repro_torch.checkpoint")


class CheckpointCorruptError(RuntimeError):
    """A stored checkpoint failed verification (manifest / leaf / CRC)."""


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its logical dtype name; bfloat16, which
    numpy lacks, is stored as its raw 16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if str(arr.dtype) != logical:
        raise CheckpointCorruptError(
            f"leaf stored as {arr.dtype} but the manifest says {logical}")
    return torch.from_numpy(np.array(arr, copy=True))


def _host(x):
    """A leaf on the host: a tensor detached and copied, a placed leaf
    gathered whole, anything else as a numpy array."""
    if isinstance(x, torch.Tensor) or is_placed(x):
        with torch.no_grad():
            return gather(x, device="cpu").detach().clone()
    return np.array(x)


def save_checkpoint(directory: PathLike, step: int, tree: Any, *,
                    keep: int = 3) -> pathlib.Path:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    if any(is_placed(x) for x in T.leaves(tree, is_leaf=is_placed)):
        tree = T.tree_map(_host, tree, is_leaf=is_placed)
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    pairs = T.leaves_with_paths(tree)
    manifest = {"step": step, "paths": [list(p) for p, _ in pairs],
                "leaves": []}
    for i, (_, leaf) in enumerate(pairs):
        arr, logical = _to_numpy(leaf)
        np.save(tmp / f"{i:03d}.npy", arr)
        manifest["leaves"].append({
            "index": i, "shape": list(arr.shape), "dtype": logical,
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes())})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in directory.iterdir()
                   if re.fullmatch(r"step_\d{8}", p.name))
    for p in steps[:-keep] if keep else []:
        shutil.rmtree(p, ignore_errors=True)


def complete_steps(directory: PathLike) -> list[int]:
    """Steps with a published directory and manifest, newest first."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if re.fullmatch(r"step_\d{8}", p.name)
             and (p / "manifest.json").exists()]
    return sorted(steps, reverse=True)


def latest_step(directory: PathLike) -> int | None:
    steps = complete_steps(directory)
    return steps[0] if steps else None


def stored_structure(directory: PathLike) -> tuple[int, list | None]:
    """(leaf count, key paths) of the newest complete checkpoint in
    ``directory`` whose manifest reads; the paths are None for one
    written by the JAX package.  Raises ``FileNotFoundError`` when there
    is none."""
    directory = pathlib.Path(directory)
    for s in complete_steps(directory):
        try:
            manifest = _load_manifest(directory / f"step_{s:08d}")
        except CheckpointCorruptError:
            continue
        paths = manifest.get("paths")
        return len(manifest["leaves"]), (
            None if paths is None else [tuple(q) for q in paths])
    raise FileNotFoundError(f"no readable checkpoint in {directory}")


def _load_manifest(path: pathlib.Path) -> dict:
    mf = path / "manifest.json"
    if not mf.exists():
        raise CheckpointCorruptError(f"{path}: manifest.json missing")
    try:
        manifest = json.loads(mf.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"{path}: manifest.json unreadable ({e})") from e
    if not isinstance(manifest.get("leaves"), list):
        raise CheckpointCorruptError(f"{path}: manifest has no leaf table")
    return manifest


def _restore_step(path: pathlib.Path, tree_like: Any,
                  shardings: Any = None) -> Any:
    """Load and verify one published checkpoint into the structure of
    ``tree_like``, each leaf laid out by its ``shardings`` entry, else as
    its template.

    Raises ``CheckpointCorruptError`` for damage on disk and
    ``ValueError`` when the checkpoint does not fit the template (leaf
    count, key paths, or shapes of a checkpoint without paths): no older
    checkpoint can fix the latter, so it never triggers the fallback.
    """
    manifest = _load_manifest(path)
    like = T.leaves_with_paths(tree_like, is_leaf=is_placed)
    layout = dict(T.leaves_with_paths(shardings))
    n = len(like)
    if n != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint {path} has {len(manifest['leaves'])} leaves but "
            f"the restore target has {n} — the stored tree and the "
            f"template passed to restore_checkpoint disagree")
    stored = manifest.get("paths")
    if stored is not None and [tuple(p) for p in stored] \
            != [p for p, _ in like]:
        diff = next(i for i, (a, (b, _)) in enumerate(zip(stored, like))
                    if tuple(a) != b)
        raise ValueError(
            f"checkpoint {path} was saved with another structure: leaf "
            f"{diff} is {'/'.join(stored[diff])} there and "
            f"{'/'.join(like[diff][0])} in the restore target")
    out = []
    for i, (key, tmpl) in enumerate(like):
        entry = manifest["leaves"][i]
        leaf_path = path / f"{i:03d}.npy"
        if not leaf_path.exists():
            raise CheckpointCorruptError(f"{path}: leaf {i:03d}.npy missing")
        try:
            arr = np.load(leaf_path)
        except (ValueError, OSError, EOFError) as e:
            raise CheckpointCorruptError(
                f"{path}: leaf {i:03d}.npy unreadable ({e})") from e
        if list(arr.shape) != list(entry["shape"]):
            raise CheckpointCorruptError(
                f"{path}: leaf {i:03d}.npy has shape {list(arr.shape)}, "
                f"manifest says {entry['shape']}")
        want_crc = entry.get("crc32")
        if want_crc is not None:
            got_crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got_crc != want_crc:
                raise CheckpointCorruptError(
                    f"{path}: leaf {i:03d}.npy CRC32 {got_crc:#010x} != "
                    f"manifest {want_crc:#010x} (bit-rot or a partial "
                    f"write)")
        tshape = tuple(getattr(tmpl, "shape", np.shape(tmpl)))
        if tuple(arr.shape) != tshape:
            raise ValueError(
                f"checkpoint {path} leaf {i} ({'/'.join(key)}) has shape "
                f"{tuple(arr.shape)}, the restore target {tshape}")
        t = _to_tensor(arr, entry["dtype"])
        if key in layout:
            t = layout[key].place(t)
        elif is_placed(tmpl):
            t = place(t, tmpl.spec, tmpl.mesh)
        else:
            t = t.to(tmpl.device if isinstance(tmpl, torch.Tensor)
                     else "cpu")
        out.append((key, t))
    return _rebuild(tree_like, dict(out))


def _rebuild(tree_like: Any, by_path: dict, prefix=()) -> Any:
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _rebuild(v, by_path, prefix + (k,))
                for k, v in tree_like.items()}
    return by_path[prefix]


def restore_checkpoint(directory: PathLike, tree_like: Any, *,
                       step: int | None = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``: each leaf laid out by
    its entry of ``shardings`` (a tree of ``sharding.Sharding`` over the
    same paths) where it has one, else as its template (on the
    template's device, or placed as a placed template).  With
    ``step=None`` a corrupt checkpoint is logged and skipped for the
    previous complete step; an explicit ``step`` raises
    ``CheckpointCorruptError`` directly."""
    directory = pathlib.Path(directory)
    if step is not None:
        return _restore_step(directory / f"step_{step:08d}", tree_like,
                             shardings), step
    steps = complete_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    last_err: CheckpointCorruptError | None = None
    for s in steps:
        try:
            restored = _restore_step(directory / f"step_{s:08d}", tree_like,
                                     shardings)
        except CheckpointCorruptError as e:
            _log.warning("checkpoint step %d failed verification (%s); "
                         "falling back to the previous complete step", s, e)
            last_err = e
            continue
        if last_err is not None:
            _log.warning("recovered from a corrupt checkpoint: restored "
                         "step %d instead", s)
        return restored, s
    raise CheckpointCorruptError(
        f"every checkpoint in {directory} failed verification; last "
        f"error: {last_err}")


class CheckpointManager:
    """Background writer with one write in flight and keep-k GC.  Stale
    ``step_*.tmp`` directories (a writer killed mid-save) are swept when
    the manager is created."""

    def __init__(self, directory: PathLike, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        if self.directory.exists():
            for p in self.directory.glob("step_*.tmp"):
                if p.is_dir():
                    _log.warning("removing stale checkpoint temp dir %s", p)
                    shutil.rmtree(p, ignore_errors=True)

    def wait(self) -> None:
        """Join the in-flight write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any) -> None:
        from repro_torch.obs.trace import get_tracer
        # The span covers the synchronous part (the copy to the host and
        # the handoff); the writer thread never touches the tracer.
        with get_tracer().span("ckpt/save", step=step,
                               sync=not self.async_write):
            self.wait()
            # On the host before returning, so the caller may go on
            # updating its tensors in place; a placed leaf gathered whole.
            host = T.tree_map(_host, tree, is_leaf=is_placed)
            if not self.async_write:
                save_checkpoint(self.directory, step, host, keep=self.keep)
                return

            def work():
                try:
                    save_checkpoint(self.directory, step, host,
                                    keep=self.keep)
                except BaseException as e:  # noqa: BLE001 — wait() raises
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore(self, tree_like: Any, *, step: int | None = None,
                shardings: Any = None):
        from repro_torch.obs.trace import get_tracer
        with get_tracer().span("ckpt/restore", step=step):
            return restore_checkpoint(self.directory, tree_like, step=step,
                                      shardings=shardings)

    def latest_step(self) -> int | None:
        return latest_step(self.directory)
