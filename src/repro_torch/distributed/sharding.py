"""Logical-axis sharding rules and the port's device mesh (counterpart of
``repro.distributed.sharding``).

Model code tags tensor dimensions with *logical* names ('batch', 'ff',
'vocab', ...); the active ``AxisRules`` map them to mesh axes, and every
lookup is guarded by a divisibility check against the live mesh: a
logical axis whose dimension does not divide stays unsharded.

The mesh is single-controller, as a JAX ``Mesh`` under ``shard_map`` is:
one process drives every device.  A ``Mesh`` is named axes over an array
of ``torch.device`` s; the sharded paths (``kernels.ops``' batch shard,
``distributed.spatial``, ``distributed.pipeline``) move each shard to its
device with ``.to``, exchange neighbours' rows the same way and sum
shards' tensors in a fixed order on one device.  A mesh may repeat a
device (``Mesh([cuda0] * 4, ("model",))``): every shard, exchange and
kernel launch then runs on that one device, the counterpart of XLA's
forced host device count.  Only an explicit caller builds such a mesh;
``launch.mesh.make_host_mesh`` takes the visible devices.

The port has no GSPMD: a layer that no sharded path covers runs whole on
the mesh's first device, and ``logical_constraint`` is the identity.

Default mapping (single pod (data=16, model=16); multi-pod adds 'pod'):

    batch   -> ('pod', 'data')     DP across pods and the data axis
    seq     -> None
    embed   -> 'data'              ZeRO/FSDP
    heads, kv, ff, vocab -> 'model'
    spatial -> 'model'             the DCLs' height shards
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

AxisRules = Mapping[str, str | tuple[str, ...] | None]

DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",
    "embed": "data",
    "embed_no_fsdp": None,
    "heads": "model",
    "kv": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": None,
    "model": "model",
    "data": "data",
    "conv_in": None,
    "conv_out": None,
    "spatial": "model",
    "rnn": "model",
}

# Serving: params replicated across 'data' (sharded on 'model' only) when
# the TP shard of the weights fits next to the KV cache.
SERVE_RULES: AxisRules = {**DEFAULT_RULES, "embed": None}

SERVE_REPLICATION_BUDGET_BYTES = 8 << 30   # bf16 TP-shard budget


class Mesh:
    """Named axes over an array of devices.

    ``devices``: a nested sequence (or array) of ``torch.device`` or
    device strings whose shape is the mesh's; ``axis_names`` one name an
    axis.  ``devices`` is kept as a numpy object array, as a JAX mesh
    keeps its devices, so ``dict(zip(mesh.axis_names,
    mesh.devices.shape))`` gives the axis sizes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh devices of shape {self.devices.shape} need "
                f"{self.devices.ndim} axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where the shards' results meet and unsharded layers run."""
        return self.devices.reshape(-1)[0]

    def device_at(self, coords: Mapping[str, int]) -> torch.device:
        """The device at ``coords`` ({axis: index}); an axis not named
        takes index 0 (a shard replicated over it is computed once)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh has no axis {sorted(unknown)}; its axes "
                             f"are {self.axis_names}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def shard_devices(self, axes: Sequence[str]) -> list[torch.device]:
        """One device per block of a dimension split over ``axes`` (the
        first axis major, as a ``PartitionSpec`` entry splits it)."""
        sizes = [self.shape[a] for a in axes]
        return [self.device_at(dict(zip(axes, idx)))
                for idx in np.ndindex(*sizes)] if axes else \
            [self.first_device]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({self.shape}, devices={devs})"


def serve_rules_for(param_count: int, *, tp: int = 16,
                    bytes_per_param: int = 2) -> AxisRules:
    if param_count * bytes_per_param / tp <= SERVE_REPLICATION_BUDGET_BYTES:
        return dict(SERVE_RULES)
    return dict(DEFAULT_RULES)


_state = threading.local()


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@contextlib.contextmanager
def use_rules(rules: AxisRules | None = None, mesh: Mesh | None = None):
    """Activate logical->mesh rules (and the mesh for divisibility checks)
    in this thread."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (dict(DEFAULT_RULES if rules is None else rules), mesh)
    try:
        yield
    finally:
        _state.ctx = prev


def current_rules() -> tuple[AxisRules, Mesh | None] | None:
    return getattr(_state, "ctx", None)


def _resolve_axis(logical: str | None, dim_size: int,
                  rules: AxisRules, sizes: dict[str, int],
                  used: set[str]) -> str | tuple[str, ...] | None:
    """Map one logical name to mesh axes, dropping non-dividing or
    already-used mesh axes (a mesh axis may appear once per spec)."""
    if logical is None:
        return None
    target = rules.get(logical)
    if target is None:
        return None
    axes = (target,) if isinstance(target, str) else tuple(target)
    picked: list[str] = []
    remaining = dim_size
    for ax in axes:
        n = sizes.get(ax)
        if n is None or ax in used:
            continue
        if remaining % n != 0:
            continue
        picked.append(ax)
        used.add(ax)
        remaining //= n
    if not picked:
        return None
    return picked[0] if len(picked) == 1 else tuple(picked)


def logical_spec(shape: Sequence[int], axes: Sequence[str | None],
                 *, rules: AxisRules | None = None,
                 mesh: Mesh | None = None) -> tuple:
    """The partition of ``shape`` from logical axis names: a tuple of one
    entry a dimension (a mesh axis, a tuple of them, or None), as JAX's
    ``PartitionSpec``."""
    ctx = current_rules()
    if rules is None:
        rules = ctx[0] if ctx else dict(DEFAULT_RULES)
    if mesh is None:
        mesh = ctx[1] if ctx else None
    sizes = _mesh_axis_sizes(mesh)
    used: set[str] = set()
    assert len(shape) == len(axes), (shape, axes)
    return tuple(_resolve_axis(a, d, rules, sizes, used)
                 for d, a in zip(shape, axes))


def logical_constraint(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """The identity.  JAX's version is a ``with_sharding_constraint`` for
    GSPMD; the port has no GSPMD, so a tensor stays where it is and only
    the sharded paths named in the module docstring split work."""
    return x


def batch_mesh_axes(*, logical: str = "batch"
                    ) -> tuple[Mesh, tuple[str, ...], int] | None:
    """Mesh axes the 'batch' logical axis maps to under the active rules:
    ``(mesh, axis_names, total_size)``, or None when no mesh is active, the
    rules map ``logical`` to nothing, or every mapped axis has size 1.
    No divisibility fallback: the caller decides whether a non-dividing
    batch runs unsharded or raises."""
    ctx = current_rules()
    if ctx is None or ctx[1] is None:
        return None
    rules, mesh = ctx
    target = rules.get(logical)
    if target is None:
        return None
    sizes = _mesh_axis_sizes(mesh)
    axes = tuple(ax for ax in ((target,) if isinstance(target, str)
                               else tuple(target))
                 if sizes.get(ax, 1) > 1)
    total = math.prod(sizes[ax] for ax in axes)
    if total <= 1:
        return None
    return mesh, axes, total
