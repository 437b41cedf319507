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

Params are laid out on the mesh by their specs (``place``, the
counterpart of ``jax.device_put`` with a ``NamedSharding``): a leaf split
over mesh axes becomes a ``Placed``, one block per distinct mesh index
along those axes, each on ``mesh.device_at`` of its index and owning its
storage; an axis the spec does not name holds one copy.  The LM layers
run per shard of the active mesh (``models.layers``: heads, ``ff`` and
vocab over 'model', FSDP gathers over 'data'), the batch splits over the
'batch' axes (``data_shards``, one shard run under ``at_coords``: the LM
of ``models.transformer`` and every layer of ``models.resnet_dcn``'s
detector), and ``gather`` brings blocks
together, differentiably, so gradients flow back to them.  The port has
no GSPMD, so ``logical_constraint`` stays the identity: what JAX's hints
ask of XLA, the layers do by hand.

Where a tensor crosses between mesh positions (``gather``'s blocks, the
shards' partial sums, the vocab combine, the expert exchange, the DCLs'
halo rows) it goes through ``move``, and ``count_crossings`` counts the
bytes by collective kind (JAX's names) and by (source, destination)
position, in the forward and, for its gradient, in the backward.  A
position is a mesh index, so a mesh that repeats one device still counts
what a mesh of distinct devices would move.  ``fetch_crossings`` is the
count of one param fetch from its spec alone, which the dry run's
analytic model (``launch.collectives``) adds up.  ``saved_bytes`` keys
what autograd saves for the backward by position the same way.

Default mapping (single pod (data=16, model=16); multi-pod adds 'pod'):

    batch   -> ('pod', 'data')     DP across pods and the data axis
    seq     -> None
    embed   -> 'data'              ZeRO/FSDP
    heads, kv, ff, vocab -> 'model'
    spatial -> 'model'             the DCLs' height shards
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch import tree as T

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
    GSPMD; the port has no GSPMD, so a tensor stays where it is, and the
    layers split their work per shard themselves (module docstring)."""
    return x


def mesh_axes(logical: str) -> tuple[Mesh | None, tuple[str, ...], int]:
    """``(mesh, axes, size)``: the active mesh, the axes of size > 1 the
    active rules map ``logical`` to, and the product of their sizes
    (``(None, (), 1)`` off-mesh)."""
    ctx = current_rules()
    if ctx is None or ctx[1] is None:
        return None, (), 1
    rules, mesh = ctx
    sizes = _mesh_axis_sizes(mesh)
    axes = tuple(a for a in _entry_axes(rules.get(logical))
                 if sizes.get(a, 1) > 1)
    return mesh, axes, math.prod(sizes[a] for a in axes)


@contextlib.contextmanager
def at_coords(coords: Mapping[str, int]):
    """Run the layers inside as the shard at mesh ``coords`` (a data
    shard's place on the 'batch' axes): ``shard_device`` adds them."""
    prev = getattr(_state, "coords", None)
    _state.coords = dict(coords)
    try:
        yield
    finally:
        _state.coords = prev


@contextlib.contextmanager
def within(coords: Mapping[str, int]):
    """Run the code inside at ``coords`` within the current data shard
    (a model shard's place): ``position`` adds them."""
    prev = getattr(_state, "coords", None)
    _state.coords = {**(prev or {}), **coords}
    try:
        yield
    finally:
        _state.coords = prev


def position(coords: Mapping[str, int] | None = None) -> tuple[int, ...]:
    """The mesh index of the current shard (``at_coords`` / ``within``)
    with ``coords`` on top; an axis not named takes index 0."""
    ctx = current_rules()
    if ctx is None or ctx[1] is None:
        return ()
    here = getattr(_state, "coords", None) or {}
    return _position(ctx[1], {**here, **(coords or {})})


def context() -> tuple:
    """This thread's rules, mesh and shard coordinates, for ``restored``:
    a checkpointed region recomputes in the backward, which the autograd
    engine may run on a thread of its own (a CUDA device's), where none
    of them is set."""
    return getattr(_state, "ctx", None), getattr(_state, "coords", None)


@contextlib.contextmanager
def restored(ctx: tuple):
    """Run with the rules, mesh and coordinates ``context()`` took."""
    prev = context()
    _state.ctx, _state.coords = ctx
    try:
        yield
    finally:
        _state.ctx, _state.coords = prev


def shard_device(coords: Mapping[str, int] | None = None) -> torch.device:
    """The device of the shard at ``coords`` within the current data
    shard (``at_coords``) on the active mesh."""
    ctx = current_rules()
    if ctx is None or ctx[1] is None:
        raise ValueError("no mesh is active (use_rules(mesh=...))")
    here = getattr(_state, "coords", None) or {}
    return ctx[1].device_at({**here, **(coords or {})})


def shard_coords(axes: Sequence[str], j: int) -> dict[str, int]:
    """Shard ``j`` of a split over ``axes`` as mesh coordinates."""
    ctx = current_rules()
    return _decode(j, axes, _mesh_axis_sizes(ctx[1]))


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


def data_shards(batch: int) -> list[tuple[dict, int, int]] | None:
    """``(coords, lo, hi)`` of each data shard of a batch of ``batch``
    rows under the active mesh (rows ``[lo, hi)`` at mesh ``coords``, the
    first 'batch' axis major), or None: off-mesh, a 'batch' split of one,
    or a batch that does not divide (it stays whole, as JAX's rules leave
    it replicated).  The models run each shard under ``at_coords``."""
    found = batch_mesh_axes()
    if found is None:
        return None
    mesh, axes, total = found
    if batch % total:
        return None
    per = batch // total
    sizes = mesh.shape
    return [(dict(zip(axes, idx)), i * per, (i + 1) * per)
            for i, idx in enumerate(np.ndindex(*(sizes[a] for a in axes)))]


def data_shard() -> dict[str, int] | None:
    """The coordinates on the 'batch' axes of the data shard the code
    runs in (a model's ``at_coords``), or None outside one: there the
    batch is the shard's rows, which no call inside splits again."""
    here = getattr(_state, "coords", None)
    found = batch_mesh_axes() if here else None
    if found is None:
        return None
    at = {a: here[a] for a in found[1] if a in here}
    return at or None


# ---------------------------------------------------------------------------
# Placement: a leaf laid out on the mesh by its spec
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _decode(j: int, axes: Sequence[str], sizes: Mapping[str, int]
            ) -> dict[str, int]:
    """Block index ``j`` of a dimension split over ``axes`` as mesh
    coordinates (the first axis major, as a ``PartitionSpec`` entry)."""
    out = {}
    for ax in reversed(axes):
        out[ax] = j % sizes[ax]
        j //= sizes[ax]
    return out


def _block_grid(shape: Sequence[int], spec: Sequence, mesh: Mesh
                ) -> tuple[int, ...]:
    if len(spec) != len(shape):
        raise ValueError(f"spec {tuple(spec)} does not fit a leaf of shape "
                         f"{tuple(shape)}")
    sizes = mesh.shape
    grid = []
    for d, ent in zip(shape, spec):
        axes = _entry_axes(ent)
        unknown = [a for a in axes if a not in sizes]
        if unknown:
            raise ValueError(f"spec {tuple(spec)} names {unknown}, not an "
                             f"axis of the mesh {mesh.shape}")
        n = math.prod(sizes[a] for a in axes)
        if d % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {axes} ({n} blocks)")
        grid.append(n)
    return tuple(grid)


class Placed(T.Node):
    """A tensor laid out on ``mesh`` by ``spec``: ``blocks`` maps a block
    index (one entry a dimension, the block's place along it) to the
    block, which lies on ``device_of(index)``.  The tree functions walk
    into it (its leaves are its blocks), so an optimizer's state, a
    gradient or a copy built with ``tree.tree_map`` is placed the same
    way; ``gather`` reads it back, differentiably."""

    def __init__(self, blocks: Mapping[tuple[int, ...], torch.Tensor],
                 shape: Sequence[int], spec: Sequence, mesh: Mesh):
        self.blocks = dict(blocks)
        self.shape = torch.Size(shape)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.grid = _block_grid(self.shape, self.spec, mesh)

    # -- the tree protocol ----------------------------------------------
    def children(self) -> dict:
        return self.blocks

    def rebuild(self, children: dict) -> "Placed":
        return Placed(children, self.shape, self.spec, self.mesh)

    # -- layout ---------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dimension ``dim`` is split over."""
        return _entry_axes(self.spec[dim])

    def coords(self, index: Sequence[int]) -> dict[str, int]:
        """The mesh coordinates of block ``index``."""
        out: dict[str, int] = {}
        for dim, j in enumerate(index):
            out.update(_decode(j, self.axes(dim), self.mesh.shape))
        return out

    def device_of(self, index: Sequence[int]) -> torch.device:
        return self.mesh.device_at(self.coords(index))

    def block_shape(self) -> tuple[int, ...]:
        return tuple(d // n for d, n in zip(self.shape, self.grid))

    def __getitem__(self, i: int) -> "Placed":
        """Row ``i`` of an unsplit leading dimension (a period of stacked
        layers, a codebook), placed the same way along the rest."""
        if not isinstance(i, int) or self.grid[0] != 1:
            raise IndexError(f"only an int index of an unsplit leading "
                             f"dimension, not {i!r} on spec {self.spec}")
        return Placed({k[1:]: b[i] for k, b in self.blocks.items()},
                      self.shape[1:], self.spec[1:], self.mesh)

    def __repr__(self) -> str:
        return (f"Placed(shape={tuple(self.shape)}, spec={self.spec}, "
                f"blocks={self.grid}, dtype={self.dtype})")


def is_placed(x: Any) -> bool:
    return isinstance(x, Placed)


def place(t: torch.Tensor, spec: Sequence, mesh: Mesh
          ) -> "torch.Tensor | Placed":
    """``t`` laid out on ``mesh`` by ``spec``: a ``Placed`` of one block
    per distinct mesh index along the axes the spec names (each a copy
    with storage of its own, on its device), or, where the spec splits
    nothing, one copy on the mesh's first device.  Blocks own their
    storage even on a mesh that repeats a device, where ``.to`` would
    return the tensor itself: an in-place update of one block never
    touches another, nor ``t``."""
    t = t.detach()
    grid = _block_grid(t.shape, spec, mesh)
    if all(n == 1 for n in grid):
        return t.to(mesh.first_device, copy=True)
    proto = Placed({}, t.shape, spec, mesh)
    bs = proto.block_shape()
    blocks = {}
    for index in np.ndindex(*grid):
        part = t
        for dim, j in enumerate(index):
            part = part.narrow(dim, j * bs[dim], bs[dim])
        blocks[index] = part.to(proto.device_of(index), copy=True) \
            .contiguous()
    return proto.rebuild(blocks)


# ---------------------------------------------------------------------------
# Crossings: the bytes a tensor moves between mesh positions
# ---------------------------------------------------------------------------

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
# The kind a crossing's gradient takes back in the backward.
_CONJUGATE = {"all-gather": "reduce-scatter",
              "reduce-scatter": "all-gather", "all-reduce": "all-reduce",
              "all-to-all": "all-to-all",
              "collective-permute": "collective-permute"}


class CrossingCounter:
    """Bytes and transfers by collective kind (``summary``: JAX's
    ``parse_collectives`` keys) and by (kind, source, destination)
    mesh position (``pairs``)."""

    def __init__(self):
        self.pairs: dict[tuple, list[int]] = {}

    def add(self, kind: str, src: tuple, dst: tuple, nbytes: int) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        c = self.pairs.setdefault((kind, src, dst), [0, 0])
        c[0] += 1
        c[1] += int(nbytes)

    def merge(self, other: "CrossingCounter", times: int = 1) -> None:
        """Add ``times`` copies of ``other``'s crossings."""
        for key, (n, b) in other.pairs.items():
            c = self.pairs.setdefault(key, [0, 0])
            c[0] += n * times
            c[1] += b * times

    def summary(self) -> dict:
        out: dict = {k: {"count": 0, "bytes": 0} for k in KINDS}
        for (kind, _, _), (n, b) in self.pairs.items():
            out[kind]["count"] += n
            out[kind]["bytes"] += b
        out["total_bytes"] = sum(out[k]["bytes"] for k in KINDS)
        out["total_count"] = sum(out[k]["count"] for k in KINDS)
        return out


# Not thread-local: a CUDA device's autograd engine runs the backward on
# a thread of its own, and its crossings belong to the same count.
_counters: list[CrossingCounter] = []


@contextlib.contextmanager
def count_crossings(counter: CrossingCounter | None = None):
    """Count every ``move`` between distinct mesh positions made inside
    (and the backward of each, wherever it runs) into ``counter``."""
    counter = counter or CrossingCounter()
    _counters.append(counter)
    try:
        yield counter
    finally:
        _counters.remove(counter)


@contextlib.contextmanager
def saved_bytes(exclude: Sequence[torch.Tensor] = ()):
    """The bytes autograd saves for the backward inside, by the mesh
    position current when each tensor is saved (``position()``: a data
    shard's, the first outside one, ``()`` off-mesh), into the dict
    yielded.  On a mesh that repeats a device, this shows what each
    device of a real mesh would hold where its peak memory cannot.  A
    tensor saved twice counts once; one in the storage of a tensor of
    ``exclude`` (the params, which a shard's fetch only aliases) counts
    nowhere."""
    held: dict[tuple, int] = {}
    seen: set = set()
    skip = {t.untyped_storage().data_ptr() for t in exclude}

    def pack(t: torch.Tensor) -> torch.Tensor:
        key = (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)
        if key not in seen and t.untyped_storage().data_ptr() not in skip:
            seen.add(key)
            pos = position()
            held[pos] = held.get(pos, 0) + t.numel() * t.element_size()
        # Detached: a saved output kept with its grad_fn would close a
        # cycle through the node that saves it, which no collector frees.
        return t.detach()

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield held


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, device, src, dst, kind, back, counter):
        ctx.src_device, ctx.meta = t.device, (src, dst, back, counter)
        if kind is not None:
            counter.add(kind, src, dst, t.numel() * t.element_size())
        out = t.to(device)
        # Never the input itself: a fetched block is no param (``gather``
        # counts a param's own fetches only).
        return out.detach() if out is t else out

    @staticmethod
    def backward(ctx, g):
        src, dst, back, counter = ctx.meta
        for kind, a, b in back:
            counter.add(kind, a, b, g.numel() * g.element_size())
        return (g.to(ctx.src_device),) + (None,) * 6


def move(t: torch.Tensor, device, src: tuple, dst: tuple,
         kind: str | None, back=None) -> torch.Tensor:
    """``t`` (at mesh position ``src``) on ``device`` (position ``dst``),
    differentiably.  Under ``count_crossings`` the forward counts
    ``kind`` (None: nothing) and the backward each ``(kind, from, to)``
    of ``back``, by default ``kind``'s conjugate from ``dst`` back to
    ``src``, in the bytes of the tensor crossing; nothing between equal
    positions."""
    if not _counters:
        return t.to(device)
    if back is None:
        back = () if kind is None else ((_CONJUGATE[kind], dst, src),)
    back = tuple(b for b in back if b[1] != b[2])
    if src == dst:
        kind = None
    if not (t.requires_grad and torch.is_grad_enabled()):
        back = ()
    return _Move.apply(t, device, src, dst, kind, back, _counters[-1])


def fetch_crossings(spec: Sequence, mesh: Mesh, index: Sequence[int],
                    dst: tuple) -> tuple[tuple | None, tuple]:
    """How block ``index`` of a leaf placed by ``spec`` reaches position
    ``dst``: ``(forward, backward)``, where forward is ``(kind, from,
    to)`` or None and backward a tuple of them.  The block is read from
    the copy nearest ``dst`` (``dst``'s index on the axes the spec does
    not name, as GSPMD holds a copy there): a copy elsewhere along the
    split axes is an all-gather, its gradient a reduce-scatter back.  The
    port holds one copy, at index 0 of the axes the spec does not name,
    so a gradient taken elsewhere along them is then summed into it: an
    all-reduce (a data shard's gradient sum)."""
    sizes = mesh.shape
    named: set[str] = set()
    held: dict[str, int] = {}
    for dim, j in enumerate(index):
        axes = _entry_axes(spec[dim])
        named.update(axes)
        held.update(_decode(j, axes, sizes))
    names = mesh.axis_names
    near = tuple(held[a] if a in named else dst[k]
                 for k, a in enumerate(names))
    home = tuple(held.get(a, 0) for a in names)
    fwd = None if near == dst else ("all-gather", near, dst)
    back = (() if fwd is None else (("reduce-scatter", dst, near),)) + (
        () if near == home else (("all-reduce", near, home),))
    return fwd, back


def _fetch(t: torch.Tensor, device, spec, mesh: Mesh, index,
           dtype) -> torch.Tensor:
    """Block ``index`` of a leaf (``t``, held as ``spec`` says) on
    ``device`` at the current position, in ``dtype``."""
    t = t.to(dtype=dtype)
    if not _counters or current_rules() is None \
            or current_rules()[1] is not mesh:
        return t.to(device)
    fwd, back = fetch_crossings(spec, mesh, index, position())
    if fwd is None:
        return move(t, device, (), (), None, back)
    return move(t, device, fwd[1], fwd[2], fwd[0], back)


def _is_param(x: torch.Tensor) -> bool:
    """A leaf of autograd that takes a gradient, or a view of one (a
    period's slice of a stacked leaf)."""
    return x.requires_grad and (x.is_leaf or (
        x._base is not None and x._base.is_leaf))


def gather(x, *, at: Mapping[str, int] | None = None,
           device: str | torch.device | None = None,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """The part of ``x`` at mesh coordinates ``at`` (a dimension split
    over axes that ``at`` names takes the block at those coordinates, one
    split over other axes is gathered whole) as one tensor on ``device``
    (default the mesh's first) in ``dtype``.  With ``at`` empty: the
    whole tensor.  Differentiable: the gradient of the result flows back
    to the blocks.  A plain tensor is moved and cast."""
    if not isinstance(x, Placed):
        if _counters and _is_param(x):
            # A param the specs split nothing of: whole at the first
            # position, a copy with every shard as under GSPMD.
            ctx = current_rules()
            if ctx is not None and ctx[1] is not None:
                spec = (None,) * x.ndim
                return _fetch(x, device if device is not None else x.device,
                              spec, ctx[1], (0,) * x.ndim, dtype)
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    at = dict(at or {})
    device = torch.device(device) if device is not None \
        else x.mesh.first_device
    fixed: dict[int, int] = {}
    sizes = x.mesh.shape
    for dim in range(x.ndim):
        axes = [a for a in x.axes(dim) if sizes[a] > 1]
        named = [a for a in axes if a in at]
        if named and len(named) != len(axes):
            raise ValueError(f"dimension {dim} is split over {axes}; "
                             f"name all of them or none, not {named}")
        if named:
            j = 0
            for a in x.axes(dim):
                j = j * sizes[a] + (at[a] if sizes[a] > 1 else 0)
            fixed[dim] = j

    def build(prefix: tuple[int, ...], dim: int) -> torch.Tensor:
        if dim == x.ndim:
            return _fetch(x.blocks[prefix], device, x.spec, x.mesh, prefix,
                          dtype)
        if dim in fixed:
            return build(prefix + (fixed[dim],), dim + 1)
        parts = [build(prefix + (j,), dim + 1) for j in range(x.grid[dim])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return build((), 0)


def place_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """``place`` over a tree and its spec tree (None: an empty subtree)."""
    return T.tree_map(lambda t, s: place(t, s, mesh), tree, specs)


def gather_tree(tree: Any, device: str | torch.device | None = None) -> Any:
    """Every leaf of ``tree`` whole on ``device`` (default: each plain
    leaf where it lies, each placed leaf on its mesh's first device)."""
    return T.tree_map(lambda x: gather(x, device=device), tree,
                      is_leaf=is_placed)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout on a mesh: JAX's ``NamedSharding(mesh, spec)``."""
    mesh: Mesh
    spec: tuple

    def place(self, t: torch.Tensor) -> "torch.Tensor | Placed":
        return place(t, self.spec, self.mesh)


def shardings_of(specs: Any, mesh: Mesh) -> Any:
    """A tree of ``Sharding`` from a tree of specs on ``mesh``."""
    return T.tree_map(lambda s: Sharding(mesh, tuple(s)), specs,
                      is_leaf=lambda s: isinstance(s, tuple))


def placement_summary(tree: Any, mesh: Mesh | None = None) -> dict:
    """Where a tree's bytes lie.  ``held``: the bytes each mesh position
    ({coordinates: bytes}, positions in the mesh's order) stores (a plain
    leaf lies whole on the first position; a block replicated over an
    axis its spec does not name is held once, at index 0 of that axis);
    ``per_device``: the bytes one device holds under GSPMD, where every
    replicated block lies on each device of its axes (equal to
    ``launch.dryrun.tree_shard_bytes`` of the same specs, and to the
    first position's ``held``); ``split``: {path: spec} of the placed
    leaves; ``whole``: the paths of the plain ones.  ``mesh`` defaults
    to the placed leaves' (a tree with none is all on one position)."""
    held: dict[tuple, int] = {}
    per_device = 0
    split: dict[str, tuple] = {}
    whole: list[str] = []
    for path, x in T.leaves_with_paths(tree, is_leaf=is_placed):
        name = "/".join(path)
        if isinstance(x, Placed):
            mesh = mesh or x.mesh
            split[name] = x.spec
            for index, b in x.blocks.items():
                pos = _position(x.mesh, x.coords(index))
                held[pos] = held.get(pos, 0) + b.numel() * b.element_size()
            b = next(iter(x.blocks.values()))
            per_device += b.numel() * b.element_size()
        else:
            whole.append(name)
            n = x.numel() * x.element_size()
            held[()] = held.get((), 0) + n
            per_device += n
    if mesh is not None and () in held:
        first = tuple(0 for _ in mesh.axis_names)
        held[first] = held.get(first, 0) + held.pop(())
    if mesh is not None:
        held = {idx: held.get(idx, 0) for idx in np.ndindex(
            *mesh.devices.shape)}
    return {"held": held, "per_device": per_device, "split": split,
            "whole": whole}


def _position(mesh: Mesh, coords: Mapping[str, int]) -> tuple[int, ...]:
    return tuple(coords.get(a, 0) for a in mesh.axis_names)
