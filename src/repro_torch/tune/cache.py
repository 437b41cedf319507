"""Versioned tuned-tile cache (counterpart of ``repro.tune.cache``, same
file format: ``{"version", "note", "entries"}``).

The autotuner (``tune.autotune``) writes its winners here, one entry per
key; ``kernels.plan.resolve_tiles`` consults the installed cache after
explicit tiles and before the chooser, so the dispatcher, the Trainer and
the serving engine's plans read tuned tiles with no call-site change.

The key is the signature of ``plan.resolve_tiles`` plus the platform, as
in JAX, and so it holds the batch (the port's chooser takes it for its
wave fill; JAX's does not see it).  The platform is ``cuda_sm90`` on a
capability-9.0 card, ``cuda_sm<major><minor>`` on another card and
``cpu`` on the CPU: a CPU entry (a plain-path wall time) is never served
on the card, and a card entry never on the CPU.

Resilience contract, as in JAX: a missing file is cold and silent; a
corrupt or wrong-version file warns once (``repro_torch.tune`` logger)
and the resolution goes analytic.  ``resolve_tiles`` is not memoised, so
installing a cache needs no invalidation.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os

import torch

CACHE_VERSION = 1

# Where a tuner run writes by default (ignored by git, under ``build/``).
DEFAULT_CACHE_PATH = os.path.join("build", "TUNED_tiles.json")

_log = logging.getLogger("repro_torch.tune")

_WARNED: set = set()


class TileCacheError(RuntimeError):
    """A cache file exists but cannot be served (corrupt JSON, wrong
    schema, incompatible version)."""


def reset_cache_warnings() -> None:
    """Forget which cache paths and entries already warned (tests)."""
    _WARNED.clear()


def warn_once(key, msg: str, *args) -> None:
    """Warn once per ``key`` on the ``repro_torch.tune`` logger."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    _log.warning(msg, *args)


def platform_of(device: str | torch.device) -> str:
    """The cache's platform key of a device: ``cuda_sm90`` for a
    capability-9.0 card (``cuda_sm<major><minor>`` for another card),
    ``cpu`` for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        return f"cuda_sm{major}{minor}"
    if dev.type == "cpu":
        return "cpu"
    raise ValueError(f"no tile-cache platform for device {dev}")


def entry_key(*, n: int, h: int, w: int, c: int, m: int,
              kernel_size: int = 3, stride: int = 1, dilation: int = 1,
              offset_bound: float, objective: str, dtype: str | None,
              cores: int = 1, platform: str) -> str:
    """Canonical key of one tuned entry: ``objective`` (``"forward"`` or
    ``"training"``, the backward's tiles) and ``dtype`` (None or
    ``"fp32"``, ``"bf16"``, ``"int8"``, ``"int8_chain"``) name the
    datapath; ``cores`` stays 1 (no counterpart in the port)."""
    return (f"dcl/{n}x{h}x{w}x{c}->{m}/k{kernel_size}s{stride}d{dilation}"
            f"/B{float(offset_bound):g}/{objective}/{dtype or 'fp32'}"
            f"/cores{cores}/{platform}")


class TileCache:
    """In-memory view of one cache file: ``entries`` maps ``entry_key``
    strings to dicts holding at least ``{"tiles": [th, tw, tc, tm]}``
    (the tuner adds ``measured_us``, ``analytic_us``, ``analytic_tiles``,
    ``batch``, ``reps`` ...).  ``plan.resolve_tiles`` validates an entry
    when it looks it up."""

    def __init__(self, entries: dict | None = None, *,
                 path: str | None = None):
        self.entries: dict[str, dict] = dict(entries or {})
        self.path = path

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(self, **key_fields) -> dict | None:
        return self.entries.get(entry_key(**key_fields))

    def put(self, entry: dict, **key_fields) -> str:
        key = entry_key(**key_fields)
        self.entries[key] = dict(entry)
        return key

    def save(self, path: str | None = None) -> str:
        """Write the versioned JSON file (creating its directory)."""
        path = path or self.path or DEFAULT_CACHE_PATH
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {
            "version": CACHE_VERSION,
            "note": "measured-time autotuner winners (repro_torch.tune); "
                    "keys are per (batch, shape, objective, dtype, cores, "
                    "platform)",
            "entries": self.entries,
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        self.path = path
        return path

    @classmethod
    def load(cls, path: str) -> "TileCache":
        """Parse a cache file; raises ``TileCacheError`` on corrupt JSON,
        a schema without an ``entries`` mapping or another version."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            raise TileCacheError(
                f"tuned-tile cache {path!r} is unreadable "
                f"({type(e).__name__}: {e})") from e
        if not isinstance(payload, dict) \
                or not isinstance(payload.get("entries"), dict):
            raise TileCacheError(
                f"tuned-tile cache {path!r} has no 'entries' mapping")
        version = payload.get("version")
        if version != CACHE_VERSION:
            raise TileCacheError(
                f"tuned-tile cache {path!r} is version {version!r}; this "
                f"build reads version {CACHE_VERSION} — re-run the tuner")
        return cls(payload["entries"], path=path)


# The installed cache, process-wide (what ``plan.resolve_tiles`` reads).
_active: TileCache | None = None
_load_errors = 0


def load_tile_cache(path: str) -> TileCache | None:
    """Load with the resilience contract: None for a missing file
    (silent) or a corrupt one (one warning per path)."""
    global _load_errors
    if not os.path.exists(path):
        return None
    try:
        return TileCache.load(path)
    except TileCacheError as e:
        _load_errors += 1
        warn_once(("load", os.path.abspath(path)),
                  "%s; falling back to the analytic tile chooser "
                  "(warned once per path)", e)
        return None


def install_tile_cache(cache) -> TileCache | None:
    """Install (or clear, with None) the process-wide cache, a
    ``TileCache`` or a path (a corrupt file installs None); returns the
    previous one."""
    global _active
    if isinstance(cache, (str, os.PathLike)):
        cache = load_tile_cache(os.fspath(cache))
    prev, _active = _active, cache
    return prev


def active_tile_cache() -> TileCache | None:
    return _active


@contextlib.contextmanager
def tile_cache_scope(cache):
    """``install_tile_cache`` around a block, restoring the previous
    cache afterwards (``tile_cache_scope(None)`` shadows an installed
    one)."""
    prev = install_tile_cache(cache)
    try:
        yield
    finally:
        install_tile_cache(prev)


def cache_info() -> dict:
    """Status of the installed cache (``plan.tile_cache_info`` carries it
    into the engine's telemetry)."""
    return {
        "installed": _active is not None,
        "entries": len(_active) if _active is not None else 0,
        "path": getattr(_active, "path", None),
        "load_errors": _load_errors,
    }
