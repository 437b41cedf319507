"""Measured-time tile search (``autotune``) and the versioned,
platform-keyed cache of its winners (``cache``) that
``kernels.plan.resolve_tiles`` consults before the chooser."""
from .autotune import measure_best_of, tune_deform_conv
from .cache import (CACHE_VERSION, DEFAULT_CACHE_PATH, TileCache,
                    TileCacheError, active_tile_cache, cache_info,
                    entry_key, install_tile_cache, load_tile_cache,
                    platform_of, reset_cache_warnings, tile_cache_scope,
                    warn_once)

__all__ = [
    "CACHE_VERSION", "DEFAULT_CACHE_PATH", "TileCache", "TileCacheError",
    "active_tile_cache", "cache_info", "entry_key", "install_tile_cache",
    "load_tile_cache", "measure_best_of", "platform_of",
    "reset_cache_warnings", "tile_cache_scope", "tune_deform_conv",
    "warn_once",
]
