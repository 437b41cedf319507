"""The import check: nothing the benchmark runs may load JAX or the JAX
package.  Modules are compared by their whole top-level name (the part
before the first dot), so ``repro_torch`` is not ``repro``."""
from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> list[str]:
    """The loaded module names (keys of ``sys.modules`` or any iterable
    of names) whose top-level name is forbidden."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)
