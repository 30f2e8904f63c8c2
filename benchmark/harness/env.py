"""Process set-up that has to happen before torch is imported.

Every cache a run writes lives at a fixed path inside the checkout
(`.bench_cache/`), so that only a cell's first run in a checkout pays
for it: Python's bytecode (the card's host sets PYTHONDONTWRITEBYTECODE
and ships torch without .pyc files, so an interpreter that may not
write them compiles torch afresh each start), the extension build
directory and Triton's cache. Child processes inherit the same
settings through the environment.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, ".bench_cache")
# top-level module names that no process of a run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distributedmnist_tpu")


def prepare() -> None:
    """Point every cache into the checkout and put the checkout on the
    import path. Call before importing torch."""
    pycache = os.path.join(CACHE, "pycache")
    os.makedirs(pycache, exist_ok=True)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = pycache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ.update({
        "PYTHONPYCACHEPREFIX": pycache,
        "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
    })
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names present in `modules` (default
    sys.modules), each module compared by the part of its name before
    the first dot, whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))
