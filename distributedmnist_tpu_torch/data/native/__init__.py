"""ctypes binding for the native IDX reader (idx_reader.cpp) — the port's
copy of distributedmnist_tpu/data/native.

The shared library is built explicitly by `ensure_built()` (g++ into the
git-ignored csrc/build/, a temporary file renamed into place, so
concurrent builders in different processes race harmlessly); the data
path only USES the library when it is already there (`available()` never
compiles), so a cold start never waits on g++. `read_idx` returns None
when the library is unavailable, and data/mnist.py then parses the file
in Python: that is the reference's own design for a host-side reader
(both give the same arrays), not a fallback from the card. `READS`
counts the files read natively, so a run can show the reader was used.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger("distributedmnist_tpu_torch")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "idx_reader.cpp")
_LIB = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "csrc", "build",
                    "libidx_reader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
# files read through the native library in this process
READS = [0]


def ensure_built(force: bool = False) -> bool:
    """Compile the library if it is missing or older than its source.
    Returns availability."""
    if not os.path.exists(_SRC):
        return available()  # a library without its source: use as is
    stale = (not os.path.exists(_LIB)
             or os.path.getmtime(_LIB) < os.path.getmtime(_SRC))
    if stale or force:
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
        except (OSError, subprocess.SubprocessError) as e:
            log.info("native idx_reader build failed (%s); the Python "
                     "parser stays in use", e)
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return available()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB):
            return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.idx_probe.restype = ctypes.c_int
            lib.idx_probe.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_uint64)]
            lib.idx_read.restype = ctypes.c_longlong
            lib.idx_read.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_ubyte),
                                     ctypes.c_longlong]
        except (OSError, AttributeError) as e:
            # a corrupt or incompatible library (an interrupted build of
            # an old version): use the Python parser rather than crash
            log.warning("native idx_reader load failed (%s); using the "
                        "Python parser", e)
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True iff the already-built library loads. Never compiles."""
    return _load() is not None


def read_idx(path: str) -> Optional[np.ndarray]:
    """Read a raw (not gzipped) IDX file natively; None when the library
    is unavailable (the caller parses the file in Python)."""
    lib = _load()
    if lib is None:
        return None
    ndim = ctypes.c_int()
    dims = (ctypes.c_uint64 * 4)()
    rc = lib.idx_probe(path.encode(), ctypes.byref(ndim), dims)
    if rc != 0:
        raise ValueError(f"native idx_probe({path!r}) failed: rc={rc}")
    shape = tuple(int(dims[i]) for i in range(ndim.value))
    out = np.empty(shape, dtype=np.uint8)
    n = lib.idx_read(path.encode(),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                     out.size)
    if n != out.size:
        raise ValueError(f"native idx_read({path!r}) failed: rc={n}")
    READS[0] += 1
    return out
