"""Build and bind the port's hand-written CUDA kernels.

Each source in `csrc/` is compiled by nvcc, on first use, into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), and loaded with ctypes. All missing libraries are built
together — one nvcc process per source, started at once — into
`csrc/build/`, which git ignores. A library's file name carries a hash of
its source, the shared headers and the flags, so an edited source is
never served by a stale build. Nothing here runs at import time: the CPU
tests import every module of the port on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entry points of each source: argument types for ctypes (pointers
# and the stream as c_void_p, sizes and flags as c_int). Every function
# returns the cudaError_t of its launch.
SIGNATURES = {
    "dense_relu.cu": {
        "dense_relu_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
        "dense_relu_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
    "quant_dense.cu": {
        "quant_dense_s8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "mlp_megakernel.cu": {
        "mlp_megakernel_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "conv_wgrad_1ch.cu": {
        "conv_wgrad_1ch_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_load_events = 0


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from csrc/ at first use")


def library_path(source: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's text
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    text = ((CSRC / source).read_bytes() + headers
            + " ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(force: bool = False) -> dict[str, str]:
    """Compile every kernel source whose library is missing (all of them
    with `force`), one nvcc per source, all running at once. Returns
    {source: the compiler's -Xptxas -v report} for the sources built by
    this call. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for source in SIGNATURES:
        target = library_path(source)
        if target.exists() and not force:
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        procs[source] = (tmp, target, subprocess.Popen(
            [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failures = {}, []
    for source, (tmp, target, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{source}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, target)   # atomic: a racing process sees whole files
        reports[source] = out
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, building the missing libraries
    first. Loads once per process."""
    global _load_events
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        if not library_path(source).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
        _load_events += 1
        return lib


def load_events() -> int:
    """How many kernel libraries this process has built or loaded. The
    serving engine's warmup reports its delta; a warm engine triggers 0."""
    return _load_events


def launch(source: str, fn: str, *args) -> None:
    """Call one C entry point; raise if its launch reported an error."""
    lib = load(source)
    code = getattr(lib, fn)(*args)
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {code} ({msg})")
