"""Ablations of the split-K kernels, built and timed side by side on one card.

    python -m distributedmnist_tpu_torch.kernel_variants

Each variant is the source of csrc/dense_relu.cu, csrc/mlp_megakernel.cu
or csrc/quant_dense.cu with one edit (below), built by nvcc like the real
kernel into csrc/build/variants/ and called through ctypes at the MLP's
widths (k=784, n=128, n2=10; quant_dense at both int8 layers, 784->128
with relu and 128->10 without) at the serving path's buckets. Its device
time (calls in a CUDA graph, replayed) and its largest difference from
the plain PyTorch version are printed as one JSON line per variant and
case, after the card's name and power limit.

- launch_only: every CTA returns at once (the cost of the cluster launch);
- no_loads: no tile is copied to shared memory (the arithmetic runs on
  whatever is there; the time of everything but the copies);
- no_math: the K loop does no arithmetic (copies, barriers, reduction);
- stages_of_32_rows: 4 stages of 128 bytes of each x row instead of 2 of
  256 bytes;
- split_8 (dense_relu, quant_dense): clusters of at most 8 CTAs (the
  portable size), not 16;
- no_k_groups: every thread walks all K rows of a stage, so each w
  element is read from shared memory by every row of threads;
- no_repack (quant_dense): w's stage is not transposed into the [n][k]
  tile the mma reads (the cost of the byte transpose and its barrier);
- no_reduce (quant_dense): no rank copies its partials to their owners
  (the cost of the reduction through distributed shared memory).

An edit that no longer matches its source raises: the variants are
edits of this revision's sources. Without a card it exits nonzero.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from distributedmnist_tpu_torch.kernel_profile import card_line, graph_us
from distributedmnist_tpu_torch.ops import fused, kernel_lib

BUCKETS = (1, 7, 128, 512)
K, HIDDEN, CLASSES = 784, 128, 10

_LOAD_PROLOGUE = "    if (s < nt) load(s, s);"
_LOAD_LOOP = ("    if (t + STAGES - 1 < nt) load((t + STAGES - 1) % STAGES, "
              "t + STAGES - 1);")

DENSE = {
    "base": [],
    "launch_only": [(
        "  extern __shared__ __align__(16) unsigned char smem[];",
        "  if (m > 0) return;\n"
        "  extern __shared__ __align__(16) unsigned char smem[];")],
    "no_loads": [(_LOAD_PROLOGUE, ""), (_LOAD_LOOP, "")],
    "no_math": [("    mm.step(xs, xs + S::X_ELEMS, tid);", "    (void)xs;")],
    "stages_of_32_rows": [
        ("constexpr int BK = 256 / sizeof(T);",
         "constexpr int BK = 128 / sizeof(T);"),
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "split_8": [("constexpr int MAX_SPLIT = 16;",
                 "constexpr int MAX_SPLIT = 8;")],
    "no_k_groups": [(
        "  static constexpr int KG = BM >= 64 ? 1 : GROUPS / 2;",
        "  static constexpr int KG = 1;")],
}

MEGA = {
    "base": [],
    "launch_only": [(
        "  extern __shared__ __align__(16) float smem[];",
        "  if (m > 0) return;\n"
        "  extern __shared__ __align__(16) float smem[];")],
    "no_loads": [(_LOAD_PROLOGUE, ""), (_LOAD_LOOP, "")],
    "no_math": [("    for (int kk = 0; kk < G::KK; kk += 4) {",
                 "    for (int kk = 0; kk < 0; kk += 4) {")],
    "stages_of_32_rows": [
        ("constexpr int BK = 64;", "constexpr int BK = 32;"),
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "no_k_groups": [("  static constexpr int KG = BM == 8 ? 8 : 2;",
                     "  static constexpr int KG = 1;")],
}

QUANT = {
    "base": [],
    "launch_only": [(
        "  extern __shared__ __align__(16) unsigned char smem[];",
        "  if (m > 0) return;\n"
        "  extern __shared__ __align__(16) unsigned char smem[];")],
    "no_loads": [(_LOAD_PROLOGUE, ""), (_LOAD_LOOP, "")],
    "no_math": [("    mm.step(xs, wt, tid);", "    (void)xs;")],
    "no_repack": [("    repack_w<BN>(wt, xs + L::X_BYTES, tid);", "")],
    "no_reduce": [("    *reinterpret_cast<int4*>(slot) = v[u];",
                   "    if (m < 0) *reinterpret_cast<int4*>(slot) = v[u];")],
    "split_8": [("constexpr int MAX_SPLIT = 16;",
                 "constexpr int MAX_SPLIT = 8;")],
}


def build(variants: dict, source: str) -> dict:
    """{variant: loaded library}, all built at once, one nvcc each."""
    out_dir = kernel_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in kernel_lib.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    text = (kernel_lib.CSRC / source).read_text()
    procs = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{source} {name}: edit does not match "
                                   f"the source: {old!r}")
            src = src.replace(old, new)
        stem = f"{source.split('.')[0]}-{name}"
        (out_dir / f"{stem}.cu").write_text(src)
        lib = out_dir / f"{stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernel_lib.nvcc(), *kernel_lib.NVCC_FLAGS, "-o", str(lib),
             str(out_dir / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{source} {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in kernel_lib.SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _time(name, kernel, m, call, got, want) -> None:
    code = call()
    torch.cuda.synchronize()
    if code != 0:
        raise RuntimeError(f"{name} {kernel} m={m}: CUDA error {code}")
    print(json.dumps({
        "variant": name, "kernel": kernel, "m": m, "us": graph_us(call),
        "max_abs_err": float((got.float() - want.float()).abs().max())}),
        flush=True)


def run() -> None:
    dense = build(DENSE, "dense_relu.cu")
    mega = build(MEGA, "mlp_megakernel.cu")
    quant = build(QUANT, "quant_dense.cu")
    rng = np.random.default_rng(0)
    rq = np.random.default_rng(1)
    dev = torch.device("cuda")
    for m in BUCKETS:
        xs = torch.from_numpy(rng.random((m, K), np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(size=(K, HIDDEN)).astype(
            np.float32) * 0.05).to(dev)
        b = torch.from_numpy(rng.normal(size=HIDDEN).astype(
            np.float32)).to(dev)
        for dtype, fn in ((torch.float32, "dense_relu_f32"),
                          (torch.bfloat16, "dense_relu_bf16")):
            x_, w_, b_ = (t.to(dtype) for t in (xs, w, b))
            want = fused.dense_relu_reference(x_, w_, b_)
            for name, lib in dense.items():
                out = torch.empty((m, HIDDEN), dtype=dtype, device=dev)
                _time(name, fn, m, lambda lib=lib, out=out: getattr(lib, fn)(
                    x_.data_ptr(), w_.data_ptr(), b_.data_ptr(),
                    out.data_ptr(), m, HIDDEN, K, _stream()), out, want)
        x = xs * 255.0
        w2 = torch.from_numpy(rng.normal(size=(HIDDEN, CLASSES)).astype(
            np.float32) * 0.1).to(dev)
        b2 = torch.from_numpy(rng.normal(size=CLASSES).astype(
            np.float32)).to(dev)
        w1 = w / 255.0
        want = fused.mlp_megakernel_reference(x, w1, b, w2, b2)
        for name, lib in mega.items():
            out = torch.empty((m, CLASSES), device=dev)
            _time(name, "mlp_megakernel_f32", m,
                  lambda lib=lib, out=out: lib.mlp_megakernel_f32(
                      x.data_ptr(), w1.data_ptr(), b.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), out.data_ptr(), m, K,
                      HIDDEN, CLASSES, _stream()), out, want)
        for layer, (k, n, relu) in (("layer1", (K, HIDDEN, 1)),
                                    ("layer2", (HIDDEN, CLASSES, 0))):
            xq = torch.from_numpy(rq.integers(-128, 128, (m, k)).astype(
                np.int8)).to(dev)
            wq = torch.from_numpy(rq.integers(-127, 128, (k, n)).astype(
                np.int8)).to(dev)
            sc = torch.from_numpy((rq.random(n) * 1e-3).astype(
                np.float32)).to(dev)
            bq = torch.from_numpy(rq.normal(size=n).astype(
                np.float32)).to(dev)
            want = fused.quant_dense_reference(xq, wq, sc, bq,
                                               relu=bool(relu))
            for name, lib in quant.items():
                out = torch.empty((m, n), device=dev)
                _time(name, f"quant_dense_s8 {layer}", m,
                      lambda lib=lib, out=out: lib.quant_dense_s8(
                          xq.data_ptr(), wq.data_ptr(), sc.data_ptr(),
                          bq.data_ptr(), out.data_ptr(), m, n, k, relu,
                          _stream()), out, want)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
