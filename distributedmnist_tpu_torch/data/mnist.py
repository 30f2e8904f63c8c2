"""MNIST loading — the port of distributedmnist_tpu/data/mnist.py: the
IDX and npz readers and `load_mnist`, plus a copy of `synthetic_mnist`,
whose arrays must be byte-identical to the JAX package's for the same
seed (the registry's parity batch, the int8 calibration batch and the
trainer's synthetic data are built from it). A raw IDX file is read by
the native C++ reader (data/native) when its library has been built,
else, and for a gzipped file, by the Python parser: the same arrays."""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

TRAIN_N = 60_000
TEST_N = 10_000
IMG_SHAPE = (28, 28, 1)
NUM_CLASSES = 10

# Canonical IDX filenames (either raw or .gz).
_IDX_FILES = {
    "train_x": "train-images-idx3-ubyte",
    "train_y": "train-labels-idx1-ubyte",
    "test_x": "t10k-images-idx3-ubyte",
    "test_y": "t10k-labels-idx1-ubyte",
}


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (the MNIST distribution format), raw or
    gzipped: raw files through the native reader when it is built
    (data/native), the rest by this Python parser."""
    if not path.endswith(".gz"):
        from distributedmnist_tpu_torch.data import native
        arr = native.read_idx(path) if native.available() else None
        if arr is not None:
            return arr
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        if dtype_code != 0x08:  # unsigned byte — the only type MNIST uses
            raise ValueError(
                f"{path}: unsupported IDX dtype 0x{dtype_code:02x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def _find(data_dir: str, base: str) -> Optional[str]:
    for name in (base, base + ".gz"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


def _load_idx_dir(data_dir: str) -> Optional[dict]:
    paths = {k: _find(data_dir, v) for k, v in _IDX_FILES.items()}
    if not all(paths.values()):
        return None
    out = {k: _read_idx(p) for k, p in paths.items()}
    out["train_x"] = out["train_x"].reshape(-1, *IMG_SHAPE)
    out["test_x"] = out["test_x"].reshape(-1, *IMG_SHAPE)
    return out


def _load_npz(data_dir: str) -> Optional[dict]:
    """keras-style mnist.npz: arrays x_train, y_train, x_test, y_test."""
    p = os.path.join(data_dir, "mnist.npz")
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        return {
            "train_x": z["x_train"].astype(np.uint8).reshape(-1, *IMG_SHAPE),
            "train_y": z["y_train"].astype(np.int32),
            "test_x": z["x_test"].astype(np.uint8).reshape(-1, *IMG_SHAPE),
            "test_y": z["y_test"].astype(np.int32),
        }


def synthetic_mnist(seed: int = 0, train_n: int = TRAIN_N,
                    test_n: int = TEST_N, noise: float = 0.44,
                    jitter: int = 3) -> dict:
    """Seeded, learnable, digit-like 10-class dataset: each class is a
    smooth random template; a sample is its template shifted by up to
    ±`jitter` px plus Gaussian pixel noise of scale `noise`. uint8 images
    (n, 28, 28, 1) and int32 labels."""
    rng = np.random.default_rng(seed)
    # Low-frequency class templates: upsampled 7x7 noise -> 28x28.
    low = rng.normal(size=(NUM_CLASSES, 7, 7))
    templates = np.kron(low, np.ones((4, 4)))           # (10, 28, 28)
    # Smooth with a box blur to look stroke-like.
    k = np.ones((3, 3)) / 9.0
    for c in range(NUM_CLASSES):
        t = templates[c]
        padded = np.pad(t, 1, mode="edge")
        sm = sum(padded[i:i + 28, j:j + 28] * k[i, j]
                 for i in range(3) for j in range(3))
        templates[c] = sm
    templates = (templates - templates.min(axis=(1, 2), keepdims=True))
    templates /= templates.max(axis=(1, 2), keepdims=True) + 1e-9

    def make(n, rng):
        y = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
        base = templates[y]                              # (n, 28, 28)
        sx = rng.integers(-jitter, jitter + 1, size=n)
        sy = rng.integers(-jitter, jitter + 1, size=n)
        x = np.empty_like(base)
        for dx in range(-jitter, jitter + 1):
            for dy in range(-jitter, jitter + 1):
                m = (sx == dx) & (sy == dy)
                if m.any():
                    x[m] = np.roll(np.roll(base[m], dx, axis=1), dy, axis=2)
        x = x + rng.normal(scale=noise, size=x.shape)
        x = np.clip(x, 0.0, 1.0)
        return (x * 255).astype(np.uint8).reshape(n, *IMG_SHAPE), y

    train_x, train_y = make(train_n, np.random.default_rng(seed + 1))
    test_x, test_y = make(test_n, np.random.default_rng(seed + 2))
    return {"train_x": train_x, "train_y": train_y,
            "test_x": test_x, "test_y": test_y, "source": "synthetic"}


def load_mnist(data_dir: Optional[str] = None, synthetic: bool = False,
               seed: int = 0) -> dict:
    """MNIST as uint8 images (N, 28, 28, 1) and int32 labels.

    Order of preference: IDX files in data_dir, mnist.npz in data_dir,
    then synthetic_mnist(seed). The dict's "source" key says which
    ("real" or "synthetic")."""
    if not synthetic and data_dir:
        for fn in (_load_idx_dir, _load_npz):
            out = fn(data_dir)
            if out is not None:
                out["train_y"] = out["train_y"].astype(np.int32)
                out["test_y"] = out["test_y"].astype(np.int32)
                out["source"] = "real"
                return out
        raise FileNotFoundError(
            f"no MNIST IDX files or mnist.npz under {data_dir!r}")
    return synthetic_mnist(seed=seed)
