"""int32 pixel packing for the device-resident dataset — the port of
distributedmnist_tpu/data/packing.py.

`pack_rows` is the JAX package's numpy function, byte for byte: 4 uint8
pixels per int32 word, little-endian within the word. `unpack_rows`
undoes it on a torch int32 tensor with `(w >> 8*i) & 0xFF` (the mask
makes the arithmetic shift of a negative word safe; torch's uint32 is
only partly supported on CUDA) and then divides by 255 in the compute
dtype (float32, or bfloat16 straight from the bytes, as the JAX decode
does: `x.astype(dtype) / 255` in that dtype), so its pixels are
bit-identical to the JAX decode's.
"""

from __future__ import annotations

import numpy as np
import torch

PIXELS = 28 * 28          # 784 uint8 pixels per image
WORDS = PIXELS // 4       # 196 int32 words per image


def pack_rows(x: np.ndarray) -> np.ndarray:
    """(N, 28, 28, 1) uint8 -> (N, 196) int32, 4 pixels per word
    (little-endian byte order within each word)."""
    if x.dtype != np.uint8:
        raise ValueError(f"expected uint8 pixels, got {x.dtype}")
    n = x.shape[0]
    flat = np.ascontiguousarray(x).reshape(n, PIXELS)
    return flat.view("<u4").astype(np.int32).reshape(n, WORDS)


def normalize(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Pixel values 0..255 -> `dtype` in [0, 1], by a true division.

    The divisor is a 0-d tensor on x's device: on CUDA, PyTorch turns a
    division by a Python scalar into a multiply by its reciprocal, which
    rounds some pixels differently from the JAX decode's division."""
    return x.to(dtype) / torch.full((), 255.0, dtype=dtype, device=x.device)


def unpack_rows(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., 196) int32 -> (..., 28, 28, 1) `dtype` in [0, 1]. Inverse of
    pack_rows, bit-exact per pixel."""
    shifts = torch.arange(4, dtype=torch.int32, device=words.device) * 8
    b = (words.unsqueeze(-1) >> shifts) & 0xFF             # (..., 196, 4)
    return normalize(b.reshape(*words.shape[:-1], 28, 28, 1), dtype)
