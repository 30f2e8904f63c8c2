"""Where the port runs: an explicit torch.device, never a silent fallback."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name) -> torch.device:
    """torch.device for a configured device name. "cuda" needs a card:
    without one this raises instead of falling back to the CPU, which
    runs only when the caller asks for "cpu"."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the port on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (expected cuda|cpu)")
    return dev


def pin_float32_numerics() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions for the rest of
    the process, so that float32 on the card is float32 as on the CPU.
    For a process whose threads all need float32 at once (a server);
    a single run of work uses float32_numerics()."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def float32_numerics():
    """Run the block with TF32 off for matmuls and cuDNN convolutions, so
    that float32 on the card is float32 as on the CPU (cuDNN's default
    is TF32, about three decimal digits), and restore both settings
    after. The settings are process-wide: a backward pass run inside the
    block sees them too."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = conv
