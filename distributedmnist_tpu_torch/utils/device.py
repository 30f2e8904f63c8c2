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
    a run of training uses training_numerics()."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def training_numerics():
    """Run the block as training runs on the card: float32 with TF32 off
    for matmuls and cuDNN convolutions (cuDNN's default is TF32, about
    three decimal digits), and cuDNN restricted to its deterministic
    algorithms with its autotuner off, so that a run at a seed repeats
    itself bit for bit, as the JAX reference does (cuDNN's fastest
    weight-gradient algorithms sum with atomics, in an order that
    changes from run to run). Every setting is restored after the block,
    on an exception too. (This scope was float32_numerics until it also
    pinned cuDNN's algorithms.)

    The settings are process-wide: a backward pass run inside the block
    sees them, and so does any other thread of the process while the
    block runs (a server's forward convolutions then choose among
    cuDNN's deterministic algorithms only)."""
    settings = ((torch.backends.cuda.matmul, "allow_tf32", False),
                (torch.backends.cudnn, "allow_tf32", False),
                (torch.backends.cudnn, "deterministic", True),
                (torch.backends.cudnn, "benchmark", False))
    saved = [getattr(mod, name) for mod, name, _ in settings]
    for mod, name, value in settings:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name, _), value in zip(settings, saved):
            setattr(mod, name, value)
