"""The ctypes binding of the port's CUDA kernels against their sources.

`kernel_lib.SIGNATURES` tells ctypes how to pass each argument of each
C entry point. A pointer declared there as an int is cut to 32 bits, and
that shows only as a fault on the card; so, on the CPU, every
`extern "C" int name(...)` of each `csrc/*.cu` file must be listed with
the same argument count and the same pointer-or-int kind of each
argument, and nothing else may be listed. Besides: the ablations of
kernel_variants.py are edits that still match the sources, and the
kernels' profiling tools refuse to run without a card.
"""

import ctypes
import re

import pytest

from distributedmnist_tpu_torch.ops import kernel_lib

SOURCES = sorted(p.name for p in kernel_lib.CSRC.glob("*.cu"))

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _declared(source: str) -> dict:
    """{name: ["pointer" | "int", ...]} of the source's C entry points."""
    text = (kernel_lib.CSRC / source).read_text()
    entries = {}
    for name, args in _ENTRY.findall(text):
        kinds = []
        for arg in args.split(","):
            arg = " ".join(arg.split())
            if "*" in arg:
                kinds.append("pointer")
            elif re.fullmatch(r"int \w+", arg):
                kinds.append("int")
            else:
                raise AssertionError(f"{source}: {name} has an argument "
                                     f"the binding cannot pass: {arg!r}")
        entries[name] = kinds
    return entries


def _bound(argtypes) -> list:
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int"}
    return [kind[t] for t in argtypes]


def test_every_source_has_a_binding():
    assert SOURCES == sorted(kernel_lib.SIGNATURES)


@pytest.mark.parametrize("source", SOURCES)
def test_signatures_match_the_source(source):
    declared = _declared(source)
    assert declared, f"{source} exports no extern \"C\" int entry point"
    bound = {name: _bound(types)
             for name, types in kernel_lib.SIGNATURES[source].items()}
    assert bound == declared


def test_kernel_profile_refuses_without_a_card(monkeypatch, capsys):
    """The profile measures the card only: with no card it prints no
    number and exits nonzero."""
    import torch

    from distributedmnist_tpu_torch import kernel_profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_profile.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a CUDA card" in out.err


def _variant_cases():
    from distributedmnist_tpu_torch import kernel_variants as kv

    for source, variants in (("dense_relu.cu", kv.DENSE),
                             ("mlp_megakernel.cu", kv.MEGA),
                           ("quant_dense.cu", kv.QUANT)):
        for name, edits in variants.items():
            yield pytest.param(source, edits, id=f"{source}-{name}")


@pytest.mark.parametrize("source,edits", list(_variant_cases()))
def test_kernel_variant_edits_match_their_source(source, edits):
    """Each ablation is one edit of the current source: every text it
    replaces occurs there exactly once."""
    text = (kernel_lib.CSRC / source).read_text()
    for old, _ in edits:
        assert text.count(old) == 1, old


def test_kernel_variants_refuse_without_a_card(monkeypatch, capsys):
    import torch

    from distributedmnist_tpu_torch import kernel_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_variants.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a CUDA card" in out.err
