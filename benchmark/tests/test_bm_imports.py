"""Nothing the benchmark runs imports jax, jaxlib, flax, optax or the
JAX package, compared by whole top-level names; the reference imports
nothing of the port either."""

import os
import subprocess
import sys

import pytest

from benchmark.harness.env import FORBIDDEN, ROOT, forbidden_loaded

BENCH = os.path.join(ROOT, "benchmark")


def _modules():
    out = []
    for sub in ("harness", "traffic", "reference"):
        for f in sorted(os.listdir(os.path.join(BENCH, sub))):
            if f.endswith(".py") and f != "__init__.py":
                out.append(f"benchmark.{sub}.{f[:-3]}")
    return out + ["benchmark.tests.faults"]


def _loaded(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


PRINT = ("import sys; print(' '.join(sorted({m.split('.', 1)[0] "
         "for m in sys.modules})))")


@pytest.mark.parametrize("module", _modules())
def test_module_loads_no_jax(module):
    names = _loaded(f"import {module}; {PRINT}")
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_run_and_its_drivers_load_no_jax():
    code = ("import runpy, sys; sys.argv = ['run.py']; "
            "g = runpy.run_path('benchmark/run.py', run_name='bm'); "
            "import benchmark.traffic.train_fit; "
            "import distributedmnist_tpu_torch.trainer, "
            "distributedmnist_tpu_torch.parallel.launch; " + PRINT)
    names = _loaded(code)
    assert "distributedmnist_tpu_torch" in names
    assert not names & set(FORBIDDEN)


@pytest.mark.parametrize("module", ["benchmark.reference.lenet5",
                                    "benchmark.reference.stream"])
def test_reference_loads_nothing_of_the_port(module):
    names = _loaded(f"import {module}; {PRINT}")
    assert "distributedmnist_tpu_torch" not in names
    assert not names & set(FORBIDDEN)


def test_forbidden_compares_whole_top_level_names():
    assert forbidden_loaded(["distributedmnist_tpu_torch.trainer",
                             "jaxtyping", "flaxen.x"]) == []
    assert forbidden_loaded(["distributedmnist_tpu.trainer",
                             "jax.numpy", "optax"]) == [
        "distributedmnist_tpu", "jax", "optax"]
