"""Training in the port repeats itself at a seed, as the JAX reference
does, on the CPU.

- The training scope (utils/device.training_numerics) turns TF32 off and
  pins cuDNN to its deterministic algorithms with its autotuner off
  inside the block, and restores every setting after it, on an
  exception too.
- Every training path enters it: trainer.fit, the bench's throughput
  runner, train_profile and torchcheck's training recording. Each test
  reads the settings from inside the path's own training step.
- Two fits of config 2 (LeNet-5 with Adam) at one seed give the same
  losses, test accuracy and parameters bit for bit.

The settings are Python-level flags, so the CPU reads them as the card
does; what they choose on the card is held by tests/test_torch_gpu.py.
"""

import contextlib
import json

import pytest
import torch

from distributedmnist_tpu_torch import trainer
from distributedmnist_tpu_torch.data import synthetic_mnist
from distributedmnist_tpu_torch.utils.device import training_numerics
from torch_repro_util import differences, fit_record

TRAINING = (False, False, True, False)


def _settings() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def _set(values) -> None:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = values


@pytest.fixture
def restore_settings():
    before = _settings()
    yield
    _set(before)


@pytest.mark.parametrize("raises", (False, True), ids=("exit", "raise"))
@pytest.mark.parametrize("start", ((True, True, False, True),
                                   (False, True, False, False),
                                   TRAINING), ids=("flipped", "mixed",
                                                   "already"))
def test_training_numerics_pins_and_restores(restore_settings, start,
                                             raises):
    _set(start)
    inside = []
    with (pytest.raises(ValueError) if raises
          else contextlib.nullcontext()):
        with training_numerics():
            inside.append(_settings())
            if raises:
                raise ValueError("inside the block")
    assert inside == [TRAINING]
    assert _settings() == start


def test_nested_scopes_restore_the_outer_settings(restore_settings):
    _set((True, True, False, True))
    with training_numerics():
        with training_numerics():
            assert _settings() == TRAINING
        assert _settings() == TRAINING
    assert _settings() == (True, True, False, True)


@pytest.fixture
def step_settings(monkeypatch, restore_settings):
    """The settings each call of a training step made through
    trainer.make_train_step saw, the process's settings flipped from the
    scope's first so that only the scope can set them."""
    seen = []
    make = trainer.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(*a, **k):
            seen.append(_settings())
            return step(*a, **k)
        return wrapped

    monkeypatch.setattr(trainer, "make_train_step", recording)
    _set((True, True, False, True))
    return seen


def _tiny_config(**kw):
    from distributedmnist_tpu_torch.config import PRESETS

    return PRESETS["lenet-adam"].replace(
        synthetic=True, device="cpu", steps=3, eval_every=3,
        target_accuracy=None, **kw)


def test_fit_steps_inside_the_training_scope(step_settings):
    trainer.fit(_tiny_config(), data=synthetic_mnist(seed=0, train_n=512,
                                                     test_n=64))
    assert step_settings and set(step_settings) == {TRAINING}
    assert _settings() == (True, True, False, True)


def test_bench_throughput_steps_inside_the_training_scope(step_settings,
                                                          capsys):
    from distributedmnist_tpu_torch import bench

    assert bench.main(["throughput", "--device", "cpu", "--model", "lenet",
                       "--global-batch", "16", "--bench-steps", "2",
                       "--warmup-steps", "1", "--repeats", "1",
                       "--inline"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "train_images_per_sec_per_chip"
    assert step_settings and set(step_settings) == {TRAINING}
    assert _settings() == (True, True, False, True)


def test_torchcheck_records_the_train_step_inside_the_training_scope(
        step_settings):
    from distributedmnist_tpu_torch.analysis import torchcheck as tc

    for model in tc.TRAIN_PRESETS:
        tc.record_train_step(model, "cpu")
    assert len(step_settings) == len(tc.TRAIN_PRESETS)
    assert set(step_settings) == {TRAINING}
    assert _settings() == (True, True, False, True)


def test_train_profile_profiles_inside_the_training_scope(
        monkeypatch, restore_settings, tmp_path):
    """train_profile needs a card; its recipes run under the scope, read
    here from a stand-in for the recipe's profile."""
    from distributedmnist_tpu_torch import train_profile

    seen = []

    def profile_recipe(name, data, steps, trace_dir):
        seen.append((name, _settings()))
        return {"recipe": name}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(train_profile, "card_line", lambda: "card, 700 W")
    monkeypatch.setattr(train_profile, "synthetic_mnist",
                        lambda seed: {"seed": seed})
    monkeypatch.setattr(train_profile, "profile_recipe", profile_recipe)
    _set((True, True, False, True))
    assert train_profile.main(["--trace-dir", str(tmp_path)]) == 0
    assert seen == [("mlp-sgd", TRAINING), ("lenet-adam", TRAINING)]
    assert _settings() == (True, True, False, True)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_two_cpu_fits_of_config2_are_bit_identical(dtype):
    """A few dozen Adam steps of LeNet-5, twice at one seed: every
    logged loss, the test accuracy and every parameter equal bit for
    bit."""
    data = synthetic_mnist(seed=709, train_n=1024, test_n=256)
    runs = [fit_record("lenet-adam", steps=24, seed=709, device="cpu",
                       dtype=dtype, data=data) for _ in range(2)]
    assert len(runs[0]["losses"]) >= 1
    assert differences(runs[0], runs[1]) == []
    first = runs[0]["params"]
    assert all(v.device.type == "cpu" for v in first.values())


def test_differences_names_what_moved():
    data = synthetic_mnist(seed=709, train_n=512, test_n=128)
    a = fit_record("lenet-adam", steps=4, seed=709, device="cpu", data=data)
    b = dict(a, params=dict(a["params"]), test_accuracy=-1.0)
    name = sorted(b["params"])[0]
    b["params"][name] = b["params"][name].clone()
    b["params"][name].view(-1)[0] += 1.0
    assert differences(a, b) == ["test_accuracy", f"params: {name}"]


def test_a_child_under_deterministic_algorithms_equals_this_process(
        tmp_path):
    """Config 2 in a child process that calls
    torch.use_deterministic_algorithms(True) (no op refused on the CPU)
    and here: the same record bit for bit."""
    from torch_repro_util import run_child

    out = str(tmp_path / "child.pt")
    rc, err = run_child(out, "--device", "cpu", "--steps", "8",
                        deterministic_algorithms=True)
    assert rc == 0, err[-3000:]
    here = fit_record("lenet-adam", steps=8, seed=709, device="cpu")
    assert differences(here, torch.load(out)) == []
