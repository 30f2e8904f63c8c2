"""The port's synthetic-set calibration
(distributedmnist_tpu_torch/calibrate_synthetic.py) against the JAX
package's scripts/calibrate_synthetic.py, on the CPU.

One calibration point (the set's own constants, noise 0.44 and jitter 3)
at train_n 2048, test_n 512 and 1 epoch: each model's test accuracy
through the port's trainer.fit with the script's Config, from JAX's
init carried across through interop.py, equals JAX's trainer.fit with
the JAX script's Config within 2 / test_n (two test images: the
trajectories sum in other orders, and JAX's fit spreads the batch over
conftest's 8 virtual devices). The port's CLI prints the JAX script's
table, laid out as the JAX script lays it out.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.config import Config as JConfig
from distributedmnist_tpu_torch import calibrate_synthetic as cal
from distributedmnist_tpu_torch import interop, trainer
from distributedmnist_tpu_torch.data import synthetic_mnist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_N, TEST_N = 2048, 512


def _jax_script_config(model: str, epochs: int) -> JConfig:
    """scripts/calibrate_synthetic.py's Config."""
    return JConfig(device="cpu", model=model, optimizer="adam",
                   learning_rate=2e-3, lr_schedule="cosine", synthetic=True,
                   batch_size=512, epochs=epochs, eval_every=10 ** 9,
                   log_every=0, target_accuracy=None)


def _jax_init(cfg: JConfig) -> dict:
    """The parameters JAX's fit starts from for `cfg`, in the port's
    format."""
    jm = jmodels.build(cfg.model, fused=cfg.fused_kernels, platform="cpu",
                       conv=cfg.conv_impl)
    tx = joptim.build(cfg.optimizer, cfg.learning_rate, cfg.momentum)
    state = jtrainer.init_state(jax.random.PRNGKey(cfg.seed), jm, tx,
                                jnp.zeros((1, 28, 28, 1), jnp.float32))
    params = jax.tree.map(np.asarray, state.params)
    return (interop.mlp_params_from_flax(params) if cfg.model == "mlp"
            else interop.lenet_params_from_flax(params))


def test_calibration_config_is_the_jax_scripts():
    for model in ("mlp", "lenet"):
        ours = cal.calibration_config(model, 6, "cpu")
        want = _jax_script_config(model, 6)
        for field in ("model", "optimizer", "learning_rate", "lr_schedule",
                      "synthetic", "batch_size", "epochs", "eval_every",
                      "log_every", "target_accuracy", "seed", "momentum",
                      "warmup_steps", "pixel_format"):
            assert getattr(ours, field) == getattr(want, field), field


@pytest.mark.parametrize("model", ("mlp", "lenet"))
def test_one_calibration_point_equals_jax_fit(model):
    data = synthetic_mnist(seed=0, train_n=TRAIN_N, test_n=TEST_N,
                           noise=0.44, jitter=3)
    want = jtrainer.fit(_jax_script_config(model, 1), data=data)
    jcfg = _jax_script_config(model, 1)
    got = trainer.fit(cal.calibration_config(model, 1, "cpu"), data=data,
                      init_params=_jax_init(jcfg))
    assert got["steps"] == want["steps"] == TRAIN_N // 512
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 2 / TEST_N


def test_cli_prints_the_jax_scripts_table(capsys, monkeypatch):
    args = ["--grid", "0.44:3,0.55:4", "--train-n", "1024", "--test-n",
            "256", "--epochs", "1"]
    assert cal.main(args + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["calibrate_synthetic.py"] + args)
    runpy.run_path(os.path.join(REPO, "scripts", "calibrate_synthetic.py"),
                   run_name="__main__")
    theirs = capsys.readouterr().out.splitlines()
    assert len([ln for ln in ours if ln.startswith("calibration ")]) == 2
    table = [ln for ln in ours if not ln.startswith("calibration ")]
    assert len(table) == len(theirs) == 3
    assert table[0] == theirs[0]
    for a, b in zip(table[1:], theirs[1:]):
        assert a[:14] == b[:14] and len(a) == len(b)
        assert all(0.0 <= float(v) <= 1.0 for v in a.split()[2:])


def test_calibrate_runs_on_the_card_unless_asked_for_the_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        cal.main(["--grid", "0.44:3"])
