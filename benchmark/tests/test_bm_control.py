"""The control: the reference computed in TF32, the precision below the
configuration's float32 with TF32 off, put in the program's place. On
the card it has to come out not correct by each cell's limits; at the
cells' own sizes calibrate.py --control judges it (PERF.md gives the
readings), and this test holds it at a size a test run can hold: the
checked steps' shape (a first step, then two blocks) at 2,048 rows.
Without a card it skips."""

import pytest
import torch

from benchmark.harness import compare, manifest, seeded
from benchmark.reference import lenet5, stream
from benchmark.traffic import train_fit

TRAFFIC = {"train_n": 8192, "global_batch": 2048, "steps_per_call": 8,
           "check_blocks": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["lenet5.train.gb4096",
                                  "lenet5-dp4.train.gb16384"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_tf32_control_fails_the_training_limits(card, cell, seed):
    limits = manifest.limits(cell)["limits"]
    data = seeded.mnist_tensors(seed, card, train_n=TRAFFIC["train_n"],
                                test_n=16)
    init = seeded.lenet_params(seed, card)

    def batches():
        for step in range(train_fit.checked_steps(TRAFFIC)):
            idx = torch.from_numpy(stream.batch_indices(
                TRAFFIC["train_n"], TRAFFIC["global_batch"], seed,
                step)).to(card)
            yield data["train_x"][idx], data["train_y"][idx]

    def follow(tf32):
        with lenet5.numerics(tf32=tf32):
            out = lenet5.adam_run(init, batches())
        return {"losses": train_fit.block_losses(out["losses"],
                                                 TRAFFIC["steps_per_call"]),
                "grads": {k: v.cpu() for k, v in out["grads"].items()},
                "params": {k: v.cpu() for k, v in out["params"].items()}}
    ref, ctrl = follow(False), follow(True)
    readings = compare.train_readings(ctrl, ref,
                                      {k: v.cpu() for k, v in init.items()})
    ok, checks = compare.judge(readings, limits)
    assert not ok, checks
