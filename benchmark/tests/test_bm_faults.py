"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a real run on the CPU at a tiny size (the
look for a card is skipped): the cell's driver, its checked steps and
the comparison with the cell's own limits. A sound run comes out
correct; each fault the cell can have comes out not correct, and a run
whose rank loaded jax prints no result."""

import json

import pytest

from benchmark import run
from benchmark.tests import faults

TRAIN = {"global_batch": 64, "train_n": 1024, "test_n": 256,
         "steps_per_call": 4, "check_blocks": 2, "warm_blocks": 2,
         "trace_blocks": 1}


def _train(cell, seed, **over):
    return run.run_cell(cell, seed, 0.5, False, device="cpu",
                        overrides={"traffic": TRAIN, **over})


def test_sound_training_run_is_correct():
    r = _train("lenet5.train.gb4096", 2**32 + 11)
    assert r["correct"], r["checks"]
    assert r["metrics"]["train_images_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_caught(fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    r = _train("lenet5.train.gb4096", 2**32 + 12)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_exchange_left_out_is_caught(fault, monkeypatch):
    if fault:
        monkeypatch.setenv("BM_FAULT", fault)      # the ranks plant it
    r = _train("lenet5-dp4.train.gb16384", 2**32 + 13, chips=2,
               traffic={**TRAIN, "global_batch": 128})
    assert r["correct"] == (fault is None), r["checks"]
    assert set(r["metrics"]) == {"train_images_per_s.dp4", "setup_s"}


def test_jax_in_a_rank_gives_no_result(monkeypatch, capsys):
    monkeypatch.setenv("BM_FAULT", "jax_loaded")   # the ranks plant it
    r = _train("lenet5-dp4.train.gb16384", 2**32 + 14, chips=2,
               traffic={**TRAIN, "global_batch": 128})
    assert r["_loaded"] == ["jax"]
    capsys.readouterr()
    assert run.finish(r) == run.FORBIDDEN_LOADED
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_a_clean_run_prints_its_line(capsys):
    r = _train("lenet5.train.gb4096", 2**32 + 15)
    assert r["_loaded"] == []
    capsys.readouterr()
    assert run.finish(r) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True


def test_faults_planted_for_a_block_alone():
    from distributedmnist_tpu_torch import trainer

    before = trainer.cross_entropy
    with faults.planted("half_batch"):
        assert trainer.cross_entropy is not before
    assert trainer.cross_entropy is before


def test_unknown_fault():
    with pytest.raises(ValueError):
        faults.plant("no-such-fault", lambda *a: None)


def test_stale_block_repeats_the_first_batch_of_a_block():
    from distributedmnist_tpu_torch.data.loader import IndexStream

    with faults.planted("stale_block"):
        block = IndexStream(1000, 8, 3).next_block(4, "cpu")
    assert (block == block[:1]).all()
    fresh = IndexStream(1000, 8, 3).next_block(4, "cpu")
    assert not (fresh == fresh[:1]).all()


@pytest.mark.parametrize("cell,chips", [("lenet5.train.gb4096", 1),
                                        ("lenet5-dp4.train.gb16384", 2)])
def test_traced_run_reports_its_cells_per_layer_metrics(cell, chips):
    from benchmark.harness import manifest

    r = run.run_cell(cell, 2**32 + 16, 0.5, True, device="cpu",
                     overrides={"traffic": {**TRAIN, "global_batch": 128},
                                "chips": chips})
    mine = {x["name"] for x in manifest.per_layer(manifest.load(), cell)}
    idle = "device_idle_pct.train" if chips == 1 else "device_idle_pct.dp4"
    assert r["correct"] and idle in r["metrics"]
    assert set(r["metrics"]) <= mine
