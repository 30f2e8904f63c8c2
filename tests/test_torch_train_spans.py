"""The port's trainer spans (trainer.py's table, recorded through
serve/trace.py's hooks), on the CPU: one `fit` root holding every span
on its interval with the parent the table gives it, a block span a block
with one wait and one launch inside, the steady window's blocks, and the
benchmark's readers of them (benchmark/harness/spans.py); without a
Tracer installed, the same fit with nothing recorded."""

import pytest

from benchmark.harness import spans as bm_spans
from distributedmnist_tpu_torch import trainer
from distributedmnist_tpu_torch.config import Config
from distributedmnist_tpu_torch.data import mnist as tmnist
from distributedmnist_tpu_torch.serve import trace
from distributedmnist_tpu_torch.utils import MetricsLogger

STEPS, SPC, CKPT = 8, 2, 4
# each span's parents, by name (train.eval: the last block's closing
# eval; train.drain: before a block's checkpoint, or inside the eval)
PARENT = {"fit.setup.data": "fit", "fit.setup.model": "fit",
          "fit.setup.restore": "fit", "fit.setup.wrap": "fit",
          "train.loop": "fit", "train.steady": "train.loop",
          "train.block": "train.loop", "train.block.wait": "train.block",
          "train.block.launch": "train.block", "train.eval": "train.block",
          "train.drain": ("train.block", "train.eval"),
          "train.checkpoint": "train.block",
          "fit.close.sync": "fit", "fit.close.save": "fit",
          "fit.close.commit": "fit"}


def _cfg(tmp_path):
    return Config(device="cpu", synthetic=True, target_accuracy=None,
                  model="mlp", optimizer="sgd", learning_rate=0.05,
                  batch_size=32, steps=STEPS, eval_every=STEPS,
                  steps_per_call=SPC, log_every=SPC, checkpoint_every=CKPT,
                  checkpoint_dir=str(tmp_path / "ckpt"))


def _fit(tmp_path, data):
    mlog = MetricsLogger()
    out = trainer.fit(_cfg(tmp_path), data=data, log=mlog)
    return out, [r["loss"] for r in mlog.history if "loss" in r]


@pytest.fixture(autouse=True)
def _clean():
    trace.uninstall()
    yield
    trace.uninstall()


@pytest.fixture(scope="module")
def data():
    return tmnist.synthetic_mnist(seed=1, train_n=512, test_n=128)


@pytest.fixture(scope="module")
def traced(tmp_path_factory, data):
    """(fit's summary, its losses, the Tracer's run spans)."""
    tr = trace.install(trace.Tracer())
    try:
        out, losses = _fit(tmp_path_factory.mktemp("traced"), data)
    finally:
        trace.uninstall()
    return out, losses, tr.run_spans()


def test_one_fit_root_holds_every_span_under_its_parent(traced):
    _, _, spans = traced
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["fit"]
    root = roots[0]
    assert root["tags"] == {"rank": 0, "world": 1, "steps": STEPS}
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s is root:
            continue
        parent, want = by_id[s["parent"]], PARENT[s["name"]]
        assert parent["name"] in ((want,) if isinstance(want, str)
                                  else want), s
        for outer in (parent, root):
            assert outer["t0"] <= s["t0"], s
            assert s["t0"] + s["dur"] <= outer["t0"] + outer["dur"], s
        assert s["status"] == "ok" and s["rids"] == []
    assert {s["name"] for s in spans} == set(PARENT) | {"fit"}


def test_a_block_span_a_block_with_one_wait_and_one_launch(traced):
    _, _, spans = traced
    blocks = [s for s in spans if s["name"] == "train.block"]
    assert [(b["tags"]["step"], b["tags"]["k"]) for b in blocks] == [
        (step, SPC) for step in range(0, STEPS, SPC)]
    for b in blocks:
        kids = sorted(s["name"] for s in spans if s["parent"] == b["id"]
                      and s["name"].startswith("train.block."))
        assert kids == ["train.block.launch", "train.block.wait"]
    steady = next(s for s in spans if s["name"] == "train.steady")
    inside = [b for b in blocks
              if steady["t0"] <= b["t0"] <= steady["t0"] + steady["dur"]]
    assert len(inside) == len(blocks) - 1
    assert blocks[0] not in inside


def test_the_readers_of_one_rank(traced):
    out, _, spans = traced
    summary = bm_spans.summarize(spans)
    fit = next(s for s in spans if s["name"] == "fit")
    outside = bm_spans.fit_outside_loop_s([summary])
    assert 0 <= outside < fit["dur"]
    assert bm_spans.train_host_launch_ms([summary]) > 0
    assert summary["steps_launched"] == out["steps"] == STEPS
    assert summary["counts"]["train.block"][0] == STEPS // SPC
    assert summary["counts"]["train.checkpoint"][0] == STEPS // CKPT


def test_without_a_tracer_the_same_fit_records_nothing(traced, tmp_path,
                                                       data, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was recorded with no tracer")
    for name in ("begin_span", "end_span", "add_span"):
        monkeypatch.setattr(trace.Tracer, name, refuse)
    out, losses = _fit(tmp_path, data)
    ref_out, ref_losses, _ = traced
    assert trace.active() is None
    assert set(out) == set(ref_out)
    assert losses == ref_losses and len(losses) == STEPS // SPC
