"""The port's compile-surface auditor
(distributedmnist_tpu_torch/analysis/torchcheck.py) against the JAX
package's jaxcheck, on the CPU.

The key universes are held to jaxcheck's: reachable_buckets,
warmed_buckets (each package's real InferenceEngine.warmup run against
its recording probe, the fast lane's row rung included) and
dtype_universe are equal for the port's and JAX's ladders at three
max_batch values. Then each rule on a planted hazard: a warmup that
skips a rung (TX001), a dead rung (TX002), a captured host tensor and a
tensor made from host data inside the forward (TX003), a float64
forward (TX004), a changed forward against the snapshot (TX005); and
the gate itself: the CLI exits 0 at HEAD against the committed
snapshot.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributedmnist_tpu.analysis import jaxcheck as jc
from distributedmnist_tpu.serve import engine as jengine
from distributedmnist_tpu_torch.analysis import torchcheck as tc
from distributedmnist_tpu_torch.serve import engine as tengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ladders():
    """(port ladder, JAX ladder) pairs: the canonical ladders at three
    max_batch values, and ladders whose smallest rung > 1 (the fast
    lane's row rung)."""
    out = []
    for mb in (8, 100, 512):
        out.append((tengine.make_buckets(mb), jengine.make_buckets(mb, 1),
                    mb))
        out.append((tengine.make_buckets(mb, min_bucket=8),
                    jengine.make_buckets(mb, 1, min_bucket=8), mb))
    return out


@pytest.mark.parametrize("ladders", _ladders(),
                         ids=lambda l: f"mb{l[2]}-b{l[0][0]}")
def test_reachable_and_warmed_universes_equal_jaxcheck(ladders):
    ours_b, jax_b, mb = ladders
    assert tuple(ours_b) == tuple(jax_b)
    assert tc.reachable_buckets(ours_b, mb) == jc.reachable_buckets(
        jax_b, mb)
    for dt in ("float32", "bfloat16", "int8", "megakernel"):
        assert tc.warmed_buckets(ours_b, dt) == jc.warmed_buckets(
            jax_b, dt)
    if ours_b[0] > 1:
        assert f"{ours_b[0]}-row" in tc.warmed_buckets(ours_b, "float32")


@pytest.mark.parametrize("setting", ["auto", "float32", "bfloat16",
                                     "int8", "megakernel"])
def test_dtype_universe_equals_jaxcheck(setting):
    assert tc.dtype_universe(setting) == jc.dtype_universe(setting)


def test_dtype_universe_refuses_an_unknown_setting_like_jaxcheck():
    for mod in (tc, jc):
        with pytest.raises(ValueError, match="unknown serve_infer_dtype"):
            mod.dtype_universe("float16")


def test_small_audit_is_closed_with_one_fingerprint_a_key():
    r = tc.audit_target(tc.AuditTarget(model="mlp", serve_max_batch=16,
                                       buckets=(8, 16)), device="cpu")
    assert r["findings"] == []
    assert r["infer_dtypes"] == ["float32", "bfloat16", "int8",
                                 "megakernel"]
    # two rungs and the row rung a dtype
    assert r["static_keys"] == r["warmed_keys"] == 12
    assert len(r["fingerprints"]) == 12
    assert "mlp/int8/b8-row" in r["fingerprints"]
    lenet = tc.audit_target(tc.AuditTarget(model="lenet",
                                           serve_max_batch=4), device="cpu")
    assert "megakernel" not in lenet["infer_dtypes"]
    assert lenet["findings"] == []


def test_fingerprints_are_stable_and_key_sensitive():
    a = tc.audit_target(tc.AuditTarget(model="mlp", serve_max_batch=4),
                        device="cpu")
    b = tc.audit_target(tc.AuditTarget(model="mlp", serve_max_batch=4),
                        device="cpu")
    assert a["fingerprints"] == b["fingerprints"]
    fps = a["fingerprints"]
    assert fps["mlp/float32/b1"] != fps["mlp/float32/b2"]
    assert fps["mlp/float32/b4"] != fps["mlp/int8/b4"]
    # each kernel wrapper is one op named after its kernel
    eng = tc.build_engine("mlp", "int8", (4,), "cpu")
    lines = tc.record_forward(eng, 4).lines
    assert sum(ln.startswith("kernel.quant_dense(") for ln in lines) == 2
    # ... whose plain version's float64 accumulator is not recorded
    assert not any("float64" in ln for ln in lines)


def test_planted_warmup_that_skips_a_rung_is_tx001(monkeypatch):
    real = tengine.InferenceEngine.warmup

    def skipping(self, cost_samples=5):
        full = self.buckets
        self.buckets = full[:-1]
        try:
            return real(self, cost_samples)
        finally:
            self.buckets = full

    monkeypatch.setattr(tengine.InferenceEngine, "warmup", skipping)
    r = tc.audit_target(tc.AuditTarget(model="mlp", serve_max_batch=8),
                        device="cpu")
    assert {f.rule for f in r["findings"]} == {"TX001"}
    assert all(f.key.endswith("/b8") for f in r["findings"])
    assert len(r["findings"]) == len(r["infer_dtypes"])


def test_planted_dead_rung_is_tx002():
    r = tc.audit_target(tc.AuditTarget(model="mlp", serve_max_batch=8,
                                       buckets=(4, 8, 64)), device="cpu")
    assert {f.rule for f in r["findings"]} == {"TX002"}
    assert all(f.key.endswith("/b64") for f in r["findings"])


def _planted(forward):
    eng = tc.build_engine("mlp", "float32", (4,), "cpu")
    eng._forward = forward
    return tc.audit_recording(tc.record_forward(eng, 4), "mlp/planted/b4")


def test_planted_captured_host_tensor_is_tx003():
    bias = torch.ones(10)

    def forward(x_u8):
        return x_u8.reshape(4, -1)[:, :10].float() + bias

    _, findings = _planted(forward)
    assert [f.rule for f in findings] == ["TX003"]
    assert "captured" in findings[0].message


def test_planted_tensor_from_host_data_is_tx003():
    table = np.arange(10, dtype=np.float32)

    def forward(x_u8):
        return x_u8.reshape(4, -1)[:, :10].float() * torch.tensor(table)

    _, findings = _planted(forward)
    assert "TX003" in {f.rule for f in findings}
    assert any("lift_fresh" in f.message for f in findings)


def test_planted_float64_is_tx004():
    def forward(x_u8):
        return (x_u8.reshape(4, -1)[:, :10].double() / 255.0).float()

    _, findings = _planted(forward)
    assert {f.rule for f in findings} == {"TX004"}


def test_planted_forward_edit_is_tx005_against_the_snapshot(tmp_path):
    target = tc.AuditTarget(model="mlp", serve_max_batch=2)
    snap = tmp_path / "snap.json"
    report = tc.run_audit([target], "cpu", with_train=False,
                          snapshot="skip")
    tc.write_snapshot(report["fingerprints"], "test", path=str(snap))
    assert tc.run_audit([target], "cpu", with_train=False,
                        snapshot_file=str(snap))["closed"]
    real = tc.build_engine

    def edited(model, infer_dtype, buckets, device, **kw):
        eng = real(model, infer_dtype, buckets, device, **kw)
        fwd = eng._forward
        eng._forward = lambda x: torch.relu(fwd(x))
        return eng

    tc.build_engine = edited
    try:
        r = tc.run_audit([target], "cpu", with_train=False,
                         snapshot_file=str(snap))
    finally:
        tc.build_engine = real
    assert {f.rule for f in r["findings"]} == {"TX005"}
    assert all("served forward changed" in f.message
               for f in r["findings"])


def test_snapshot_key_moves_are_named():
    fs = tc.diff_fingerprints({"mlp/float32/b8": "a"},
                              {"mlp/float32/b4": "a"})
    assert sorted(f.rule for f in fs) == ["TX005", "TX005"]
    assert "in bucket: b4 -> b8" in fs[0].message


def test_compile_surface_summary_is_stable_and_geometry_sensitive():
    a = tc.compile_surface_summary("mlp", (1, 2, 4), 4, "float32")
    b = tc.compile_surface_summary("mlp", (1, 2, 4), 4, "float32")
    c = tc.compile_surface_summary("mlp", (1, 2, 4, 8), 8, "float32")
    assert a == b and a["findings"] == 0 and a["static_keys"] == 3
    assert a["infer_dtypes"] == ["float32"]
    assert c["fingerprint_set_hash"] != a["fingerprint_set_hash"]


def test_cli_exits_0_at_head_against_the_committed_snapshot():
    assert tc.load_snapshot() is not None
    r = subprocess.run([sys.executable, "-m",
                        "distributedmnist_tpu_torch.analysis.torchcheck",
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CLOSED, 0 findings" in r.stderr
    r2 = subprocess.run([sys.executable, "-m",
                         "distributedmnist_tpu_torch.analysis.torchcheck",
                         "--update-snapshots"], capture_output=True,
                        text=True, timeout=120, cwd=REPO)
    assert r2.returncode == 2 and "--reason" in r2.stderr


# -- the training step (jaxcheck's train_step_fingerprints) ---------------


def test_train_fingerprints_are_stable_under_jaxchecks_keys():
    a, fa = tc.train_step_fingerprints("cpu")
    b, fb = tc.train_step_fingerprints("cpu")
    assert fa == fb == []
    assert a == b
    assert set(a) == set(jc.load_snapshot()["fingerprints"]["train"])
    snap = tc.load_snapshot()["fingerprints"]
    assert snap[tc.TRAIN_LABEL] == a
    # the MLP's hidden layer is the dense_relu kernel, forward recorded
    # as one op; its plain-matmul backward and the update are aten ops
    lines = tc.record_train_step("mlp", "cpu").lines
    assert sum(ln.startswith("kernel.dense_relu(") for ln in lines) == 1
    assert any(ln.startswith("aten::_foreach_add_") for ln in lines)
    assert not any(ln.startswith("profiler::") for ln in lines)
    # LeNet's conv1 weight and bias gradients are one kernel op; conv2's
    # backward is autograd's convolution_backward
    lines = tc.record_train_step("lenet", "cpu").lines
    assert sum(ln.startswith("kernel.conv_wgrad_1ch(") for ln in lines) == 1
    assert sum(ln.startswith("aten::convolution_backward(")
               for ln in lines) == 1


def test_planted_extra_op_in_the_train_step_is_tx005(monkeypatch):
    from distributedmnist_tpu_torch import trainer

    real = trainer.make_train_step

    def edited(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda x, y, idx: step(x, y, idx) * 1.0

    monkeypatch.setattr(trainer, "make_train_step", edited)
    r = tc.run_audit([], "cpu", partial=True)
    assert {(f.rule, f.key) for f in r["findings"]} == {
        ("TX005", tc.train_step_key(m)) for m in tc.TRAIN_PRESETS}
    assert all("changed (fingerprint" in f.message for f in r["findings"])


def test_no_train_skips_the_train_label_without_reading_it_removed(capsys):
    assert tc.main(["--device", "cpu", "--no-train"]) == 0
    err = capsys.readouterr().err
    assert "0 train step(s)" in err and "CLOSED, 0 findings" in err
    # the full audit without the train label reads it as removed
    r = tc.run_audit(None, "cpu", with_train=False)
    assert {f.key for f in r["findings"]} == {
        tc.train_step_key(m) for m in tc.TRAIN_PRESETS}
    assert all("no longer produced" in f.message for f in r["findings"])


def test_bare_cli_without_a_card_exits_nonzero_and_names_device_cpu():
    assert not torch.cuda.is_available()
    r = subprocess.run([sys.executable, "-m",
                        "distributedmnist_tpu_torch.analysis.torchcheck"],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode == 2 and "--device cpu" in r.stderr, r.stderr
    with pytest.raises(TypeError):
        tc.run_audit(None)          # no device default
    assert tc.main(["--update-snapshots", "--reason", "x"]) == 2
