"""The port's bench (`python -m distributedmnist_tpu_torch.bench`) against
the root bench.py, on the CPU at small sizes: the time-to-accuracy recipe
field for field, the throughput runner's losses against the JAX
package's make_train_step from the same initial params, and each mode's
one JSON line with the root bench's record keys (taken from the JAX
package's committed records), in a fresh interpreter with no jax: the
throughput, time-to-accuracy, serve, sweep and smoke modes, bfloat16
throughput, and --data-dir on IDX files through the supervised worker;
the serve mode's request-path legs (--lowlat, --zipf, --zipf-cache-off,
--chaos, --chaos --serve-cache, --trace), the fleet's (--serve-replicas 2
--serve-hedge, with the chaos leg's replica kill), --dtype-sweep and
--cascade, --multimodel and --swap-during-load, each leg's keys those of
the root bench's records (and of its code, for keys newer than its last
committed record) and its bars computed alike; the serve records
(BENCH_torch_serve_rNN.json, numbered apart from the JAX package's),
--baseline's delta rows equal to the root bench's on the same pair of
records and its refusals before any load phase; plus the guards: no card
without --device cpu raises, an unported flag exits 2 naming its
ROADMAP item, a misplaced flag exits 2, and a supervised bench whose
every attempt fails exits 1 with no CPU re-run.

Tolerances: losses rtol=1e-4 (Adam's update in another rounding order,
as tests/test_torch_train.py holds lenet-adam's trajectory); schedules
atol=1e-7 (optax computes in float32, the port in float64).
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data import loader as jloader
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu_torch import bench as tbench
from distributedmnist_tpu_torch import interop
from distributedmnist_tpu_torch import optim as toptim
from distributedmnist_tpu_torch.data import mnist as tmnist
from distributedmnist_tpu_torch.data import packing as tpacking

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the serve legs of the root bench that the port has not ported yet
# (ROADMAP.md section 1 items 3 and 4: workload replay, and the static
# compile-surface audit); every other key of its record is carried
UNPORTED_SERVE_KEYS = {"compile_surface", "trace_replay"}
# the root bench's records of each request-path leg
LEG_RECORDS = {"lowlat": "BENCH_serve_r09.json",
               "zipf": "BENCH_serve_r08.json",
               "chaos": "BENCH_serve_r13.json",
               "trace": "BENCH_serve_r07.json",
               "replicas": "BENCH_serve_r07.json",
               "dtype_sweep": "BENCH_serve_r06.json",
               "cascade": "BENCH_serve_r10.json",
               "multimodel": "BENCH_serve_r11.json",
               "swap": "BENCH_serve_r02.json"}
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}


def _root_bench():
    """The root bench.py, imported as tests/test_observability.py does."""
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    return bench


def _jax_detail_keys(record: str) -> set:
    """The detail keys of one of the JAX package's committed records."""
    with open(os.path.join(REPO, record)) as f:
        return set(json.load(f)["detail"])


def _run(*argv, timeout=300, rc=0):
    """The bench in a fresh interpreter: (its one JSON record, the modules
    of jax and of the JAX package it imported, stderr). A serve run
    writes no record file unless the test names a directory for it; a
    run expected to exit `rc` != 0 returns (None, modules, stderr)."""
    if (argv and argv[0] == "serve" and "--artifact-dir" not in argv
            and "--no-artifact" not in argv):
        argv = argv + ("--no-artifact",)
    code = (
        "import json, sys\n"
        "from distributedmnist_tpu_torch.bench import main\n"
        f"rc = main({list(argv) + ['--inline']!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'distributedmnist_tpu' "
        "or m.startswith('distributedmnist_tpu.'))\n"
        "print('MODULES ' + json.dumps(bad))\n"
        "sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one intra-op thread: beside the other test workers, torch's default
    # of a thread per core oversubscribes the cores and each step crawls
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == rc, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    records = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(records) == (1 if rc == 0 else 0), proc.stdout
    modules = json.loads(lines[-1].split(" ", 1)[1])
    return (records[0] if records else None), modules, proc.stderr


# -- the recipe -----------------------------------------------------------------


def test_tta_config_matches_root_bench_field_for_field():
    import dataclasses

    root = _root_bench()
    assert tbench.TTA_DECAY_STEPS == root.TTA_DECAY_STEPS
    schedules = []
    for epochs in (5, 20, 80):
        args = argparse.Namespace(
            model="lenet", dtype="float32", data_dir=None, device="cpu",
            max_epochs=epochs, target_accuracy=0.99, steps_per_call=None)
        ours, ref = tbench.tta_config(args, 512), root.tta_config(args, 512)
        for f in dataclasses.fields(ours):
            if f.name != "device":       # the port's own field
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        assert ours.device == "cpu"
        want = joptim.make_schedule(ref.learning_rate, ref.lr_schedule,
                                    ref.warmup_steps, ref.lr_decay_steps)
        got = toptim.make_schedule(ours.learning_rate, ours.lr_schedule,
                                   ours.warmup_steps, ours.lr_decay_steps)
        for step in range(501):
            assert abs(got(step) - float(want(step))) <= 1e-7, step
        schedules.append([got(s) for s in range(501)])
    # the pinned horizon: the trial budget does not reshape the lr curve
    assert schedules[0] == schedules[1] == schedules[2]


# -- the throughput runner against the JAX package ------------------------------


@pytest.mark.parametrize("fused", ["xla", "pallas"])
def test_throughput_runner_losses_match_jax(fused):
    """The runner's first 8 steps at --model mlp, b=128 (its CPU depth, one
    step a block) against the JAX package's make_train_step (the root
    bench's _Runner step, Adam at 1e-3, packed pixels) from the same
    initial params, carried across by interop, on the same index stream.
    'pallas' runs the JAX package's dense_relu kernel in interpret mode,
    'xla' its plain reference."""
    data = tmnist.synthetic_mnist(seed=0, train_n=2048, test_n=16)
    model = jmodels.build("mlp", fused=fused, platform="cpu")
    tx = joptim.build("adam", 1e-3, flat=True)
    state = jtrainer.init_state(jax.random.PRNGKey(0), model, tx,
                                jnp.zeros((1, 28, 28, 1)))
    step_fn = jtrainer.make_train_step(model, tx, make_mesh(jax.devices()[:1]),
                                       mode="auto", pixel_format="packed")
    args = argparse.Namespace(device="cpu", model="mlp", bench_steps=8,
                              dtype="float32", data_dir=None)
    runner = tbench._Runner(args, data=data)
    run_block = runner.stepper(128, params=interop.mlp_params_from_flax(
        jax.tree.map(np.asarray, state.params)))
    jx = jnp.asarray(tpacking.pack_rows(data["train_x"]))
    jy = jnp.asarray(data["train_y"])
    stream = jloader.IndexStream(2048, 128, seed=0, mesh=None)
    jlosses, tlosses = [], []
    for _ in range(8):
        state, metrics = step_fn(state, jx, jy,
                                 jnp.asarray(stream.host_block(1)))
        jlosses.append(float(metrics["loss"]))
        tlosses.append(float(run_block(1)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]


# -- each mode's record, end to end -----------------------------------------------


def test_throughput_record():
    rec, modules, err = _run(
        "throughput", "--device", "cpu", "--model", "mlp",
        "--global-batch", "128", "--bench-steps", "8", "--warmup-steps",
        "2")
    assert modules == []
    assert set(rec) == RECORD_KEYS
    assert set(rec["detail"]) == _jax_detail_keys("THROUGHPUT_r05.json")
    assert rec["metric"] == "train_images_per_sec_per_chip"
    assert rec["vs_baseline"] is None and rec["value"] > 0
    d = rec["detail"]
    assert d["backend"] == "cpu" and d["model"] == "mlp"
    assert d["bench_steps"] == 8 and d["steps_per_call"] == 1
    assert d["global_batch"] == 128 and len(d["windows_img_s_chip"]) == 1
    assert "bench: launches" in err


def test_time_to_accuracy_record():
    rec, modules, _ = _run(
        "time-to-accuracy", "--device", "cpu", "--model", "mlp",
        "--target-accuracy", "0.5", "--global-batch", "256",
        "--max-epochs", "2", "--trials", "2")
    assert modules == []
    assert set(rec) == RECORD_KEYS
    assert set(rec["detail"]) == _jax_detail_keys("TTA_r05.json")
    assert rec["metric"] == "wall_clock_to_target_accuracy"
    assert rec["vs_baseline"] is None and rec["value"] > 0
    d = rec["detail"]
    assert d["reached_target"] and d["trials"] == 2
    seeds = [t["seed"] for t in d["trial_results"]]
    assert seeds == [0, 1]
    assert all(t["reached"] for t in d["trial_results"])
    assert len(d["steps_to_target"]) == 2
    assert d["steps_to_target_median"] <= 2 * (60_000 // 256)


def test_serve_record():
    rec, modules, _ = _run(
        "serve", "--device", "cpu", "--model", "mlp",
        "--serve-duration", "0.3", "--serve-qps", "50", "--serve-clients",
        "2", "--serve-max-batch", "16")
    assert modules == []
    assert set(rec) == RECORD_KEYS
    assert set(rec["detail"]) == (_jax_detail_keys("BENCH_serve_r13.json")
                                  - UNPORTED_SERVE_KEYS)
    assert rec["metric"] == "serve_images_per_sec_per_chip"
    assert rec["vs_baseline"] is None and rec["value"] > 0
    d = rec["detail"]
    assert d["recompiles_after_warmup"] == 0
    assert d["buckets"] == [1, 2, 4, 8, 16] and d["max_inflight"] == 4
    assert d["params"] == "fresh-init"
    assert [r["qps_target"] for r in d["qps_sweep"]] == [50.0]
    assert d["closed_loop"]["requests"] > 0
    assert d["ragged"]["former_off"]["closed"]["batches"] > 0
    assert d["ragged"]["former_on"]["closed"]["batches"] > 0
    with open(os.path.join(REPO, "BENCH_serve_r13.json")) as f:
        root = json.load(f)["detail"]
    assert set(d["ragged"]) == set(root["ragged"])
    assert set(d["inflight_comparison"]) == set(root["inflight_comparison"])
    assert set(d["qps_sweep"][0]) == set(root["qps_sweep"][0])
    assert set(d["host"]) == set(root["host"]) | {"power_limit_w"}
    assert d["host"]["device_kind"] == "cpu"
    assert d["host"]["fused_kernels"] == "plain"


def _leg_keys_are_the_root_benchs(leg: str, ours: dict) -> None:
    """The leg's keys: every key of the root bench's committed record of
    it, and keys newer than that record only where the root bench's code
    writes them."""
    with open(os.path.join(REPO, LEG_RECORDS[leg])) as f:
        ref = set(json.load(f)["detail"][leg])
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    assert ref <= set(ours), (leg, ref - set(ours))
    for k in set(ours) - ref:
        assert f'"{k}"' in src, (leg, k)


SERVE_ARGS = ("serve", "--device", "cpu", "--model", "mlp",
              "--serve-duration", "0.2", "--serve-qps", "50",
              "--serve-clients", "2", "--serve-max-batch", "16")


def test_serve_lowlat_zipf_trace_chaos_record():
    """--lowlat --zipf --trace --chaos in one run: each leg with the root
    bench's keys; the fast lane took every lone request and is attributed
    (>= 0.95, the root bench's bar, held on the CPU), the megakernel
    variant ran through the lane, the cache's bytes equal the computed
    ones, the chaos ledger is exact with one trip and one rollback, and
    nothing was built after warmup."""
    rec, modules, err = _run(*SERVE_ARGS, "--lowlat", "--zipf", "--trace",
                             "--chaos", timeout=600)
    assert modules == []
    d = rec["detail"]
    assert set(d) == (_jax_detail_keys("BENCH_serve_r13.json")
                      - UNPORTED_SERVE_KEYS)
    for leg in ("lowlat", "zipf", "chaos", "trace"):
        _leg_keys_are_the_root_benchs(leg, d[leg])
    low = d["lowlat"]
    assert low["fastpath_lane_fraction"] == 1.0
    assert low["batched"]["fastpath"]["dispatches"] == 0
    assert low["megakernel"]["fastpath"]["dispatches"] > 0
    assert low["megakernel_parity"]["passed"] is True
    assert low["attribution"]["ok"] and low["recompiles"] == 0
    assert low["variant_warmup_compile_events"] >= 1
    z = d["zipf"]
    assert z["cache_enabled"] and z["parity_ok"] and z["parity_probes"] == 8
    assert z["hit_ratio"] >= 0.5 and z["device_dispatch_lower"]
    tr = d["trace"]
    assert tr["open_spans_at_drain"] == 0 and tr["requests_traced"] > 0
    assert tr["chaos"]["bisect_split_ok"] is True
    assert tr["chaos"]["failover_rescue_ok"] is None
    ch = d["chaos"]
    assert ch["poison_isolated_exact"] and ch["other_failures"] == 0
    assert ch["breaker_trips"] == 1 and ch["rollbacks"] == 1
    assert ch["rollback_engaged"]
    assert ch["live_version_after"] == "v-chaos-fallback"
    assert ch["recompiles_during_chaos"] == 0
    assert d["recompiles_after_warmup"] == 0
    assert "cache" not in ch


def test_serve_zipf_cache_off_and_chaos_through_the_cache():
    """--zipf --zipf-cache-off runs only the control; --chaos
    --serve-cache runs the drill through the cache front, its ledger
    exact on a leader basis."""
    rec, _, _ = _run(*SERVE_ARGS, "--zipf", "--zipf-cache-off", "--chaos",
                     "--serve-cache", "--serve-cache-capacity", "64",
                     timeout=600)
    d = rec["detail"]
    z = d["zipf"]
    with open(os.path.join(REPO, LEG_RECORDS["zipf"])) as f:
        assert set(z) < set(json.load(f)["detail"]["zipf"])
    assert set(z) == {"distinct_keys", "zipf_s", "seed", "clients",
                      "max_rows_per_request", "duration_s", "cache_enabled",
                      "cache_capacity", "cache_off", "cache_on"}
    assert z["cache_enabled"] is False and z["cache_on"] is None
    assert z["cache_capacity"] is None and z["cache_off"]["requests"] > 0
    ch = d["chaos"]
    assert set(ch["cache"]) == {
        "enabled", "capacity", "stats", "cache_hits_ok",
        "poison_client_failures", "poison_follower_echoes",
        "poison_leaders", "ledger_exact"}
    assert ch["cache"]["capacity"] == 64 and ch["cache"]["ledger_exact"]
    assert ch["cache"]["stats"]["invalidations"] >= 1   # the rollback
    assert ch["breaker_trips"] == 1 and d["lowlat"] is None


def test_serve_fleet_record_with_hedge_and_replica_kill():
    """--serve-replicas 2 --serve-hedge --chaos --trace: the fleet leg, the
    `replicas` block and the chaos leg's replica kill with the root
    bench's keys (its r07 record); the kill absorbed by failover
    (non-injected availability 1.0, no replica fault reaching a client,
    rescues as parented spans), failovers and hedges as counts, the fleet
    leg's dispatches balanced within the root bench's 1.25, nothing built
    after warmup."""
    rec, modules, _ = _run(*SERVE_ARGS, "--serve-replicas", "2",
                           "--serve-hedge", "--chaos", "--trace",
                           timeout=600)
    assert modules == []
    d = rec["detail"]
    assert set(d) == (_jax_detail_keys("BENCH_serve_r13.json")
                      - UNPORTED_SERVE_KEYS)
    for leg in ("replicas", "chaos", "trace"):
        _leg_keys_are_the_root_benchs(leg, d[leg])
    with open(os.path.join(REPO, LEG_RECORDS["replicas"])) as f:
        root = json.load(f)["detail"]
    assert set(d["replicas"]["fleet_leg"]) == set(
        root["replicas"]["fleet_leg"])
    assert set(d["chaos"]["replica_kill"]) == set(
        root["chaos"]["replica_kill"])
    rep = d["replicas"]
    assert rep["count"] == 2 and rep["disjoint_devices"] is False
    assert [p["id"] for p in rep["provenance"]] == ["r0", "r1"]
    fl = rep["fleet_leg"]
    assert fl["balance_ok"] and set(fl["per_replica_dispatches"]) == {
        "r0", "r1"}
    assert rep["final"]["hedge"] is True
    ch = d["chaos"]
    assert isinstance(ch["failovers"], int) and ch["failovers"] > 0
    assert isinstance(ch["hedges"], int)
    assert ch["availability_excluding_injected"] == 1.0
    assert ch["replica_kill"]["rescued_exactly"]
    assert ch["replica_kill"]["target"] == "r1"
    assert ch["injected_replica_faults_surfaced"] == 0
    assert ch["poison_isolated_exact"] and ch["rollback_engaged"]
    assert d["trace"]["chaos"]["failover_rescue_ok"] is True
    assert d["recompiles_after_warmup"] == 0 and d["n_chips"] == 1


def test_serve_dtype_sweep_and_cascade_record(tmp_path):
    """--dtype-sweep --cascade on a fitted MLP checkpoint (its int8 and
    bfloat16 variants clear their gates): both legs with the root
    bench's keys (its r06 and r10 records), every phase building
    nothing, the cascade's bars computed as the root bench's and its
    stressed point escalating."""
    from distributedmnist_tpu_torch.checkpoint import Checkpointer
    from torch_fit_util import fit_params

    ck = Checkpointer(str(tmp_path))
    ck.save(7, {"params": fit_params(), "optimizer": {},
                "scheduler": {}})
    ck.close()
    rec, modules, _ = _run(*SERVE_ARGS, "--checkpoint-dir", str(tmp_path),
                           "--dtype-sweep", "--cascade", timeout=600)
    assert modules == []
    d = rec["detail"]
    assert d["params"] == f"checkpoint {tmp_path}"
    for leg in ("dtype_sweep", "cascade"):
        _leg_keys_are_the_root_benchs(leg, d[leg])
    sw = d["dtype_sweep"]
    assert set(sw["legs"]) == {"float32", "bfloat16", "int8"}
    for dt, leg in sw["legs"].items():
        assert leg["recompiles_after_warmup"] == 0, dt
        assert leg["img_s_chip"] > 0, dt
    assert set(sw["speedup_vs_float32"]) == {"bfloat16", "int8"}
    ca = d["cascade"]
    with open(os.path.join(REPO, LEG_RECORDS["cascade"])) as f:
        root = json.load(f)["detail"]["cascade"]
    assert set(ca["legs"]) == set(root["legs"])
    for name in ca["legs"]:
        assert set(ca["legs"][name]) == set(root["legs"][name]), name
        assert ca["legs"][name]["recompiles_after_warmup"] == 0, name
    # 'auto': the cheapest ready variant, bfloat16 too once the sweep
    # has warmed it (the root bench's rule)
    assert ca["calibration"]["passed"]
    assert ca["cheap_dtype"] in ("int8", "bfloat16")
    # the bars are computed as the root bench computes them (its probe
    # stream is random pixels, off the calibration batch's distribution,
    # so the agreement bar is reported, not assumed)
    agree = ca["agreement_vs_f32"]
    assert ca["agreement_ok"] == (agree["balanced"] >= 0.995)
    assert agree["balanced"] >= agree["fast"] and ca["agreement_rows"] > 0
    assert ca["efficiency_ok"] == (ca["cascade_efficiency_vs_fast"]
                                   is not None
                                   and ca["cascade_efficiency_vs_fast"]
                                   >= 0.9)
    assert ca["legs"]["balanced_stressed"]["escalation_fraction"] > 0
    assert d["recompiles_after_warmup"] == 0


def test_serve_multimodel_swap_artifact_and_baseline_records(tmp_path):
    """--multimodel --swap-during-load with --artifact-dir: both legs with
    the root bench's keys (its r11 and r02 records) and bars computed as
    it computes them; the swap built nothing after the candidate's warm
    and left it live; no build after warmup in the whole run (the
    catalog's and the candidate's warmups excluded). The record lands as
    BENCH_torch_serve_r01.json with its commit, and a second run with
    --baseline on it embeds the delta with the root bench's rows and
    lands as r02."""
    out = str(tmp_path)
    rec, modules, err = _run(*SERVE_ARGS, "--multimodel",
                             "--swap-during-load", "--artifact-dir", out,
                             timeout=600)
    assert modules == []
    d = rec["detail"]
    assert set(d) == (_jax_detail_keys("BENCH_serve_r13.json")
                      - UNPORTED_SERVE_KEYS)
    for leg in ("multimodel", "swap"):
        _leg_keys_are_the_root_benchs(leg, d[leg])
    with open(os.path.join(REPO, LEG_RECORDS["multimodel"])) as f:
        assert set(d["multimodel"]) == set(json.load(f)["detail"]
                                           ["multimodel"])
    mm = d["multimodel"]
    assert mm["models"] == ["mlp", "lenet"]
    assert mm["recompiles_after_warmup"] == 0
    assert mm["warmup_compile_events"] >= 2      # two engines at least
    assert set(mm["fairness"]) == {"light", "heavy"}
    total = sum(f["granted_rows"] for f in mm["fairness"].values())
    for t, f in mm["fairness"].items():
        assert f["granted_rows"] > 0
        w = mm["weights"][t] / sum(mm["weights"].values())
        assert f["ratio"] == round(f["granted_rows"] / total / w, 3)
    assert mm["fairness_ok"] == all(0.8 <= f["ratio"] <= 1.25
                                    for f in mm["fairness"].values())
    assert mm["light_p99_ok"] == (mm["light_p99_degradation_x"] <= 1.5)
    assert mm["light_p99_bar_reachable"] == (mm["host_contention_x"]
                                             <= 1.5)
    assert mm["slo_attainment"]["light"] is not None
    assert mm["slo_attainment"]["heavy"] is None     # best-effort class
    assert mm["max_skip_observed"] >= 0
    sw = d["swap"]
    assert sw["recompiles_after_swap"] == 0 and sw["load_warm_s"] > 0
    assert sw["warmup_compile_events"] >= 1
    assert sw["swap_window"]["by_version"]["v-swap"]["requests"] > 0
    assert d["live_version_final"] == "v-swap"
    assert d["recompiles_after_warmup"] == 0
    first = tmp_path / "BENCH_torch_serve_r01.json"
    with open(first) as f:
        saved = json.load(f)
    assert saved == rec
    assert len(saved["detail"]["host"]["git_commit"]) == 40
    assert f"artifact: {first}" in err
    rec2, _, err2 = _run(*SERVE_ARGS, "--baseline", str(first),
                         "--artifact-dir", out)
    delta = rec2["detail"]["baseline"]
    root_rows = _root_bench()._baseline_delta(rec2, rec, str(first))
    assert set(delta) == set(root_rows)
    assert delta["baseline_device_kind"] == "cpu"
    assert delta["recompiles_after_warmup"] == {
        "current": 0, "baseline": 0, "delta_pct": None}
    assert delta["compile_surface"]["match"] is None
    assert "baseline delta vs BENCH_torch_serve_r01.json" in err2
    assert sorted(os.listdir(out)) == ["BENCH_torch_serve_r01.json",
                                       "BENCH_torch_serve_r02.json"]


@pytest.mark.parametrize("cur,base", [
    ("BENCH_serve_r13.json", "BENCH_serve_r12.json"),
    ("BENCH_serve_r11.json", "BENCH_serve_r10.json"),
    ("BENCH_serve_r08.json", "BENCH_serve_r06.json"),
    ("BENCH_serve_r09.json", "BENCH_serve_r13.json")])
def test_baseline_delta_rows_equal_the_root_benchs(cur, base):
    """Exact: the same pair of the JAX package's records through both
    benches' _baseline_delta gives the same rows, values and
    percentages."""
    with open(os.path.join(REPO, cur)) as f:
        c = json.load(f)
    with open(os.path.join(REPO, base)) as f:
        b = json.load(f)
    assert tbench._baseline_delta(c, b, base) == \
        _root_bench()._baseline_delta(c, b, base)


def _edited_baseline(tmp_path, edit) -> str:
    """The JAX package's last CPU record with one field edited."""
    with open(os.path.join(REPO, "BENCH_serve_r13.json")) as f:
        rec = json.load(f)
    edit(rec["detail"])
    path = tmp_path / "base.json"
    path.write_text(json.dumps(rec))
    return str(path)


@pytest.mark.parametrize("case,edit,extra", [
    ("device_kind",
     lambda d: d["host"].update(device_kind="NVIDIA H100 80GB HBM3"), ()),
    ("infer_dtype", lambda d: d["host"].update(infer_dtype="int8"), ()),
    ("zipf cache", lambda d: d.update(zipf={"cache_enabled": False}),
     ("--zipf",)),
    ("gateway", lambda d: d.update(gateway={"workers": 2}), ())])
def test_baseline_refused_before_any_load_phase(tmp_path, case, edit,
                                                extra):
    """A baseline of another card, precision, zipf cache setting, or a
    gateway record: exit 4 with the reason, no record, no file, and no
    load phase run (the root bench's refusals)."""
    path = _edited_baseline(tmp_path, edit)
    out = tmp_path / "records"
    _, _, err = _run(*SERVE_ARGS, *extra, "--baseline", path,
                     "--artifact-dir", str(out), rc=tbench.REFUSED)
    assert f"REFUSING --baseline {path}" in err, case
    assert "closed loop" not in err
    assert os.listdir(out) == []


def test_refused_baseline_is_not_retried_by_the_supervisor(tmp_path):
    """The refusal is deterministic: the supervised bench exits 4 after
    one attempt."""
    path = _edited_baseline(
        tmp_path, lambda d: d["host"].update(device_kind="TPU v4"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.bench",
         *SERVE_ARGS, "--baseline", path, "--no-artifact"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == tbench.REFUSED, proc.stderr[-3000:]
    assert "not retried" in proc.stderr and "attempt 2" not in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")]


def test_serve_artifacts_are_numbered_under_the_ports_prefix(tmp_path):
    """The port counts only BENCH_torch_serve_rNN.json: the JAX package's
    BENCH_serve_rNN.json records (r01-r13 in the repository) never move
    its count, its records never move the root bench's, and asking for
    the next path writes nothing."""
    d = str(tmp_path)
    (tmp_path / "BENCH_serve_r05.json").write_text("{}")
    assert tbench._next_serve_artifact(d) == os.path.join(
        d, "BENCH_torch_serve_r01.json")
    (tmp_path / "BENCH_torch_serve_r02.json").write_text("{}")
    (tmp_path / "BENCH_torch_serve_r02_trace.json").write_text("{}")
    assert tbench._next_serve_artifact(d) == os.path.join(
        d, "BENCH_torch_serve_r03.json")
    assert _root_bench()._next_serve_artifact(d) == os.path.join(
        d, "BENCH_serve_r06.json")
    before = sorted(os.listdir(REPO))
    jax_records = [f for f in before if f.startswith("BENCH_serve_r")]
    assert {f"BENCH_serve_r{i:02d}.json" for i in range(1, 14)} <= set(
        jax_records)
    nxt = os.path.basename(tbench._next_serve_artifact(REPO))
    assert nxt.startswith("BENCH_torch_serve_r") and nxt not in before
    assert sorted(os.listdir(REPO)) == before


def test_unported_table_shrank_by_the_fleet_and_cascade_flags(tmp_path):
    """The fleet's, the cascade's, tenancy's and the records' flags left
    UNPORTED; each is a flag of the port's bench now (serve mode only),
    and the rest still exit 2."""
    assert set(tbench.UNPORTED) == {"--gateway", "--trace-replay",
                                    "--autoscale"}
    args = tbench._parse(["serve", "--serve-replicas", "2", "--serve-hedge",
                          "--dtype-sweep", "--cascade"])
    assert (args.serve_replicas, args.serve_hedge, args.dtype_sweep,
            args.cascade) == (2, True, True, True)
    out = tmp_path / "records"
    args = tbench._parse(["serve", "--multimodel", "--swap-during-load",
                          "--baseline",
                          os.path.join(REPO, "BENCH_serve_r13.json"),
                          "--artifact-dir", str(out)])
    assert (args.multimodel, args.swap_during_load) == (True, True)
    assert out.is_dir()              # made at parse, before any phase
    assert tbench._parse(["serve", "--no-artifact"]).no_artifact is True
    (tmp_path / "bad.json").write_text('{"detail": {}}')
    for argv in (["throughput", "--serve-replicas", "2"],
                 ["serve", "--serve-replicas", "0"],
                 ["time-to-accuracy", "--cascade"],
                 ["throughput", "--multimodel"],
                 ["throughput", "--no-artifact"],
                 ["serve", "--baseline", str(tmp_path / "none.json")],
                 ["serve", "--baseline", str(tmp_path / "bad.json")],
                 ["serve", "--artifact-dir", ""]):
        with pytest.raises(SystemExit) as exc:
            tbench._parse(argv)
        assert exc.value.code == 2


def test_chaos_fault_spec_equals_the_root_benchs():
    from distributedmnist_tpu.serve.faults import parse_spec

    root = _root_bench()
    for live, kill in (("v1", None), ("step-5", "r1")):
        assert tbench.chaos_fault_spec(live, kill) == \
            root.chaos_fault_spec(live, kill)
        parse_spec(tbench.chaos_fault_spec(live, kill))


# -- guards -----------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["throughput", "--model", "mlp", "--bench-steps", "1"],
    ["time-to-accuracy", "--model", "mlp"],
    ["serve", "--model", "mlp"]])
def test_bench_raises_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tbench.main(argv + ["--inline"])


@pytest.mark.parametrize("argv,item", [
    (["serve", "--autoscale"], "item 3"),
    (["serve", "--swap-during-load", "--autoscale"], "item 3"),
    (["throughput", "--autoscale"], "item 3"),
    (["serve", "--trace-replay", "square:qps=10"], "item 3"),
    (["serve", "--gateway", "2"], "item 2"),
    (["serve", "--multimodel", "--gateway", "2"], "item 2"),
    (["serve", "--baseline", "BENCH_serve_r13.json", "--gateway", "3"],
     "item 2"),
    (["serve", "--artifact-dir", "out", "--trace-replay", "square:qps=10"],
     "item 3")])
def test_unported_flag_exits_2(argv, item, capsys):
    with pytest.raises(SystemExit) as exc:
        tbench.main(argv + ["--inline"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP.md section 1 {item}" in err


@pytest.mark.parametrize("argv", [
    ["throughput", "--serve-qps", "10"],
    ["serve", "--bench-steps", "4"],
    ["time-to-accuracy", "--repeats", "2"],
    ["throughput", "--trials", "2"],
    ["serve", "--serve-duration", "0"],
    ["throughput", "--lowlat"],
    ["serve", "--zipf-cache-off"],
    ["serve", "--serve-cache"],
    ["serve", "--zipf", "--serve-cache-capacity", "0"]])
def test_misplaced_flags_exit_2(argv):
    with pytest.raises(SystemExit) as exc:
        tbench.main(argv + ["--inline"])
    assert exc.value.code == 2


# -- the sweep and smoke modes, bfloat16, --data-dir, supervision -----------------


def test_sweep_record():
    """Two per-card batches; the record has SWEEP_r05.json's keys, the
    all-reduce modelled at the NCCL bandwidth measured on the card's host
    (no TPU constant), vs_baseline null."""
    rec, modules, _ = _run(
        "sweep", "--device", "cpu", "--model", "mlp", "--sweep-batches",
        "32,64", "--bench-steps", "4", "--warmup-steps", "2")
    assert modules == []
    assert set(rec) == RECORD_KEYS
    with open(os.path.join(REPO, "SWEEP_r05.json")) as f:
        root = json.load(f)["detail"]
    d = rec["detail"]
    assert set(d) == set(root)
    for block in ("strong_scaling", "weak_scaling", "weak_scaling_at_largest",
                  "prediction_range"):
        assert set(d[block]) == set(root[block]), block
    assert rec["metric"] == "predicted_8chip_images_per_sec_per_chip"
    assert rec["vs_baseline"] is None and rec["value"] > 0
    assert sorted(d["curve_img_s_chip"]) == ["32", "64"]
    assert set(d["curve_img_s_chip"]["32"]) == set(root["curve_img_s_chip"]
                                                   ["64"])
    assert d["n_params"] == 101_770 and d["grad_bytes_f32"] == 407_080
    assert d["ici_assumed_gbps"] == tbench.ALLREDUCE_BUS_GBPS["mlp"]
    assert d["ici_assumed_gbps"] != root["ici_assumed_gbps"]
    assert d["backend"] == "cpu" and d["strong_scaling"]["per_chip_batch"] \
        == 32
    lo, hi = d["prediction_range"]["strong_img_s_chip"]
    assert lo <= rec["value"] <= hi


def test_smoke_record():
    rec, modules, _ = _run("smoke", "--device", "cpu", "--model", "mlp")
    assert modules == []
    assert set(rec) == RECORD_KEYS
    assert set(rec["detail"]) == _jax_detail_keys("SMOKE_r05.json")
    assert rec["metric"] == "smoke" and rec["vs_baseline"] is None
    d = rec["detail"]
    assert d["legs"] == ["train", "eval", "checkpoint-save",
                         "restore-resume", "accuracy-floor"]
    assert d["backend"] == "cpu" and d["final_accuracy"] >= 0.85
    assert d["window_steps"] == 64 and d["short_window"] is True


def test_bfloat16_throughput_record():
    rec, modules, _ = _run(
        "throughput", "--device", "cpu", "--model", "mlp", "--dtype",
        "bfloat16", "--global-batch", "64", "--bench-steps", "4",
        "--warmup-steps", "2")
    assert modules == []
    assert set(rec["detail"]) == _jax_detail_keys("THROUGHPUT_r05.json")
    assert rec["detail"]["dtype"] == "bfloat16" and rec["value"] > 0


def test_data_dir_runs_on_idx_files_through_the_supervised_worker(
        tmp_path):
    """--data-dir on IDX fixtures written from a small synthetic set, the
    bench supervised as by default: the worker's record is forwarded, and
    it read real-format files (data "real")."""
    from idx_util import write_idx_fixtures

    write_idx_fixtures(str(tmp_path), tmnist.synthetic_mnist(
        seed=4, train_n=1024, test_n=256))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.bench",
         "throughput", "--device", "cpu", "--model", "mlp", "--data-dir",
         str(tmp_path), "--global-batch", "64", "--bench-steps", "4",
         "--warmup-steps", "2"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["detail"]["data"] == "real"
    assert "bench: launches" in proc.stderr


def test_supervised_bench_fails_with_no_cpu_rerun():
    """Every attempt of the supervised worker fails (no card for the
    default device): the bench exits 1 after --max-attempts attempts and
    never re-runs on the CPU, as the root bench's fallback would."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.bench",
         "throughput", "--model", "mlp", "--bench-steps", "1",
         "--max-attempts", "2"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 1
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert "attempt 2/2" in proc.stderr and "attempt 3" not in proc.stderr
    assert "fallback" not in proc.stderr
    assert "all attempts failed" in proc.stderr


@pytest.mark.parametrize("argv", [
    ["sweep", "--global-batch", "64"],
    ["throughput", "--sweep-batches", "64,128"],
    ["sweep", "--sweep-batches", "a,b"],
    ["smoke", "--bench-steps", "4"],
    ["serve", "--dtype", "bfloat16"],
    ["serve", "--data-dir", "d"]])
def test_new_mode_flags_misplaced_exit_2(argv):
    with pytest.raises(SystemExit) as exc:
        tbench.main(argv + ["--inline"])
    assert exc.value.code == 2
