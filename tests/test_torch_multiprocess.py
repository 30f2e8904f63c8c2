"""The port's data parallelism against the single-rank trajectory and the
JAX package, on the CPU: 2 and 4 ranks over gloo on localhost, each a
subprocess of `distributedmnist_tpu_torch.parallel.mh_smoke` training on
its tiny synthetic MNIST (1024 train images, 255 test images).

One 2-rank and one 4-rank launch each run several fits in one process
group; the 1-rank references run in this process. Every MLP run starts
from the JAX package's init (carried across as an .npz through
interop.py), so the 2-rank `explicit` run is held step for step against
the JAX package's explicit step (shard_map + lax.pmean) on 2 of
conftest's 8 virtual devices.

The MLP runs are config 3 (mlp-dp2: SGD, momentum 0.9, global batch
128) at lr 0.05, the JAX smoke worker's rate, not the preset's 0.1: at
0.1 on this data a hidden unit's pre-activation sits at a rounding tie
on the third step, and its relu gradient flips between the port and JAX
on ONE device already (unit 126's bias 4.6e-5 apart after step 3, the
losses 0.58% apart after step 20), with no data parallelism involved; at
0.05 the two agree within 2.2e-7 on the losses.

Tolerances, as the JAX package's test_one_dev_equals_eight_dev and
test_auto_equals_explicit_mode hold theirs:
- N ranks against 1 rank at the same global batch: MLP/SGD losses and
  params rtol 1e-5 (atol 1e-5 on the params), LeNet/Adam losses rtol
  1e-4 and params atol 2*lr (Adam moves a weight whose gradient is a
  rounding residue by up to lr a step);
- auto against explicit: rtol 1e-6 (the same sums; DDP divides by the
  world before its all-reduce and explicit after, a power of two both);
- grad_accum 2 against 1: rtol 1e-5;
- the port's 2-rank explicit run against JAX's on 2 devices, 20 steps:
  1e-5 on the losses and the params;
- the masked eval summed over ranks: the 1-rank count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data import DeviceDataset as JDeviceDataset
from distributedmnist_tpu.data import IndexStream as JIndexStream
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu_torch import interop
from distributedmnist_tpu_torch.checkpoint import restore_latest_params
from distributedmnist_tpu_torch.config import PRESETS
from distributedmnist_tpu_torch.parallel import mh_smoke
from torch_dp_util import launch_smoke

STEPS = 20
MLP_LR = 0.05


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX MLP's init (trainer.init_state at seed 0) as a port-format
    .npz, and the flax params themselves."""
    jm = jmodels.build("mlp", fused="xla", platform="cpu")
    tx = joptim.build("sgd", MLP_LR, 0.9)
    state = jtrainer.init_state(jax.random.PRNGKey(0), jm, tx,
                                jnp.zeros((1, 28, 28, 1)))
    path = str(tmp_path_factory.mktemp("init") / "mlp_init.npz")
    params = interop.mlp_params_from_flax(
        jax.tree.map(np.asarray, state.params))
    np.savez(path, **{k: v.numpy() for k, v in params.items()})
    return path, state


def _runs(tmp, init_npz, tag):
    d = str(tmp)
    mlp = {"init_npz": init_npz, "learning_rate": MLP_LR}
    return [
        {"spmd_mode": "auto", **mlp, "checkpoint_dir": f"{d}/{tag}-auto"},
        {"spmd_mode": "explicit", **mlp,
         "checkpoint_dir": f"{d}/{tag}-explicit"},
        {"spmd_mode": "auto", "grad_accum": 2, **mlp,
         "checkpoint_dir": f"{d}/{tag}-ga2"},
        {"model": "lenet", "optimizer": "adam", "learning_rate": 1e-3,
         "checkpoint_dir": f"{d}/{tag}-lenet"},
    ]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory, jax_init):
    """{world: {run: record}} for worlds 1, 2 and 4 (the 4-rank launch
    without grad_accum: 128 rows over 4 ranks x 2 microbatches is the
    same split as 2 ranks). The 1-rank runs are in this process."""
    init_npz, _ = jax_init
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"w{world}")
        runs = _runs(tmp, init_npz, f"w{world}")
        if world == 4:
            runs = [r for r in runs if r.get("grad_accum", 1) == 1]
        recs, _ = launch_smoke(world, str(tmp), runs,
                               ("--preset", "mlp-dp2", "--steps", str(STEPS)))
        names = [n for n in ("auto", "explicit", "ga2", "lenet")
                 if world == 2 or n != "ga2"]
        out[world] = {"ranks": recs,
                      **{n: recs[0][i] for i, n in enumerate(names)}}
    tmp = tmp_path_factory.mktemp("w1")
    data = mh_smoke.smoke_data()
    with np.load(init_npz) as z:
        init = {k: torch.from_numpy(z[k]) for k in z.files}
    one = {}
    for name, spec in zip(("auto", "explicit", "ga2", "lenet"),
                          _runs(tmp, init_npz, "w1")):
        spec = dict(spec)
        spec.pop("init_npz", None)
        one[name] = mh_smoke.run(
            mh_smoke.smoke_config("mlp-dp2", device="cpu", steps=STEPS,
                                  **spec),
            data, init if name != "lenet" else None)
    out[1] = one
    return out


def _params(rec):
    params, step = restore_latest_params(rec["checkpoint_dir"])
    assert step == STEPS
    return {k: v.numpy() for k, v in params.items()}


def test_every_rank_reports_the_same_global_run(dp_runs):
    for world in (2, 4):
        for recs in zip(*dp_runs[world]["ranks"]):
            first = recs[0]
            assert [r["process_id"] for r in recs] == list(range(world))
            for r in recs:
                assert r["failed"] is None and not r["jax_loaded"]
                assert r["n_chips"] == r["n_processes"] == world
                assert r["multihost"] is True and r["backend"] == "gloo"
                assert r["steps"] == STEPS and r["global_batch"] == 128
                assert r["losses"] == first["losses"]
                assert r["test_accuracy"] == first["test_accuracy"]
            assert len(first["losses"]) == STEPS


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("mode", ("auto", "explicit"))
def test_mlp_sgd_ranks_match_one_rank(dp_runs, world, mode):
    got, want = dp_runs[world][mode], dp_runs[1]["auto"]
    assert got["spmd_mode"] == mode
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    gp, wp = _params(got), _params(want)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("world", (2, 4))
def test_lenet_adam_ranks_match_one_rank(dp_runs, world):
    got, want = dp_runs[world]["lenet"], dp_runs[1]["lenet"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    gp, wp = _params(got), _params(want)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=2e-3,
                                   err_msg=k)


@pytest.mark.parametrize("world", (2, 4))
def test_auto_equals_explicit(dp_runs, world):
    auto, explicit = dp_runs[world]["auto"], dp_runs[world]["explicit"]
    np.testing.assert_allclose(explicit["losses"], auto["losses"],
                               rtol=1e-6)
    ap, ep = _params(auto), _params(explicit)
    for k in ap:
        np.testing.assert_allclose(ep[k], ap[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_grad_accum_matches_the_full_batch_step(dp_runs):
    got, want = dp_runs[2]["ga2"], dp_runs[2]["auto"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(dp_runs[1]["ga2"]["losses"], want["losses"],
                               rtol=1e-5)


@pytest.mark.parametrize("world", (2, 4))
def test_masked_eval_summed_over_ranks_is_the_one_rank_count(
        dp_runs, world, tmp_path):
    """255 test images: the eval batch rounds up to 256 under 2 and 4
    ranks, its padding (index 0 again) masked on the last rank. The
    ranks' summed count on the final params equals an eval of the same
    params by one rank (eval-only on a copy of the checkpoint)."""
    import shutil

    rec = dp_runs[world]["auto"]
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(rec["checkpoint_dir"], ckpt)
    one = mh_smoke.run(mh_smoke.smoke_config(
        "mlp-dp2", device="cpu", steps=STEPS, eval_only=True,
        learning_rate=MLP_LR, checkpoint_dir=ckpt), mh_smoke.smoke_data())
    assert one["restored"] is True
    assert one["test_accuracy"] == rec["test_accuracy"]


def test_two_ranks_explicit_match_the_jax_explicit_step(dp_runs, jax_init):
    """20 steps of config 3 from the JAX init: the JAX package's explicit
    step (shard_map, lax.pmean) on 2 virtual devices against the port's
    2 ranks in spmd_mode explicit."""
    _, state = jax_init
    cfg = PRESETS["mlp-dp2"]
    mesh = make_mesh(jax.devices("cpu")[:2])
    data = mh_smoke.smoke_data()
    ds = JDeviceDataset(data, mesh, pixel_format="packed")
    jm = jmodels.build("mlp", fused="xla", platform="cpu")
    tx = joptim.build("sgd", MLP_LR, cfg.momentum)
    step = jtrainer.make_train_step(jm, tx, mesh, "explicit",
                                    pixel_format="packed")
    stream = JIndexStream(ds.train_n, cfg.batch_size, cfg.seed, mesh)
    state = jax.device_put(state, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, ds.train_x, ds.train_y,
                              stream.next_block(1))
        losses.append(float(metrics["loss"]))
    got = dp_runs[2]["explicit"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-5)
    want = interop.mlp_params_from_flax(jax.tree.map(np.asarray,
                                                     state.params))
    gp = _params(got)
    for k in want:
        np.testing.assert_allclose(gp[k], want[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
