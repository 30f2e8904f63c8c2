"""The port's tensor parallelism (parallel/mesh.py make_mesh,
parallel/tp.py, the trainer's TP rules) against the JAX package's
(parallel/mesh.py, parallel/tp.py, tests/test_tp.py), on the CPU.

Case for case with JAX's tests/test_tp.py: the 2-D layout, indivisible
sizes, each leaf's shard (Adam's moments too), the 1-D layout
replicated, the partial fallback's warning, the all-fallback and
no-match errors, explicit mode and an indivisible world refused. Then 2
ranks over gloo on localhost (parallel/mh_smoke.py, one launch, several
fits): MLP (SGD at lr 0.05, the kernel path and the plain one) and
LeNet-5 (Adam) at model_parallel 2 from the JAX package's init (carried
across by interop.py) against JAX's TP step (make_train_step on a
('data', 'model') mesh of 2 virtual devices, state placed by
tp.state_shardings) and against the port's 1-rank run; a TP checkpoint
resumed by 1 rank and a 1-rank checkpoint resumed at model_parallel 2;
and the registry booting from a TP run's checkpoint.

Tolerances: error and warning texts equal JAX's; against the port's own
1-rank run rtol 1e-6 on the losses and atol 1e-6 on the params (a column
shard's products are the full layer's columns, and the row-parallel sum
of two partials differs from one product in the last bits only); 20
steps' losses against JAX's TP run: the MLP rtol 1e-5 (the same sums in
other orders); LeNet-5 with Adam rtol 1e-4, the tolerance that
tests/test_torch_train.py holds its 1-rank trajectory to: the port's 1
rank and JAX's 1 device already part by 3.6e-5 at step 20 (Adam divides
each update by the RMS of its gradient, so a gradient that is 0 in one
framework and a rounding residue in the other moves a weight by up to lr
a step), while TP itself moves neither package by more than 1e-6 (JAX's
TP run against its 1-device run, held here too).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributedmnist_tpu import config as jconfig
from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data import DeviceDataset as JDeviceDataset
from distributedmnist_tpu.data import IndexStream as JIndexStream
from distributedmnist_tpu.parallel import make_mesh as jmake_mesh
from distributedmnist_tpu.parallel import tp as jtp
from distributedmnist_tpu_torch import interop, models, optim, trainer
from distributedmnist_tpu_torch.checkpoint import restore_latest_params
from distributedmnist_tpu_torch.config import Config
from distributedmnist_tpu_torch.parallel import mh_smoke
from distributedmnist_tpu_torch.parallel import tp
from distributedmnist_tpu_torch.parallel.mesh import make_mesh
from distributedmnist_tpu_torch.serve.registry import build_serving
from torch_dp_util import launch_smoke

STEPS = 20
MLP_LR = 0.05
LENET_LR = 1e-3


def _jax_state(name, opt, lr):
    jm = jmodels.build(name, fused="xla", platform="cpu", conv="lax")
    tx = joptim.build(opt, lr, 0.9)
    return jm, tx, jtrainer.init_state(jax.random.PRNGKey(0), jm, tx,
                                       jnp.zeros((1, 28, 28, 1)))


def _to_port(name, params):
    conv = (interop.lenet_params_from_flax if name == "lenet"
            else interop.mlp_params_from_flax)
    return conv(jax.tree.map(np.asarray, params))


def _port_name(name, path) -> str:
    """A JAX param path as the port's parameter name."""
    keys = [p.key for p in path]
    return ("_" if name == "mlp" else ".").join(keys)


# -- the layout ---------------------------------------------------------------


@pytest.mark.parametrize("world,mp", ((8, 2), (8, 4), (4, 2), (2, 2),
                                      (8, 1)))
def test_mesh_layout_matches_jax(world, mp):
    devices = jax.devices("cpu")[:world]
    jm = jmake_mesh(devices, mp)
    ours = make_mesh(world, mp)
    assert (ours.dp, ours.model_parallel) == (
        jm.shape["data"], jm.shape.get("model", 1))
    grid = np.vectorize(lambda d: d.id)(jm.devices).reshape(-1, mp)
    for r in range(world):
        assert grid[ours.data_index(r), ours.model_index(r)] == r
    for m in range(mp):
        assert ours.data_ranks(m) == list(grid[:, m])
    for d in range(ours.dp):
        assert ours.model_ranks(d) == list(grid[d])


def test_mesh_indivisible_raises_with_jax_text():
    with pytest.raises(ValueError) as want:
        jmake_mesh(jax.devices("cpu")[:6], 4)
    with pytest.raises(ValueError, match="not divisible") as got:
        make_mesh(6, 4)
    assert str(got.value) == str(want.value)


# -- placement ------------------------------------------------------------------


@pytest.mark.parametrize("name,fused,mp", (("mlp", "xla", 2),
                                           ("mlp", "pallas-interpret", 2),
                                           ("lenet", "xla", 2),
                                           ("lenet", "xla", 4)))
def test_placements_match_jax_state_shardings(name, fused, mp):
    """Every parameter and every Adam moment: the port's placement is the
    spec JAX's state_shardings gives it."""
    mesh = jmake_mesh(jax.devices("cpu")[:8], mp)
    jm = jmodels.build(name, fused=fused, platform="cpu", conv="lax")
    state = jtrainer.init_state(jax.random.PRNGKey(0), jm,
                                joptim.build("adam", 1e-3),
                                jnp.zeros((1, 28, 28, 1)))
    sh = jtp.state_shardings(state, mesh, name)
    ours = tp.placements(models.full_shapes(name), name, mp)
    specs = {}
    for tree in (sh.params, sh.opt_state[0].mu, sh.opt_state[0].nu):
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            specs.setdefault(_port_name(name, path), set()).add(
                tuple(s.spec))
    assert set(specs) == set(ours)
    for k, dim in ours.items():
        want = specs[k]
        assert len(want) == 1, (k, want)
        ndim = len(models.full_shapes(name)[k])
        spec = () if dim is None else tuple(
            "model" if d == dim else None for d in range(ndim))
        assert spec == next(iter(want)), k


@pytest.mark.parametrize("name,opt", (("mlp", "adam"), ("mlp", "sgd"),
                                      ("lenet", "adam")))
def test_each_rank_holds_its_shard_and_its_optimizer_state(name, opt):
    """Model rank 1 of 2: each sharded parameter is its slice of the full
    init, and the optimizer's state (Adam's moments, SGD's momentum) has
    the shard's shape."""
    place = tp.placements(models.full_shapes(name), name, 2)
    ctx = tp.TPContext(group=None, size=2, index=1, placement=place)
    net = models.build(name, device="cpu", tp=ctx)
    full = models.init_params(name, 3)
    trainer._Shards(net, name, ctx).load_params(full)
    for k, v in net.state_dict().items():
        dim = place[k]
        assert torch.equal(v, full[k] if dim is None
                           else full[k].chunk(2, dim)[1]), k
    opt_, _ = optim.build(opt, net.parameters(), optim.make_schedule(1e-3))
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt_.step()
    sharded = 0
    for k, v in net.state_dict().items():
        dim = place[k]
        want = full[k] if dim is None else full[k].chunk(2, dim)[1]
        assert tuple(v.shape) == tuple(want.shape), k
        sharded += dim is not None
        state = opt_.state[dict(net.named_parameters())[k]]
        for t in state.values():
            if t.dim():
                assert t.shape == v.shape, k
    assert sharded == 3


def test_one_d_layout_is_replicated():
    mesh = jmake_mesh(jax.devices("cpu")[:8])
    _, _, state = _jax_state("mlp", "sgd", 0.1)
    sh = jtp.state_shardings(state, mesh, "mlp")
    assert all(s.spec == P() for s in jax.tree.leaves(
        sh, is_leaf=lambda x: hasattr(x, "spec")))
    for name in ("mlp", "lenet"):
        ours = tp.placements(models.full_shapes(name), name, 1)
        assert set(ours.values()) == {None}


def _jax_error(tree, mp=2):
    mesh = jmake_mesh(jax.devices("cpu")[:8], mp)
    with pytest.raises(ValueError) as e:
        jtp.state_shardings(tree, mesh, "mlp")
    return str(e.value)


def test_partial_fallback_warns_as_jax(caplog):
    shapes = {"hidden.kernel": (4, 6), "hidden.bias": (7,)}
    with caplog.at_level(logging.WARNING,
                         logger="distributedmnist_tpu_torch"):
        got = tp.placements(shapes, "mlp", 2)
    assert got == {"hidden.kernel": 1, "hidden.bias": None}
    msgs = [r.getMessage() for r in caplog.records]
    assert any("replicating this leaf" in m for m in msgs)
    assert any(m.endswith("dim 0 (size 7) not divisible by "
                          "model_parallel=2; replicating this leaf")
               for m in msgs)


def test_all_fallback_and_no_match_raise_with_jax_text():
    want = _jax_error({"hidden": {"kernel": np.zeros((7, 9))}})
    with pytest.raises(ValueError, match="fell back to replicated") as e:
        tp.placements({"hidden.kernel": (7, 9)}, "mlp", 2)
    assert str(e.value) == want
    want = _jax_error({"encoder": {"kernel": np.zeros((8, 8))}})
    with pytest.raises(ValueError, match="no parameter") as e:
        tp.placements({"encoder.kernel": (8, 8)}, "mlp", 2)
    assert str(e.value) == want


@pytest.mark.parametrize("kw,world", (
    ({"spmd_mode": "explicit", "model_parallel": 2}, 8),
    ({"model_parallel": 3}, 8),
    ({"model_parallel": 2, "batch_size": 102}, 8)))
def test_trainer_refuses_as_jax(kw, world):
    """explicit mode under TP, an indivisible world, and a batch that the
    data-parallel share does not divide: the JAX trainer's messages."""
    base = dict(device="cpu", synthetic=True, log_every=0,
                target_accuracy=None, num_devices=world, steps=1,
                batch_size=256)
    data = mh_smoke.smoke_data()
    with pytest.raises(ValueError) as want:
        jtrainer.fit(jconfig.Config(**{**base, **kw}), data=data)
    with pytest.raises(ValueError, match="model_parallel|divisible") as got:
        trainer.validate(Config(**{**base, **kw}), world)
    assert str(got.value) == str(want.value)


# -- 2 ranks over gloo ----------------------------------------------------------


def _jax_tp_losses(name, opt, lr, mp=2):
    """STEPS steps of JAX's TP path as its fit() builds it, on a (1, mp)
    ('data', 'model') mesh: the state placed by tp.state_shardings, the
    auto step, the smoke data, global batch 128. mp 1: one device."""
    mesh = jmake_mesh(jax.devices("cpu")[:mp], mp)
    jm, tx, state = _jax_state(name, opt, lr)
    state = jax.device_put(state, jtp.state_shardings(state, mesh, name))
    ds = JDeviceDataset(mh_smoke.smoke_data(), mesh, pixel_format="packed")
    step = jtrainer.make_train_step(jm, tx, mesh, "auto",
                                    pixel_format="packed")
    stream = JIndexStream(ds.train_n, 128, 0, mesh)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, ds.train_x, ds.train_y,
                              stream.next_block(1))
        losses.append(float(metrics["loss"]))
    return losses


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """{run: record} of the 2-rank launch (rank 0's; "ranks": every
    rank's), the 1-rank runs, and the JAX inits' .npz paths."""
    tmp = tmp_path_factory.mktemp("tp")
    inits = {}
    for name, opt, lr in (("mlp", "sgd", MLP_LR),
                          ("lenet", "adam", LENET_LR)):
        params = _to_port(name, _jax_state(name, opt, lr)[2].params)
        inits[name] = str(tmp / f"{name}_init.npz")
        np.savez(inits[name], **{k: v.numpy() for k, v in params.items()})
    mlp = {"init_npz": inits["mlp"], "learning_rate": MLP_LR}
    lenet = {"init_npz": inits["lenet"], "model": "lenet",
             "optimizer": "adam", "learning_rate": LENET_LR}
    d = str(tmp)
    specs = {
        "mlp_pallas": {**mlp, "fused_kernels": "pallas"},
        "mlp_xla": {**mlp, "fused_kernels": "xla"},
        "lenet": lenet,
        # resumes at model_parallel 2 from the 1-rank checkpoint of step
        # 10 written below; the next run writes a TP checkpoint of step
        # 10, which 1 rank resumes after the launch
        "resume_tp": {**mlp, "checkpoint_dir": f"{d}/one-then-tp"},
        "tp_first": {**mlp, "steps": 10, "checkpoint_dir": f"{d}/tp-then-one"},
    }
    data = mh_smoke.smoke_data()

    def one(spec):
        spec = dict(spec)
        with np.load(spec.pop("init_npz")) as z:
            init = {k: torch.from_numpy(z[k]) for k in z.files}
        return mh_smoke.run(mh_smoke.smoke_config(
            "mlp-dp2", device="cpu", **{"steps": STEPS, **spec}), data,
            init)

    out = {"one": {n: one(specs[n]) for n in ("mlp_pallas", "mlp_xla",
                                              "lenet")}}
    out["one"]["full"] = one({**mlp, "checkpoint_dir": f"{d}/full"})
    one({**mlp, "steps": 10, "checkpoint_dir": f"{d}/one-then-tp"})
    names = list(specs)
    recs, _ = launch_smoke(2, d, [{"model_parallel": 2, **specs[n]}
                                  for n in names],
                           ("--preset", "mlp-dp2", "--steps", str(STEPS)))
    out["tp"] = {n: recs[0][i] for i, n in enumerate(names)}
    out["ranks"] = recs
    out["one"]["resume_one"] = one({**mlp, "checkpoint_dir":
                                    f"{d}/tp-then-one"})
    out["dirs"] = {k: f"{d}/{k}" for k in ("full", "one-then-tp",
                                            "tp-then-one")}
    return out


def test_every_rank_reports_the_same_tp_run(tp_runs):
    for recs in zip(*tp_runs["ranks"]):
        for rec in recs:
            assert rec["model_parallel"] == 2 and rec["n_processes"] == 2
            assert rec["losses"] == recs[0]["losses"]
            assert not rec["jax_loaded"]
    assert tp_runs["tp"]["mlp_pallas"]["pixel_format"] == "packed"


@pytest.mark.parametrize("run,name,opt,lr,rtol", (
    ("mlp_pallas", "mlp", "sgd", MLP_LR, 1e-5),
    ("mlp_xla", "mlp", "sgd", MLP_LR, 1e-5),
    ("lenet", "lenet", "adam", LENET_LR, 1e-4)))
def test_tp_matches_jax_tp_and_one_rank(tp_runs, run, name, opt, lr, rtol):
    got = tp_runs["tp"][run]["losses"]
    assert len(got) == STEPS and got[-1] < got[0]
    want = _jax_tp_losses(name, opt, lr)
    np.testing.assert_allclose(got, want, rtol=rtol)
    np.testing.assert_allclose(got, tp_runs["one"][run]["losses"],
                               rtol=1e-6)
    np.testing.assert_allclose(want, _jax_tp_losses(name, opt, lr, mp=1),
                               rtol=1e-6)


def _final(d):
    params, step = restore_latest_params(d, template=models.init_params(
        "mlp", 0))
    assert step == STEPS
    return params


def test_tp_checkpoint_restores_at_one_rank_and_back(tp_runs):
    """1 rank's checkpoint of step 10 resumed at model_parallel 2, and a
    TP checkpoint of step 10 resumed by 1 rank: each ends on the
    uninterrupted 1-rank run's params, and its last 10 losses are that
    run's. A TP checkpoint holds the full params."""
    full = _final(tp_runs["dirs"]["full"])
    want = tp_runs["one"]["full"]["losses"][10:]
    for run in (tp_runs["tp"]["resume_tp"], tp_runs["one"]["resume_one"]):
        assert run["restored"] and run["steps"] == STEPS
        np.testing.assert_allclose(run["losses"], want, rtol=1e-6)
    for d in ("one-then-tp", "tp-then-one"):
        got = _final(tp_runs["dirs"][d])
        for k in full:
            np.testing.assert_allclose(got[k].numpy(), full[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_registry_boots_from_a_tp_checkpoint(tp_runs):
    d = tp_runs["dirs"]["one-then-tp"]
    registry, _, _ = build_serving(Config(model="mlp", device="cpu",
                                          checkpoint_dir=d,
                                          serve_max_batch=16))
    mv = registry.bootstrap()
    assert mv.step == STEPS and mv.source == f"checkpoint {d}"


def test_partial_fallback_slices_the_replicated_bias():
    """A sharded hidden kernel beside a replicated hidden bias (JAX's
    partial fallback): each model rank adds its columns' slice of the
    full bias, and the bias's gradient is summed over the model group.
    In one process a group of one rank stands for the model group (its
    all-reduce is the identity), so the two model ranks' outputs are
    summed here: with the logits bias counted once, they are the full
    MLP's, and their bias gradients add up to the full MLP's."""
    from distributedmnist_tpu_torch.parallel import distributed, launch

    full = models.init_params("mlp", 5)
    full["hidden_bias"] = torch.linspace(-0.5, 0.5, 128)
    place = {"hidden_kernel": 1, "hidden_bias": None, "logits_kernel": 0,
             "logits_bias": None}
    x = torch.from_numpy(mh_smoke.smoke_data()["test_x"][:8]).float() / 255
    ref = models.build("mlp", device="cpu")
    ref.load_state_dict(full)
    ref(x).sum().backward()
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{launch.free_port()}",
        world_size=1, rank=0)
    try:
        outs, grads = [], []
        for index in (0, 1):
            ctx = tp.TPContext(group=None, size=2, index=index,
                               placement=place)
            net = models.build("mlp", device="cpu", tp=ctx)
            trainer._Shards(net, "mlp", ctx).load_params(full)
            assert net.hidden_bias.shape == (128,)
            y = net(x)
            y.sum().backward()
            outs.append(y.detach())
            grads.append(net.hidden_bias.grad)
    finally:
        distributed.shutdown()
    torch.testing.assert_close(outs[0] + outs[1] - full["logits_bias"],
                               ref(x).detach(), rtol=1e-5, atol=1e-5)
    assert not grads[0][64:].any() and not grads[1][:64].any()
    torch.testing.assert_close(grads[0] + grads[1], ref.hidden_bias.grad,
                               rtol=1e-5, atol=1e-6)
