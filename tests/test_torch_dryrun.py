"""The port's multichip gate (distributedmnist_tpu_torch/dryrun.py)
against the root __graft_entry__.py, on the CPU.

dryrun_legs(n) is held to the legs JAX's _dryrun_body appends for the
same n, read from its source: each `legs.append(...)` and its enclosing
`if` conditions, evaluated at n_devices = n (the function itself is not
run; its except branch, the jax-0.4.37 restore guard, has no
counterpart). dryrun_multichip(2) runs every leg on 2 CPU ranks over
gloo. The dp:auto leg's 2-step loss, from JAX's init carried across
through interop.py, is held to JAX's make_train_step(mode="auto") on a
2-device mesh over the same index block at rtol 1e-4, as the port's
LeNet/Adam losses are held to JAX's elsewhere (tests/test_torch_train.py,
tests/test_torch_multiprocess.py). entry()'s LeNet forward from JAX's
init is held to JAX's forward within 1e-5.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data.loader import DeviceDataset as JDeviceDataset
from distributedmnist_tpu.data.loader import IndexStream as JIndexStream
from distributedmnist_tpu.parallel import make_mesh, replicated
from distributedmnist_tpu_torch import dryrun, interop


def _jax_legs(n: int) -> list:
    """The legs _dryrun_body appends for n devices, read from its AST."""
    tree = ast.parse(inspect.getsource(graft._dryrun_body))
    legs: list = []

    def holds(conds) -> bool:
        return all(eval(compile(ast.Expression(c), "<cond>", "eval"),
                        {"n_devices": n}) for c in conds)

    def walk(nodes, conds):
        for node in nodes:
            if isinstance(node, ast.If):
                walk(node.body, conds + [node.test])
                walk(node.orelse, conds + [ast.UnaryOp(ast.Not(),
                                                       node.test)])
            elif isinstance(node, ast.Try):
                walk(node.body + node.orelse + node.finalbody, conds)
            elif isinstance(node, (ast.For, ast.With)):
                walk(node.body, conds)
            elif (isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "legs"
                  and holds(conds)):
                legs[:] = [e.value for e in node.value.elts]
            elif (isinstance(node, ast.Expr)
                  and isinstance(node.value, ast.Call)
                  and getattr(node.value.func, "attr", None) == "append"
                  and getattr(node.value.func.value, "id", None) == "legs"
                  and holds(conds)):
                legs.append(node.value.args[0].value)

    walk(tree.body[0].body, [])
    return legs


@pytest.mark.parametrize("n", (1, 2, 3, 8))
def test_dryrun_legs_equal_the_legs_jax_appends(n):
    assert dryrun.dryrun_legs(n) == _jax_legs(n)
    assert len(_jax_legs(8)) == 8


def test_dryrun_multichip_2_on_the_cpu_prints_every_leg(capsys):
    rec = dryrun.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert ("dryrun_multichip(2): ok (dp:auto:packed+flat, dp:explicit:u8, "
            "dp x tp2, dp+ga2, dp+ckpt, dp+stream, serve-reload, "
            "dp:2proc)") in out.splitlines()
    assert rec["backend"] == "gloo"
    assert set(rec["seconds"]) == set(rec["legs"]) | {"launch_s"}
    assert all(np.isfinite(v) for v in rec["losses"].values())
    # the plain versions on the CPU: no kernel launched
    assert not any(rec["launches"]["serve-reload"].values())


def test_dp_auto_leg_loss_equals_jax_on_a_2_device_mesh(tmp_path):
    n = 2
    jm = jmodels.build("lenet", platform="cpu")
    tx = joptim.build("adam", 1e-3, flat=True)
    state = jtrainer.init_state(jax.random.PRNGKey(0), jm, tx,
                                jnp.zeros((1, 28, 28, 1)))
    init = interop.lenet_params_from_flax(jax.tree.map(np.asarray,
                                                       state.params))
    npz = str(tmp_path / "init.npz")
    np.savez(npz, **{k: v.numpy() for k, v in init.items()})

    mesh = make_mesh(jax.devices("cpu")[:n])
    data = dryrun.leg_data(n)
    ds = JDeviceDataset(data, mesh, pixel_format="packed")
    step = jtrainer.make_train_step(jm, tx, mesh, mode="auto",
                                    pixel_format="packed")
    stream = JIndexStream(ds.train_n, 8 * n, seed=0, mesh=mesh)
    _, metrics = step(jax.device_put(state, replicated(mesh)), ds.train_x,
                      ds.train_y, stream.next_block(2))
    want = float(metrics["loss"])

    recs = dryrun.run_group_legs(n, "cpu", str(tmp_path), init_npz=npz)
    got = recs[0]["legs"]["dp:auto:packed+flat"]["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert recs[1]["legs"]["dp:auto:packed+flat"]["loss"] == got
    assert recs[0]["legs"]["dp+ckpt"]["steps"] == [2, 4]


def test_entry_is_lenet_on_the_device_asked_for():
    forward, (params, x) = dryrun.entry("cpu")
    assert x.shape == (8, 28, 28, 1) and x.device.type == "cpu"
    assert forward(params, x).shape == (8, 10)
    jm = jmodels.build("lenet", platform="cpu")
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    xs = np.random.default_rng(0).random((8, 28, 28, 1), dtype=np.float32)
    got = forward(interop.lenet_params_from_flax(
        jax.tree.map(np.asarray, jp)), torch.from_numpy(xs))
    want = jm.apply({"params": jp}, jnp.asarray(xs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu():
    assert not torch.cuda.is_available()
    for call in (dryrun.entry, lambda: dryrun.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
