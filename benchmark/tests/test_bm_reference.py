"""The plain reference agrees with the port at a tiny size on the CPU:
forward, loss, gradients, Adam and the batch order."""

import numpy as np
import pytest
import torch

from benchmark.harness import seeded
from benchmark.reference import lenet5, stream


@pytest.fixture(scope="module")
def setup():
    params = seeded.lenet_params(5, "cpu")
    data = seeded.mnist_tensors(5, "cpu", train_n=256, test_n=32)
    return params, data


def test_forward_matches_the_model(setup):
    from distributedmnist_tpu_torch.models.lenet import LeNet5

    params, data = setup
    net = LeNet5()
    net.load_state_dict(params)
    x = data["train_x"][:64]
    with torch.no_grad():
        want = net(x.to(torch.float32) / 255.0)
    got = lenet5.logits(params, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_loss_and_grads_match_autograd_of_the_model(setup):
    from distributedmnist_tpu_torch.models.lenet import LeNet5
    from distributedmnist_tpu_torch.ops.loss import cross_entropy

    params, data = setup
    x, y = data["train_x"][:64], data["train_y"][:64]
    net = LeNet5()
    net.load_state_dict(params)
    loss = cross_entropy(net(x.to(torch.float32) / 255.0), y)
    loss.backward()
    ref_loss, grads = lenet5.loss_and_grads(params, x, y)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    for name, p in net.named_parameters():
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-4,
                                   atol=1e-6)


def test_blocks_sum_to_the_batch_mean(setup, monkeypatch):
    params, data = setup
    x, y = data["train_x"][:64], data["train_y"][:64]
    whole, g1 = lenet5.loss_and_grads(params, x, y)
    monkeypatch.setattr(lenet5, "ROW_BLOCK", 16)
    blocked, g2 = lenet5.loss_and_grads(params, x, y)
    assert blocked == pytest.approx(whole, rel=1e-6)
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-5, atol=1e-7)


def test_adam_matches_torch(setup):
    params, data = setup
    batches = [(data["train_x"][i:i + 32], data["train_y"][i:i + 32])
               for i in (0, 32, 64)]
    ref = lenet5.adam_run(params, batches, lr=1e-3)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(leaves.values(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8, foreach=True)
    for x, y in batches:
        opt.zero_grad()
        _, g = lenet5.loss_and_grads({k: v.detach() for k, v in
                                      leaves.items()}, x, y)
        for k, v in leaves.items():
            v.grad = g[k]
        opt.step()
    for k in leaves:
        torch.testing.assert_close(ref["params"][k], leaves[k].detach(),
                                   rtol=1e-5, atol=1e-7)
    assert len(ref["losses"]) == 3


def test_batch_order_matches_the_index_stream():
    from distributedmnist_tpu_torch.data.loader import IndexStream

    seed = 2**33 + 7
    s = IndexStream(1000, 96, seed)
    block = s.host_block(25)              # crosses two epoch boundaries
    for step in range(25):
        np.testing.assert_array_equal(
            stream.batch_indices(1000, 96, seed, step), block[step])


def test_seeded_inputs_repeat():
    a = seeded.mnist(3, "cpu", 64, 8)
    b = seeded.mnist(3, "cpu", 64, 8)
    c = seeded.mnist(4, "cpu", 64, 8)
    assert a["train_x"].dtype == np.uint8 and a["train_x"].shape == (
        64, 28, 28, 1)
    assert a["train_y"].dtype == np.int32
    np.testing.assert_array_equal(a["train_x"], b["train_x"])
    assert not np.array_equal(a["train_x"], c["train_x"])
    p = seeded.lenet_params(2**40 + 3, "cpu")
    assert sum(v.numel() for v in p.values()) == 61_706
    assert set(p) == set(lenet5.NAMES)


def test_judge():
    from benchmark.harness import compare

    ok, checks = compare.judge({"a": 1e-6, "b": 0}, {"a": 1e-5, "b": 0})
    assert ok and checks["a"] == {"value": 1e-6, "limit": 1e-5}
    assert not compare.judge({"a": 2e-5}, {"a": 1e-5})[0]
    assert not compare.judge({"a": float("nan")}, {"a": 1e-5})[0]
    assert not compare.judge({}, {"a": 1e-5})[0]


def test_worst_leaf_against_the_median():
    from benchmark.harness import compare

    ref = {"a": torch.ones(4), "b": torch.full((4,), 1e-9),
           "c": torch.ones(4) * 2}
    prog = {"a": torch.ones(4) * 1.01, "b": torch.full((4,), 2e-9),
            "c": torch.ones(4) * 2}
    gap, leaf = compare.worst_leaf(prog, ref)
    # b's gap counts against the median leaf's norm, so it is tiny
    assert leaf == "a" and gap == pytest.approx(0.01, rel=1e-6)


def test_block_losses_follow_the_programs_order():
    from benchmark.traffic import train_fit

    losses = [float(i) for i in range(9)]
    assert train_fit.checked_steps({"steps_per_call": 4,
                                    "check_blocks": 2}) == 9
    assert train_fit.block_losses(losses, 4) == [0.0, 4.0, 2.5, 8.0, 6.5]
