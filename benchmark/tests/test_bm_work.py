"""LeNet-5's work counted from its shapes."""

import pytest

from benchmark.harness import work


def test_forward_macs_per_row():
    # conv1 117,600 + conv2 240,000 + 48,000 + 10,080 + 840
    assert work.forward_macs_per_row() == 416_520


def test_flops():
    assert work.flops(1, train=False) == 833_040
    # forward, weight gradients, input gradients but conv1's
    assert work.flops(1, train=True) == 833_040 * 3 - 2 * 117_600
    assert work.flops(4096, train=True) == 4096 * work.flops(1, True)


def test_bytes_and_bound():
    ops = dict((n, (f, b)) for n, f, b in work._ops(1, train=False))
    # conv1 reads the f32 image and writes 28x28x6 f32, plus its weights
    assert ops["conv1"][1] == 4 * (784 + 4704 + 156)
    assert ops["decode"][1] == 784 * 5
    assert ops["logits"][0] == 2 * 840
    b1, b2 = work.step_bound_s(1024, True), work.step_bound_s(2048, True)
    assert 0 < b1 < b2 < 2 * b1 + 1e-9
    assert work.step_bound_s(4096, False) < work.step_bound_s(4096, True)


def test_bound_is_max_of_two():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_train_ops_cover_every_layer():
    names = {n for n, _, _ in work._ops(8, train=True)}
    for layer in ("conv1", "conv2", "fc1", "fc2", "logits"):
        assert layer + ".dW" in names
    assert "conv1.dx" not in names and "conv2.dx" in names
    assert "adam" in names
