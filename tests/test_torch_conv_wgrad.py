"""LeNet's conv1 weight gradient (ops/conv.Conv1chWgrad, the backward
through ops/fused.conv_wgrad_1ch) on the CPU.

On the CPU the Function's backward runs the plain version, the one op
autograd runs for F.conv2d (aten.convolution_backward, input gradient
masked off), so its dW and db, and a LeNet-5 step's gradients, are the
F.conv2d path's bit for bit. conv2d takes the route only for a float32
SAME convolution of one-channel images with an odd square kernel that
needs a gradient, under grad mode, from an input that needs none:
conv2's shape, bfloat16, VALID, an input that needs a gradient, a
kernel that needs none and no-grad serving keep F.conv2d. On a CUDA
tensor the wrapper checks dtype, contiguity and shape before anything
launches, and raises on what the kernel does not take (fake CUDA
tensors: the check needs no card). The kernel itself is held against
the plain version on the card, in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distributedmnist_tpu_torch import models
from distributedmnist_tpu_torch.ops import conv, fused
from distributedmnist_tpu_torch.ops.loss import cross_entropy


def _conv1_inputs(b, seed=0):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.random((b, 28, 28, 1), dtype=np.float32))
    k = torch.from_numpy(
        (r.normal(size=(5, 5, 1, 6)) * 0.2).astype(np.float32))
    bias = torch.from_numpy(r.normal(size=6).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(b, 28, 28, 6)).astype(np.float32))
    return x, k.requires_grad_(), bias.requires_grad_(), w


def _grads(fn, x, k, bias, w):
    """dW and db of sum(relu(fn(x, k, bias)) * w)."""
    k.grad = bias.grad = None
    (torch.relu(fn(x, k, bias)) * w).sum().backward()
    return k.grad.clone(), bias.grad.clone()


@pytest.mark.parametrize("b", (1, 7, 64))
def test_function_grads_are_autograds_bit_for_bit_on_cpu(b):
    x, k, bias, w = _conv1_inputs(b, seed=b)
    want = _grads(lambda *a: conv._conv(*a, "SAME"), x, k, bias, w)
    got = _grads(conv.Conv1chWgrad.apply, x, k, bias, w)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert got[0].shape == (5, 5, 1, 6) and got[1].shape == (6,)


def test_lenet_step_gradients_unchanged_on_cpu(monkeypatch):
    """A LeNet-5 step's every gradient, through conv2d's route and with
    the route closed, the same bits."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.random((16, 28, 28, 1), dtype=np.float32))
    y = torch.from_numpy(r.integers(0, 10, 16))
    net = models.build("lenet", device="cpu")
    net.load_state_dict(models.init_params("lenet", 0))
    runs = []
    for route in (True, False):
        if not route:
            monkeypatch.setattr(conv, "takes_conv1ch_wgrad",
                                lambda *a: False)
        net.zero_grad(set_to_none=True)
        cross_entropy(net(x), y).backward()
        runs.append({n: p.grad.clone() for n, p in net.named_parameters()})
    assert all(torch.equal(runs[0][n], runs[1][n]) for n in runs[1])


# name -> (x, kernel, padding, dtype, x needs grad, kernel needs grad,
# grad mode, takes the route)
ROUTE_CASES = {
    "conv1": ((4, 28, 28, 1), (5, 5, 1, 6), "SAME", torch.float32,
              False, True, True, True),
    "conv1_3x3": ((4, 9, 9, 1), (3, 3, 1, 4), "SAME", torch.float32,
                  False, True, True, True),
    "conv2": ((4, 14, 14, 6), (5, 5, 6, 16), "VALID", torch.float32,
              True, True, True, False),
    "conv2_data": ((4, 14, 14, 6), (5, 5, 6, 16), "SAME", torch.float32,
                   False, True, True, False),
    "bfloat16": ((4, 28, 28, 1), (5, 5, 1, 6), "SAME", torch.bfloat16,
                 False, True, True, False),
    "valid": ((4, 28, 28, 1), (5, 5, 1, 6), "VALID", torch.float32,
              False, True, True, False),
    "input_needs_grad": ((4, 28, 28, 1), (5, 5, 1, 6), "SAME",
                         torch.float32, True, True, True, False),
    "frozen_kernel": ((4, 28, 28, 1), (5, 5, 1, 6), "SAME", torch.float32,
                      False, False, True, False),
    "no_grad_serving": ((4, 28, 28, 1), (5, 5, 1, 6), "SAME",
                        torch.float32, False, True, False, False),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_route_is_taken_only_for_a_trained_one_channel_same_conv(
        name, monkeypatch):
    xs, ks, padding, dtype, x_grad, k_grad, grad_mode, routed = \
        ROUTE_CASES[name]
    calls = []
    real = fused.conv_wgrad_1ch

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(fused, "conv_wgrad_1ch", spy)
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.random(xs, dtype=np.float32)).to(dtype)
    k = torch.from_numpy(r.normal(size=ks).astype(np.float32)).to(dtype)
    b = torch.zeros(ks[3], dtype=dtype)
    x.requires_grad_(x_grad)
    k.requires_grad_(k_grad)
    with torch.set_grad_enabled(grad_mode):
        out = conv.conv2d(x, k, b, padding)
        want = conv._conv(x, k, b, padding)
        assert torch.equal(out, want)
        assert conv.takes_conv1ch_wgrad(x, k, padding) == routed
        if out.requires_grad:
            out.float().square().sum().backward()
    assert len(calls) == int(routed)
    assert fused.LAUNCHES["conv_wgrad_1ch"] == 0      # the CPU: plain


def test_lenet_serving_forward_keeps_f_conv2d(monkeypatch):
    """LeNet-5's forward under inference_mode (the f32 serving engine's)
    and under no_grad (eval) never reaches the Function."""
    monkeypatch.setattr(conv.Conv1chWgrad, "apply",
                        lambda *a: pytest.fail("routed"))
    net = models.build("lenet", device="cpu")
    x = torch.zeros((2, 28, 28, 1))
    with torch.inference_mode():
        net(x)
    with torch.no_grad():
        net(x)


def _fake_cuda(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


@pytest.mark.parametrize("x,g,k", (
    ((8, 28, 28, 1), (8, 28, 28, 6), (3, 3, 1, 6)),      # another kernel
    ((8, 32, 32, 1), (8, 32, 32, 6), (5, 5, 1, 6)),      # another image
    ((8, 28, 28, 1), (8, 28, 28, 4), (5, 5, 1, 4)),      # 4 filters
    ((8, 28, 28, 1), (4, 28, 28, 6), (5, 5, 1, 6)),      # rows differ
    ((0, 28, 28, 1), (0, 28, 28, 6), (5, 5, 1, 6)),      # no rows
    ((8, 28, 28, 2), (8, 28, 28, 6), (5, 5, 2, 6)),      # 2 channels
))
def test_kernel_wrapper_refuses_shapes_it_does_not_take_on_cuda(x, g, k):
    with FakeTensorMode():
        args = _fake_cuda(x, g, k)
        with pytest.raises(ValueError, match="conv_wgrad_1ch takes"):
            fused.conv_wgrad_1ch(*args)
    assert fused.LAUNCHES["conv_wgrad_1ch"] == 0


def test_kernel_wrapper_refuses_other_dtypes_on_cuda():
    with FakeTensorMode():
        args = _fake_cuda((8, 28, 28, 1), (8, 28, 28, 6), (5, 5, 1, 6),
                          dtype=torch.bfloat16)
        with pytest.raises(TypeError, match="dtype"):
            fused.conv_wgrad_1ch(*args)


def test_plain_version_is_f_conv2ds_weight_gradient():
    """The plain version against torch.nn.grad's weight gradient and the
    gradient's sum, in float64 (the same sums, another order)."""
    x, k, _, w = _conv1_inputs(5, seed=11)
    dw, db = fused.conv_wgrad_1ch_reference(x.double(), w.double(),
                                            k.detach().double())
    want = torch.nn.grad.conv2d_weight(
        x.double().permute(0, 3, 1, 2), (6, 1, 5, 5),
        w.double().permute(0, 3, 1, 2), padding=2).permute(2, 3, 1, 0)
    torch.testing.assert_close(dw, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, w.double().sum(dim=(0, 1, 2)),
                               rtol=1e-12, atol=1e-12)
