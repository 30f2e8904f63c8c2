"""The PyTorch port's kernel modules against the JAX package.

On the CPU every kernel wrapper of the port runs its plain PyTorch
version; these tests hand the same numpy inputs (seeded) to that version
and to the JAX package's Pallas kernel in interpret mode, at the MLP's
widths. The card's own tests, each kernel against its plain version,
are in test_torch_gpu.py.

Tolerances:
- float32: rtol=1e-5, atol=1e-5 (summation order differs);
- bfloat16: atol=2e-2 times the output scale, rtol=2e-2 — bf16 keeps 8
  bits of mantissa, so one rounding step is 2**-8 relative, and the two
  frameworks round the f32 accumulator at slightly different points;
- int8: the int32 accumulators exactly; the f32 epilogue rtol=1e-6.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.data import synthetic_mnist as jax_synthetic_mnist
from distributedmnist_tpu.ops import fused as jfused
from distributedmnist_tpu_torch.data import synthetic_mnist
from distributedmnist_tpu_torch.ops import fused, kernel_lib

ROWS = (1, 3, 128, 130)
K, HIDDEN, CLASSES = 784, 128, 10


def _rng(seed):
    return np.random.default_rng(seed)


def _dense_inputs(m, k, n, seed=0):
    r = _rng(seed)
    return (r.normal(size=(m, k)).astype(np.float32),
            (r.normal(size=(k, n)) * 0.05).astype(np.float32),
            r.normal(size=n).astype(np.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


# -- data -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 709])
def test_synthetic_mnist_byte_identical(seed):
    ours = synthetic_mnist(seed=seed, train_n=64, test_n=128)
    ref = jax_synthetic_mnist(seed=seed, train_n=64, test_n=128)
    for key in ("train_x", "train_y", "test_x", "test_y"):
        assert ours[key].dtype == ref[key].dtype
        assert ours[key].tobytes() == ref[key].tobytes(), key


# -- routing ----------------------------------------------------------------


def test_resolve_routes_by_device():
    assert fused.resolve("cpu") == fused.PLAIN
    assert fused.resolve(torch.device("cuda")) == fused.KERNEL
    with pytest.raises(ValueError, match="no fused-kernel route"):
        fused.resolve("meta")


def test_cpu_tensors_never_count_launches():
    fused.reset_launches()
    x, w, b = (_t(a) for a in _dense_inputs(4, 16, 8))
    fused.dense_relu(x, w, b)
    fused.mlp_megakernel(x, w, b, _t(np.ones((8, 3), np.float32)),
                         _t(np.zeros(3, np.float32)))
    fused.quant_dense(x.to(torch.int8), w.to(torch.int8), b, b)
    assert fused.LAUNCHES == {"dense_relu": 0, "quant_dense": 0,
                              "mlp_megakernel": 0}


def test_quant_dense_rejects_non_int8():
    with pytest.raises(TypeError, match="int8"):
        fused.quant_dense(torch.zeros((2, 3)),
                          torch.zeros((3, 4), dtype=torch.int8),
                          torch.ones(4), torch.zeros(4))


# -- dense_relu ---------------------------------------------------------------


@pytest.mark.parametrize("m", ROWS)
def test_dense_relu_f32_matches_jax(m):
    x, w, b = _dense_inputs(m, K, HIDDEN, seed=m)
    got = fused.dense_relu(_t(x), _t(w), _t(b)).numpy()
    kernel = np.asarray(jfused.dense_relu(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), True))
    oracle = np.asarray(jfused.dense_relu_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", ROWS)
def test_dense_relu_bf16_matches_jax(m):
    x, w, b = _dense_inputs(m, K, HIDDEN, seed=100 + m)
    got = fused.dense_relu(_t(x, torch.bfloat16), _t(w, torch.bfloat16),
                           _t(b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    kernel = np.asarray(jfused.dense_relu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), True)).astype(np.float32)
    scale = float(np.abs(kernel).max())
    np.testing.assert_allclose(got.float().numpy(), kernel, rtol=2e-2,
                               atol=2e-2 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_relu_grads_match_jax(dtype):
    """The autograd Function's plain-matmul backward against the JAX
    custom VJP's, both through the interpret-mode forward."""
    x, w, b = _dense_inputs(32, 64, 16, seed=7)
    tdt = getattr(torch, dtype)
    tx, tw, tb = (_t(a, tdt).requires_grad_() for a in (x, w, b))
    fused.dense_relu(tx, tw, tb).sum().backward()

    def f(x, w, b):
        return jfused.dense_relu(x, w, b, True).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w, b)))
    for got, ref in zip((tx.grad, tw.grad, tb.grad), want):
        assert got.dtype == tdt
        ref = np.asarray(ref).astype(np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5)
        else:
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                                       atol=2e-2 * scale)


# -- quant_dense ----------------------------------------------------------------


def _quant_inputs(m, k, n, seed):
    r = _rng(seed)
    return (r.integers(-128, 128, (m, k)).astype(np.int8),
            r.integers(-127, 128, (k, n)).astype(np.int8),
            (r.random(n) * 1e-3).astype(np.float32),
            r.normal(size=n).astype(np.float32))


# (k, n, relu): the MLP's two int8 layers, then LeNet's three int8 dense
# layers (distributedmnist_tpu/serve/quantize.py), and every x at -128
# with every w at -127 at k=784: the largest |acc|, 784*128*127.
QUANT_SHAPES = [(K, HIDDEN, True), (HIDDEN, CLASSES, False),
                (400, 120, True), (120, 84, True), (84, CLASSES, False),
                (K, HIDDEN, "extreme")]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n,relu", QUANT_SHAPES)
def test_quant_dense_matches_jax(m, k, n, relu):
    xq, wq, scale, b = _quant_inputs(m, k, n, seed=m * 7 + n)
    if relu == "extreme":
        xq, wq, relu = np.full_like(xq, -128), np.full_like(wq, -127), False
    # accumulators: unit scale and zero bias expose acc itself (|acc| <
    # 2**24, so its f32 image is exact)
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    acc = fused.quant_dense(_t(xq), _t(wq), _t(ones), _t(zeros),
                            relu=False).numpy()
    jacc = np.asarray(jax.lax.dot_general(
        jnp.asarray(xq), jnp.asarray(wq), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(acc.astype(np.int64), jacc)
    if (xq == -128).all() and (wq == -127).all():
        assert (jacc == k * 128 * 127).all()
    got = fused.quant_dense(_t(xq), _t(wq), _t(scale), _t(b),
                            relu=relu).numpy()
    ref = np.asarray(jfused.quant_dense(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
        jnp.asarray(b), relu=relu, mode=jfused.PALLAS_INTERPRET))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# -- mlp_megakernel ---------------------------------------------------------------


@pytest.mark.parametrize("m", ROWS)
def test_mlp_megakernel_matches_jax(m):
    r = _rng(300 + m)
    x = r.integers(0, 256, (m, K)).astype(np.float32)   # raw pixels
    w1 = (r.normal(size=(K, HIDDEN)) * 0.05 / 255).astype(np.float32)
    b1 = r.normal(size=HIDDEN).astype(np.float32) * 0.1
    w2 = (r.normal(size=(HIDDEN, CLASSES)) * 0.1).astype(np.float32)
    b2 = r.normal(size=CLASSES).astype(np.float32)
    got = fused.mlp_megakernel(*(_t(a) for a in (x, w1, b1, w2, b2)))
    ref = np.asarray(jfused.mlp_megakernel(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
        mode=jfused.PALLAS_INTERPRET))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# -- the C interface the wrappers bind ------------------------------------------


def test_kernel_sources_export_the_bound_signatures():
    """Every ctypes signature the wrappers set names an extern "C" entry
    point of its source with the same number of arguments, and every
    source builds for sm_90a."""
    assert "arch=compute_90a,code=sm_90a" in kernel_lib.NVCC_FLAGS
    for source, fns in kernel_lib.SIGNATURES.items():
        text = (kernel_lib.CSRC / source).read_text()
        assert 'extern "C" const char* kernel_error_string(int' in text
        for name, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
            assert m, (source, name)
            assert len(m.group(1).split(",")) == len(argtypes), name
