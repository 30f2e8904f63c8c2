"""The PyTorch port's hand-written CUDA kernels against their plain
PyTorch versions, on the card: at the serving path's shapes (buckets 1,
7, 128 and 512), at the training path's (a step's 64 rows, an eval
batch's 2048), at the ragged K slices of the split-K kernels and at
LeNet's dense and int8 dense shapes, at rows that do not start on a
16-byte boundary, at quant_dense's largest accumulator, and two calls on
the same inputs bit for bit. Then the training path: the pixel decode
bit for bit against the CPU's, an MLP training step through the kernel
against the same step through the plain version, and a LeNet step on the
card against the same step on the CPU. Then LeNet serving: each
precision's engine on the card against the same engine on the CPU (the
plain versions), and the int8 dense stack bit for bit. Then the
bench's throughput mode through dense_relu, the HTTP server booted on
the card answering one /predict, and last config 3's MLP as 2
data-parallel ranks sharing the card over gloo (DDP against the
hand-written all-reduce, losses within 1e-6). Then the rest of training:
dense_relu at a tensor-parallel rank's column shard (N = 64 and 32), the
MLP and LeNet-5 at model_parallel 2 as 2 ranks sharing the card against
1 rank (losses rtol 1e-4, as 2 data-parallel ranks are held), config 1
in bfloat16 through the bf16 kernel, and the streaming pipeline against
the device-resident one (losses within 1e-6). Then the fast lane: each
serving engine's exact-fit route, directly and through a batcher with
the lane on, bit for bit the pooled dispatch at bucket 1, and the
row-staged route on a dirty resident buffer bit for bit the pooled
dispatch. Then tenancy: the MLP and LeNet-5 in one catalog behind the
global scheduler, each model's engines on a CUDA stream of their own,
every batch bit for bit its model's own router's dispatch and the skip
bound held. Every test is marked `gpu` and skips without a card.

This file imports no jax (the card's machine has none), and
tests/conftest.py does, so on the card run it without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: float32 rtol=1e-5, atol=1e-5 (the plain version's cuBLAS
product sums in another order; TF32 is off), the megakernel's atol times
the logits' scale where it exceeds 1 (its sums are of raw pixels, which
run to 255); bfloat16 rtol=2e-2 and atol=2e-2 times the output scale
(one bf16 rounding is 2**-8 relative); int8 rtol=1e-6, atol=0 (exact
int32 products, epilogues rounded alike). Training steps: the MLP's
loss rtol=1e-4 and params atol=1e-4 after 5 SGD steps (chip_smoke.py's
tolerance); LeNet's loss rtol=1e-5 and gradients atol=1e-4 times their
scale (cuDNN's and the CPU's convolutions sum in other orders, by
algorithms of cuDNN's choosing, TF32 off), params atol=2*lr after its Adam step (Adam moves a weight whose
gradient is a rounding residue by up to lr). LeNet serving, atol times
the logits' scale: float32 1e-4 (cuDNN's sums in other orders, TF32
off); bfloat16 3e-2 (cuDNN and the CPU round the bf16 convolutions at
other points); int8 5e-3 (a float32 trunk summed in another order can
move a quantized activation across a rounding boundary), its dense stack
on a shared input exact.
"""

import json

import numpy as np
import pytest
import torch

from distributedmnist_tpu_torch import models, optim, trainer
from distributedmnist_tpu_torch.data import mnist, packing
from distributedmnist_tpu_torch.models.mlp import MLP
from distributedmnist_tpu_torch.ops import fused
from distributedmnist_tpu_torch.ops.loss import cross_entropy
from distributedmnist_tpu_torch.utils.device import float32_numerics

K, HIDDEN, CLASSES = 784, 128, 10


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def _dense_inputs(m, k, n, seed=0):
    r = _rng(seed)
    return (r.normal(size=(m, k)).astype(np.float32),
            (r.normal(size=(k, n)) * 0.05).astype(np.float32),
            r.normal(size=n).astype(np.float32))


def _quant_inputs(m, k, n, seed):
    r = _rng(seed)
    return (r.integers(-128, 128, (m, k)).astype(np.int8),
            r.integers(-127, 128, (k, n)).astype(np.int8),
            (r.random(n) * 1e-3).astype(np.float32),
            r.normal(size=n).astype(np.float32))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")


def _cuda(*arrays, dtype=None):
    return [(_t(a, dtype) if dtype is not None else _t(a)).cuda()
            for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("m", (1, 7, 128, 512))
def test_dense_relu_kernel_on_card(m):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = _cuda(*_dense_inputs(m, K, HIDDEN, seed=m))
    before = fused.LAUNCHES["dense_relu"]
    got = fused.dense_relu_inference(x, w, b)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["dense_relu"] == before + 1
    torch.testing.assert_close(got, fused.dense_relu_reference(x, w, b),
                               rtol=1e-5, atol=1e-5)
    xb, wb, bb = (t.bfloat16() for t in (x, w, b))
    got16 = fused.dense_relu_inference(xb, wb, bb).float()
    ref16 = fused.dense_relu_reference(xb, wb, bb).float()
    scale = float(ref16.abs().max())
    torch.testing.assert_close(got16, ref16, rtol=2e-2, atol=2e-2 * scale)


# (k, n, relu): the MLP's two int8 layers, LeNet's three int8 dense
# layers (rows of 120, 84 and 10 bytes: the masked byte copies), and a
# ragged k and n
QUANT_SHAPES = ((K, HIDDEN, True), (HIDDEN, CLASSES, False),
                (400, 120, True), (120, 84, True), (84, CLASSES, False),
                (83, 5, True))


def _check_quant(xq, wq, scale, b, relu):
    before = fused.LAUNCHES["quant_dense"]
    got = fused.quant_dense(xq, wq, scale, b, relu=relu)
    ref = fused.quant_dense_reference(xq, wq, scale, b, relu=relu)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["quant_dense"] == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,relu", QUANT_SHAPES)
@pytest.mark.parametrize("m", (1, 3, 17, 128, 512, 2048))
def test_quant_dense_kernel_on_card(m, k, n, relu):
    _need_card()
    _check_quant(*_cuda(*_quant_inputs(m, k, n, seed=m * 1000 + k + n)),
                 relu)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", ((K, HIDDEN), (400, 120), (HIDDEN, CLASSES)))
def test_quant_dense_unaligned_rows_on_card(k, n):
    """x that does not start on a 16-byte boundary takes the masked byte
    copy instead of cp.async."""
    _need_card()
    xq, wq, scale, b = _cuda(*_quant_inputs(33, k, n, seed=k + n))
    shifted = torch.empty(xq.numel() + 1, dtype=torch.int8,
                          device=xq.device)[1:].view(xq.shape)
    shifted.copy_(xq)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _check_quant(shifted, wq, scale, b, True)


@pytest.mark.gpu
@pytest.mark.parametrize("m", (1, 128, 512))
def test_quant_dense_extreme_values_on_card(m):
    """Every x at -128 and every w at -127 at k=784: the largest |acc|,
    784*128*127 = 12,744,704, exact (unit scale, zero bias)."""
    _need_card()
    xq = torch.full((m, K), -128, dtype=torch.int8, device="cuda")
    wq = torch.full((K, HIDDEN), -127, dtype=torch.int8, device="cuda")
    ones = torch.ones(HIDDEN, device="cuda")
    zeros = torch.zeros(HIDDEN, device="cuda")
    got = fused.quant_dense(xq, wq, ones, zeros, relu=False)
    torch.cuda.synchronize()
    assert (got == float(K * 128 * 127)).all()
    _check_quant(xq, wq, torch.rand(HIDDEN, device="cuda") * 1e-3, zeros,
                 True)


@pytest.mark.gpu
@pytest.mark.parametrize("m", (1, 7, 128, 512))
def test_mlp_megakernel_on_card(m):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    r = _rng(m)
    x = r.integers(0, 256, (m, K)).astype(np.float32)
    w1 = (r.normal(size=(K, HIDDEN)) * 0.05 / 255).astype(np.float32)
    b1 = r.normal(size=HIDDEN).astype(np.float32) * 0.1
    w2 = (r.normal(size=(HIDDEN, CLASSES)) * 0.1).astype(np.float32)
    b2 = r.normal(size=CLASSES).astype(np.float32)
    args = _cuda(x, w1, b1, w2, b2)
    got = fused.mlp_megakernel(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused.mlp_megakernel_reference(*args),
                               rtol=1e-5, atol=1e-5)


# (k, n): the MLP's hidden layer, then LeNet's dense stack (400->120->84)
# and a K that is neither a multiple of a stage nor of 8 (the bf16
# 16-byte chunk), with a width of 10 (no 16-byte rows at all). m=2048
# reaches the 64x64 tile in bf16 too.
DENSE_SHAPES = ((K, HIDDEN), (400, 120), (120, 84), (100, CLASSES))


def _check_dense(x, w, b):
    """The kernel against its plain version at the header's tolerance."""
    got = fused.dense_relu_inference(x, w, b)
    ref = fused.dense_relu_reference(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == ref.shape
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        scale = max(1.0, float(ref.float().abs().max()))
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("k,n", DENSE_SHAPES)
@pytest.mark.parametrize("m", (1, 3, 17, 128, 512, 2048))
def test_dense_relu_shapes_on_card(m, k, n, dtype):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    _check_dense(*_cuda(*_dense_inputs(m, k, n, seed=m * 1000 + k + n),
                        dtype=getattr(torch, dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_dense_relu_unaligned_rows_on_card(dtype):
    """x whose rows do not start on 16-byte boundaries takes the masked
    element-wise copy instead of cp.async."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = getattr(torch, dtype)
    x, w, b = _cuda(*_dense_inputs(33, K, HIDDEN, seed=5), dtype=tdt)
    shifted = torch.empty(x.numel() + 1, dtype=tdt, device=x.device)
    shifted = shifted[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _check_dense(shifted, w, b)


def _mega_inputs(m, k, seed):
    r = _rng(seed)
    return (r.integers(0, 256, (m, k)).astype(np.float32),
            (r.normal(size=(k, HIDDEN)) * 0.05 / 255).astype(np.float32),
            r.normal(size=HIDDEN).astype(np.float32) * 0.1,
            (r.normal(size=(HIDDEN, CLASSES)) * 0.1).astype(np.float32),
            r.normal(size=CLASSES).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("k", (K, 100))
@pytest.mark.parametrize("m", (1, 7, 9, 33, 512))
def test_mlp_megakernel_shapes_on_card(m, k):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _cuda(*_mega_inputs(m, k, seed=m + k))
    got = fused.mlp_megakernel(*args)
    ref = fused.mlp_megakernel_reference(*args)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("m", (1, 128, 512))
@pytest.mark.parametrize("kernel", ("dense_relu_f32", "dense_relu_bf16",
                                    "mlp_megakernel", "quant_dense"))
def test_split_k_kernels_deterministic_on_card(kernel, m):
    """The cluster reduction sums partials in a fixed rank order: two calls
    on the same inputs give the same bits."""
    _need_card()
    if kernel == "mlp_megakernel":
        args = _cuda(*_mega_inputs(m, K, seed=m))
        fn = fused.mlp_megakernel
    elif kernel == "quant_dense":
        args = _cuda(*_quant_inputs(m, K, HIDDEN, seed=m))
        fn = fused.quant_dense
    else:
        dtype = torch.float32 if kernel.endswith("f32") else torch.bfloat16
        args = _cuda(*_dense_inputs(m, K, HIDDEN, seed=m), dtype=dtype)
        fn = fused.dense_relu_inference
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# -- the training path --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m", (64, 2048))
def test_dense_relu_training_shapes_on_card(m):
    """A config-1 step's batch (64) and an eval batch (2048), f32."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = _cuda(*_dense_inputs(m, K, HIDDEN, seed=m + 7))
    x = (x.abs() / 4).clamp(max=1.0).contiguous()     # pixel-like inputs
    before = fused.LAUNCHES["dense_relu"]
    _check_dense(x, w, b)
    assert fused.LAUNCHES["dense_relu"] == before + 1


@pytest.mark.gpu
def test_pixel_decode_on_card_is_bit_identical():
    _need_card()
    x = mnist.synthetic_mnist(seed=0, train_n=16, test_n=64)["test_x"]
    words = packing.pack_rows(x)
    for fn, a in ((packing.normalize, x), (packing.unpack_rows, words)):
        got = fn(_t(a).cuda()).cpu()
        assert torch.equal(got.view(torch.int32),
                           fn(_t(a)).view(torch.int32))


class _PlainMLP(MLP):
    """The port's MLP with its hidden layer through the plain version of
    dense_relu (autograd's own backward) instead of the kernel."""

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        h = fused.dense_relu_reference(x, self.hidden_kernel,
                                       self.hidden_bias)
        return h @ self.logits_kernel + self.logits_bias


def _steps(net, name, lr, data, idx, pixel_format="packed"):
    opt, sched = optim.build(name, net.parameters(), optim.make_schedule(lr))
    step = trainer.make_train_step(net, opt, sched, pixel_format)
    dev = next(net.parameters()).device
    x = _t(packing.pack_rows(data["train_x"]) if pixel_format == "packed"
           else data["train_x"]).to(dev)
    y = _t(data["train_y"]).long().to(dev)
    losses = [float(step(x, y, _t(i).long().to(dev))) for i in idx]
    return losses, {k: v.detach().cpu() for k, v in net.state_dict().items()}


@pytest.mark.gpu
def test_mlp_training_step_kernel_against_plain_on_card():
    _need_card()
    data = mnist.synthetic_mnist(seed=1, train_n=1024, test_n=16)
    idx = np.random.default_rng(0).integers(0, 1024, (5, 64))
    runs = []
    with float32_numerics():
        for net in (models.build("mlp", device="cuda"),
                    _PlainMLP(device="cuda")):
            net.load_state_dict(models.init_params("mlp", 0))
            before = fused.LAUNCHES["dense_relu"]
            runs.append(_steps(net, "sgd", 0.02, data, idx))
            launched = fused.LAUNCHES["dense_relu"] - before
            assert launched == (0 if isinstance(net, _PlainMLP) else 5)
    (lk, pk), (lp, pp) = runs
    np.testing.assert_allclose(lk, lp, rtol=1e-4)
    for k in pp:
        torch.testing.assert_close(pk[k], pp[k], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_lenet_training_step_on_card_against_cpu():
    _need_card()
    data = mnist.synthetic_mnist(seed=1, train_n=1024, test_n=16)
    idx = np.random.default_rng(0).integers(0, 1024, (1, 128))
    x = packing.unpack_rows(_t(packing.pack_rows(data["train_x"]))[idx[0]])
    y = _t(data["train_y"]).long()[idx[0]]
    grads, runs = [], []
    with float32_numerics():
        for dev in ("cuda", "cpu"):
            net = models.build("lenet", device=dev)
            net.load_state_dict(models.init_params("lenet", 0))
            loss = cross_entropy(net(x.to(dev)), y.to(dev))
            loss.backward()
            grads.append((float(loss), {k: p.grad.cpu() for k, p in
                                        net.named_parameters()}))
            net.zero_grad()
            runs.append(_steps(net, "adam", 1e-3, data, idx))
    (lc, gc), (lh, gh) = grads
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for k in gh:
        scale = max(1e-3, float(gh[k].abs().max()))
        torch.testing.assert_close(gc[k], gh[k], rtol=0, atol=1e-4 * scale)
    for k in runs[1][1]:
        torch.testing.assert_close(runs[0][1][k], runs[1][1][k], rtol=0,
                                   atol=2e-3)


LENET_SERVE_TOL = {"float32": 1e-4, "bfloat16": 3e-2, "int8": 5e-3}
# kernel launches of one forward of each precision
LENET_SERVE_LAUNCHES = {"float32": {}, "bfloat16": {"dense_relu": 2},
                        "int8": {"quant_dense": 3}}


@pytest.mark.gpu
@pytest.mark.parametrize("infer_dtype", ("float32", "bfloat16", "int8"))
def test_lenet_serving_engine_on_card_against_cpu(infer_dtype):
    _need_card()
    from distributedmnist_tpu_torch.serve import InferenceEngine

    torch.backends.cudnn.allow_tf32 = True     # the engine must pin it off
    params = models.init_params("lenet", 0)
    card = InferenceEngine("lenet", params, device="cuda", max_batch=512,
                           infer_dtype=infer_dtype)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    plain = InferenceEngine("lenet", params, device="cpu", max_batch=512,
                            infer_dtype=infer_dtype)
    x = mnist.synthetic_mnist(seed=3, train_n=16, test_n=512)["test_x"]
    for m in (1, 7, 128, 512):
        before = dict(fused.LAUNCHES)
        got = card.infer(x[:m])
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before
                    if fused.LAUNCHES[k] != before[k]}
        assert launched == LENET_SERVE_LAUNCHES[infer_dtype]
        want = plain.infer(x[:m])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(
            got, want, rtol=0, atol=LENET_SERVE_TOL[infer_dtype] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("m", (1, 7, 128, 512))
def test_lenet_int8_dense_stack_on_card_is_exact(m):
    _need_card()
    from distributedmnist_tpu_torch.serve import quantize

    prep, _ = quantize.prepare_inference(
        "lenet", models.init_params("lenet", 1), "int8")
    x = quantize.lenet_trunk(prep, _t(mnist.synthetic_mnist(
        seed=4, train_n=16, test_n=m)["test_x"][:m]).float())
    want = quantize.lenet_int8_dense_stack(prep, x)
    card = {k: v.cuda() for k, v in prep.items()}
    got = quantize.lenet_int8_dense_stack(card, x.cuda()).cpu()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_bench_throughput_launches_dense_relu_on_card(capsys):
    """The bench's throughput mode at --model mlp, a tiny window: one
    record measured on the card, its steps through dense_relu."""
    _need_card()
    from distributedmnist_tpu_torch import bench

    fused.reset_launches()
    assert bench.main(["throughput", "--model", "mlp", "--global-batch",
                       "64", "--steps-per-call", "4", "--warmup-steps",
                       "4", "--bench-steps", "8", "--repeats", "1",
                       "--inline"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "train_images_per_sec_per_chip"
    assert rec["value"] > 0 and rec["detail"]["backend"] == "cuda"
    assert rec["detail"]["bench_steps"] == 8
    # the warmup block and two timed blocks of 4 steps, one launch a step
    assert fused.LAUNCHES["dense_relu"] >= 12


@pytest.mark.gpu
def test_http_server_answers_predict_on_card():
    """`python -m distributedmnist_tpu_torch.serve --port 0` on the card
    (its default device): /healthz turns 200 with the card's name, one
    3-row /predict answers the CPU model's classes, and SIGTERM exits 0
    with a serve_summary and dense_relu launches on stderr."""
    _need_card()
    import os
    import sys

    from distributedmnist_tpu_torch.serve.process import ServerProcess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    srv = ServerProcess(
        [sys.executable, "-m", "distributedmnist_tpu_torch.serve",
         "--model", "mlp", "--serve-max-batch", "16", "--port", "0",
         "--seed", "3"], env=env, cwd=repo, ready_timeout=300)
    try:
        health = srv.wait_for("/healthz 200", srv.healthy_payload)
        assert health["backend"] == "cuda"
        assert health["device_kind"] == torch.cuda.get_device_name(0)
        x = _rng(3).integers(0, 256, (3, 784), dtype=np.uint8)
        got = srv.ok("/predict", data=x.tobytes(), timeout=60)
    finally:
        done = srv.stop()
    assert done.rc == 0, done.stderr
    assert any(r.get("metric") == "serve_summary" for r in done.records)
    net = models.build("mlp", device="cpu")
    net.load_state_dict(models.init_params("mlp", 3))
    with torch.no_grad():
        want = net(torch.from_numpy(x).float() / 255.0).argmax(-1).tolist()
    assert got["n"] == 3 and got["version"] == health["live_version"]
    assert got["classes"] == want
    assert len(done.launches) == 1 and done.launches[0]["dense_relu"] > 0


@pytest.mark.gpu
def test_two_ranks_share_the_card_over_gloo(tmp_path):
    """Config 3's MLP as 2 ranks on cuda:0 (parallel/mh_smoke.py): the
    ranks share the card, so the backend is gloo and the summary counts
    one chip for two processes; DDP (auto) and the
    hand-written all-reduce (explicit) give the same losses within 1e-6,
    every rank reports the same global run, and each launched dense_relu
    for each of its steps and its eval batch."""
    _need_card()
    from torch_dp_util import collect, spawn_smoke

    steps = 5
    runs = [{"spmd_mode": "auto"}, {"spmd_mode": "explicit"}]
    recs, logs = collect(spawn_smoke(
        2, str(tmp_path), runs,
        ("--device", "cuda", "--preset", "mlp-dp2", "--steps", str(steps)),
        env_extra={"CUDA_VISIBLE_DEVICES": "0"}), len(runs))
    assert "dist: backend gloo, 2 ranks on 1 card(s)" in logs[0]
    for rank in recs:
        for rec, first in zip(rank, recs[0]):
            assert rec["backend"] == "gloo"
            assert (rec["n_chips"], rec["n_processes"]) == (1, 2)
            assert rec["steps"] == steps and not rec["jax_loaded"]
            assert rec["losses"] == first["losses"]
            assert rec["launches"]["dense_relu"] >= steps + 1
    np.testing.assert_allclose(recs[0][1]["losses"], recs[0][0]["losses"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_ranks_on_their_own_cards_over_nccl(tmp_path):
    """On a machine with 2 or more cards, config 3's MLP as one rank a
    card (up to 4) over NCCL: 20 steps in both SPMD modes, against each
    other (1e-6) and against the same steps on one rank in this process
    (losses rtol 1e-4, as chip_smoke.py holds 2 ranks sharing a card)."""
    _need_card()
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs 2 or more cards: one rank a card")
    from distributedmnist_tpu_torch.parallel import mh_smoke
    from torch_dp_util import launch_smoke

    steps = 20
    runs = [{"spmd_mode": m, "learning_rate": 0.02} for m in
            ("auto", "explicit")]
    recs, logs = launch_smoke(
        n, str(tmp_path), runs,
        ("--device", "cuda", "--preset", "mlp-dp2", "--steps", str(steps)))
    assert f"dist: backend nccl, {n} ranks on {n} card(s)" in logs[0]
    for rank in recs:
        for rec, first in zip(rank, recs[0]):
            assert rec["backend"] == "nccl" and rec["n_chips"] == n
            assert rec["losses"] == first["losses"]
    one = mh_smoke.run(mh_smoke.smoke_config(
        "mlp-dp2", device="cuda", steps=steps, learning_rate=0.02),
        mh_smoke.smoke_data())
    auto, explicit = recs[0]
    np.testing.assert_allclose(explicit["losses"], auto["losses"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(auto["losses"], one["losses"], rtol=1e-4)


# -- the rest of training -----------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", (64, 32))
@pytest.mark.parametrize("m", (32, 64, 128, 1024, 2048))
def test_dense_relu_at_a_column_shard_on_card(m, n):
    """f32 at N = 128/mp (mp 2 and 4): a tensor-parallel rank's hidden
    layer, at its step and eval rows."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = _cuda(*_dense_inputs(m, K, n, seed=m + n))
    x = (x.abs() / 4).clamp(max=1.0).contiguous()
    before = fused.LAUNCHES["dense_relu"]
    _check_dense(x, w, b)
    assert fused.LAUNCHES["dense_relu"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("model", ("mlp", "lenet"))
def test_tensor_parallel_ranks_share_the_card(tmp_path, model):
    """model_parallel 2 as 2 ranks on cuda:0 over gloo: both ranks report
    the same run at model_parallel 2, each MLP rank launched dense_relu on
    its columns for each step and its eval batch, and the losses are the
    1-rank run's within rtol 1e-4."""
    _need_card()
    from distributedmnist_tpu_torch.parallel import mh_smoke
    from torch_dp_util import collect, spawn_smoke

    steps = 10
    spec = ({"learning_rate": 0.02} if model == "mlp" else
            {"model": "lenet", "optimizer": "adam", "learning_rate": 1e-3})
    recs, logs = collect(spawn_smoke(
        2, str(tmp_path), [{"model_parallel": 2, **spec}],
        ("--device", "cuda", "--preset", "mlp-dp2", "--steps", str(steps)),
        env_extra={"CUDA_VISIBLE_DEVICES": "0"}), 1)
    assert "dist: backend gloo, 2 ranks on 1 card(s)" in logs[0]
    for (rec,) in recs:
        assert rec["model_parallel"] == 2 and rec["backend"] == "gloo"
        assert rec["losses"] == recs[0][0]["losses"]
        if model == "mlp":
            assert rec["launches"]["dense_relu"] >= steps + 1
    with float32_numerics():
        one = mh_smoke.run(mh_smoke.smoke_config(
            "mlp-dp2", device="cuda", steps=steps, **spec),
            mh_smoke.smoke_data())
    np.testing.assert_allclose(recs[0][0]["losses"], one["losses"],
                               rtol=1e-4)


@pytest.mark.gpu
def test_bfloat16_config1_runs_the_bf16_kernel():
    """Config 1 in bfloat16 on the card: the hidden layer's params are
    bf16 and every step and eval batch goes through dense_relu (bf16, the
    only dtype it can take them in); the loss falls."""
    _need_card()
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.utils import MetricsLogger

    data = mnist.synthetic_mnist(seed=0, train_n=4096, test_n=512)
    cfg = PRESETS["mlp-sgd"].replace(
        synthetic=True, learning_rate=0.02, steps=60, eval_every=60,
        log_every=10, steps_per_call=10, target_accuracy=None,
        dtype="bfloat16")
    fused.reset_launches()
    mlog = MetricsLogger()
    out = trainer.fit(cfg, data=data, log=mlog)
    losses = [r["loss"] for r in mlog.history if "loss" in r]
    assert out["steps"] == 60 and losses[-1] < losses[0]
    assert fused.LAUNCHES["dense_relu"] >= 60 + 1


@pytest.mark.gpu
def test_streaming_pipeline_matches_the_device_pipeline_on_card():
    """Config 1 through --data-pipeline stream (host gather, pinned copy)
    against the device-resident pipeline from the same seed: the same
    losses within 1e-6, in both host sources."""
    _need_card()
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.utils import MetricsLogger

    data = mnist.synthetic_mnist(seed=0, train_n=4096, test_n=512)
    cfg = PRESETS["mlp-sgd"].replace(
        synthetic=True, learning_rate=0.02, steps=40, eval_every=40,
        log_every=1, target_accuracy=None, steps_per_call=8)
    runs = {}
    for name, kw in (("device", {}), ("stream", {"data_pipeline": "stream"}),
                     ("tfdata", {"data_pipeline": "stream",
                                 "stream_source": "tfdata"})):
        mlog = MetricsLogger()
        out = trainer.fit(cfg.replace(**kw), data=data, log=mlog)
        runs[name] = [r["loss"] for r in mlog.history if "loss" in r]
        assert out["data_pipeline"] == cfg.replace(**kw).data_pipeline
    for name in ("stream", "tfdata"):
        np.testing.assert_allclose(runs[name], runs["device"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.gpu
def test_tensor_parallel_over_nccl_on_four_cards(tmp_path):
    """On a machine with 4 or more cards, dp 2 x mp 2 as one rank a card
    over NCCL: the MLP (20 SGD steps) and LeNet-5 (20 Adam steps), every
    rank reporting the same run, the losses within rtol 1e-4 of one
    rank's in this process."""
    _need_card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: dp 2 x mp 2, one rank a card")
    from distributedmnist_tpu_torch.parallel import mh_smoke
    from torch_dp_util import launch_smoke

    steps = 20
    specs = [{"learning_rate": 0.02},
             {"model": "lenet", "optimizer": "adam", "learning_rate": 1e-3}]
    recs, logs = launch_smoke(
        4, str(tmp_path), [{"model_parallel": 2, **s} for s in specs],
        ("--device", "cuda", "--preset", "mlp-dp2", "--steps", str(steps)))
    assert "dist: backend nccl, 4 ranks on 4 card(s)" in logs[0]
    for i, spec in enumerate(specs):
        for rank in recs:
            assert rank[i]["model_parallel"] == 2
            assert rank[i]["backend"] == "nccl" and rank[i]["n_chips"] == 4
            assert rank[i]["losses"] == recs[0][i]["losses"]
        one = mh_smoke.run(mh_smoke.smoke_config(
            "mlp-dp2", device="cuda", steps=steps, **spec),
            mh_smoke.smoke_data())
        np.testing.assert_allclose(recs[0][i]["losses"], one["losses"],
                                   rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("model,infer_dtype", (
    ("mlp", "float32"), ("mlp", "bfloat16"), ("mlp", "int8"),
    ("mlp", "megakernel"), ("lenet", "float32"), ("lenet", "bfloat16"),
    ("lenet", "int8")))
def test_fast_lane_on_card_equals_the_pooled_dispatch(model, infer_dtype):
    """The fast lane's exact-fit route on the card, one row at a time
    and through a batcher with the lane on, bit for bit the pooled
    dispatch's at bucket 1 (the same forward, the same kernels)."""
    _need_card()
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  InferenceEngine)

    eng = InferenceEngine(model, models.init_params(model, 0),
                          device="cuda", max_batch=8,
                          infer_dtype=infer_dtype)
    eng.warmup(cost_samples=1)
    x = mnist.synthetic_mnist(seed=3, train_n=16, test_n=8)["test_x"]
    b = DynamicBatcher(eng, fastlane=True, max_inflight=4).start()
    try:
        for i in range(8):
            want = eng.infer(x[i:i + 1])
            h = eng.dispatch_fast(x[i:i + 1])
            assert h.resident and h.bucket == 1
            assert eng.fetch(h).tobytes() == want.tobytes()
            f = b.submit(x[i:i + 1])
            assert f.done() and f.result().tobytes() == want.tobytes()
    finally:
        b.stop()


@pytest.mark.gpu
def test_row_staged_route_on_card_with_a_dirty_buffer():
    """The row-staged route on a ladder from 8: rows 1..7 of the resident
    buffer hold random bytes, and row 0's logits are still the pooled
    dispatch's, bit for bit (every serving forward is row-independent)."""
    _need_card()
    from distributedmnist_tpu_torch.serve import InferenceEngine

    eng = InferenceEngine("mlp", models.init_params("mlp", 0),
                          device="cuda", max_batch=32, buckets=(8, 16, 32))
    eng.warmup(cost_samples=3)
    assert eng.fast_row_cost() is not None
    eng._fast_row_ok = True            # held whichever way the price fell
    x = mnist.synthetic_mnist(seed=4, train_n=16, test_n=8)["test_x"]
    for i in range(8):
        eng._fast_row_buf[1:] = torch.randint(
            0, 256, eng._fast_row_buf[1:].shape, dtype=torch.uint8,
            device="cuda")
        h = eng.dispatch_fast(x[i:i + 1])
        assert h is not None and h.bucket == 8
        assert eng.fetch(h).tobytes() == eng.infer(x[i:i + 1]).tobytes()


def _fit_mlp(seed: int = 1, steps: int = 1000) -> dict:
    """MLP weights with real margins, fit on the CPU from a seed
    (tests/test_torch_serve.py's recipe): every variant clears its
    parity gate on them."""
    import torch.nn.functional as F

    data = mnist.synthetic_mnist(seed=709, train_n=8192, test_n=16)
    net = models.build("mlp", device="cpu")
    net.load_state_dict(models.init_params("mlp", seed))
    opt = torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9)
    x = torch.from_numpy(data["train_x"])
    y = torch.from_numpy(data["train_y"]).long()
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        idx = torch.randint(0, x.shape[0], (128,), generator=g)
        loss = F.cross_entropy(net(x[idx].float() / 255.0), y[idx])
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _fleet_batches_against_single_routers(registry, fleet, factory, reqs):
    """Serve `reqs` (uint8 (n, 28, 28, 1) arrays) through a batcher over
    the fleet, recording each batch the fleet fetched; every batch must be
    bit for bit a single Router's dispatch of the same rows on the engine
    of the replica that computed it, and every answer its request's slice
    of its batch. Returns the replicas that computed batches."""
    from distributedmnist_tpu_torch.serve import DynamicBatcher

    version = fleet.live_version()
    singles = {}
    for rep in fleet.replicas:
        r = factory.make_router()
        r.set_live(rep.router._live.engine, version)
        singles[rep.rid] = r
    seen = []
    fetch = fleet.fetch

    def recording_fetch(fh):
        out = fetch(fh)
        seen.append((fh.replica, fh.x, out))
        return out

    fleet.fetch = recording_fetch
    b = DynamicBatcher(fleet, max_wait_us=2000).start()
    try:
        futs = [b.submit(x) for x in reqs]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        b.stop()
        del fleet.fetch
    rows = {}
    for rid, parts, out in seen:
        assert singles[rid].infer(parts).tobytes() == out.tobytes(), rid
        off = 0
        for p in parts:
            rows[id(p)] = out[off:off + p.shape[0]]
            off += p.shape[0]
    for x, got in zip(reqs, outs):
        assert got.tobytes() == rows[id(x)].tobytes()
    return {rid for rid, _, _ in seen}


@pytest.mark.gpu
def test_two_replica_fleet_on_one_card_is_each_routers_dispatch():
    """Two replicas from build_serving, each engine on a CUDA stream of
    its own (never the default stream): for every precision, each batch
    the fleet computes is bit for bit the single Router's dispatch of the
    same rows on that replica's engine, both replicas serve, the
    replicas' engines give the same bits, and all three kernels
    launch."""
    _need_card()
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import build_serving

    registry, fleet, factory = build_serving(Config(
        model="mlp", device="cuda", serve_max_batch=64, serve_replicas=2))
    registry.add(_fit_mlp(), version="v1")
    registry.promote("v1")
    for dt in ("bfloat16", "int8", "megakernel"):
        registry.add_variant("v1", dt)
    engines = registry.get("v1").engines
    streams = [e.stream for e in engines]
    assert all(s is not None for s in streams)
    assert streams[0].cuda_stream != streams[1].cuda_stream
    for s in streams:
        assert s.cuda_stream != torch.cuda.default_stream(
            s.device).cuda_stream
    rng = _rng(5)
    reqs = [rng.integers(0, 256, (int(n), 28, 28, 1), dtype=np.uint8)
            for n in rng.integers(1, 33, 96)]
    x = reqs[0]
    before = dict(fused.LAUNCHES)
    for dt in ("float32", "bfloat16", "int8", "megakernel"):
        registry.promote("v1", infer_dtype=dt)
        served = _fleet_batches_against_single_routers(registry, fleet,
                                                       factory, reqs)
        assert served == {"r0", "r1"}, dt
        a, b = (rep.router.infer(x) for rep in fleet.replicas)
        assert a.tobytes() == b.tobytes(), dt
    launched = {k: fused.LAUNCHES[k] - before[k] for k in before}
    assert all(n > 0 for n in launched.values()), launched


@pytest.mark.gpu
def test_fleet_replicas_on_their_own_cards():
    """With 4 cards visible, 4 replicas: replica i's engines, weights and
    stream on card i, each batch bit for bit the single Router's dispatch
    on that replica, and every card's answer the same bits."""
    _need_card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: one replica a card")
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import build_serving

    registry, fleet, factory = build_serving(Config(
        model="mlp", device="cuda", serve_max_batch=64, serve_replicas=4))
    assert factory.replica_devices == [torch.device("cuda", i)
                                       for i in range(4)]
    assert factory.total_chips == 4
    registry.add(_fit_mlp(), version="v1")
    registry.promote("v1")
    registry.add_variant("v1", "int8")
    for i, eng in enumerate(registry.get("v1").engines):
        assert eng.device == torch.device("cuda", i)
        assert eng.stream.device == torch.device("cuda", i)
        assert all(p.device == torch.device("cuda", i)
                   for p in eng.params.values())
    rng = _rng(6)
    reqs = [rng.integers(0, 256, (int(n), 28, 28, 1), dtype=np.uint8)
            for n in rng.integers(1, 33, 128)]
    for dt in ("float32", "int8"):
        registry.promote("v1", infer_dtype=dt)
        served = _fleet_batches_against_single_routers(registry, fleet,
                                                       factory, reqs)
        assert len(served) >= 2, (dt, served)
        outs = [rep.router.infer(reqs[1]) for rep in fleet.replicas]
        assert all(o.tobytes() == outs[0].tobytes() for o in outs), dt


@pytest.mark.gpu
def test_cascade_on_the_trained_lenet_on_card(tmp_path):
    """Config 2 trained for its 10 epochs at seed 709 (cuDNN's
    deterministic algorithms, as chip_smoke.py trains it), served from
    its checkpoint with the cascade enabled: the gate passes; `exact` is
    the float32 engine's bytes, `fast` the int8 engine's, `balanced`
    composes the two row by row (an escalated row is the float32
    engine's dispatch of the escalated rows), agrees with `exact` at the
    parity bar, and the cheap stage launched quant_dense."""
    _need_card()
    from distributedmnist_tpu_torch.config import PRESETS, Config
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  ServeMetrics,
                                                  build_serving)
    from distributedmnist_tpu_torch.serve.cascade import (CascadeFront,
                                                          softmax_margin)

    cfg = PRESETS["lenet-adam"].replace(
        synthetic=True, steps=4680, eval_every=1000, seed=709,
        target_accuracy=None, device="cuda", checkpoint_dir=str(tmp_path),
        checkpoint_every=4680)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = trainer.fit(cfg, data=mnist.synthetic_mnist(seed=709))
    finally:
        torch.backends.cudnn.deterministic = prev
    assert out["test_accuracy"] >= 0.98
    metrics = ServeMetrics()
    registry, router, _ = build_serving(Config(
        model="lenet", device="cuda", serve_max_batch=64,
        checkpoint_dir=str(tmp_path)), metrics=metrics)
    mv = registry.bootstrap()
    state = registry.enable_cascade()
    assert state.cheap_dtype == "int8" and state.calibration["passed"]
    f32 = mv.engine
    cheap = mv.variants["int8"].engine
    x = mnist.synthetic_mnist(seed=709, train_n=16,
                              test_n=512)["test_x"][:64]
    b = DynamicBatcher(router, max_wait_us=500, metrics=metrics).start()
    front = CascadeFront(b, b, router, registry, metrics=metrics)
    before = dict(fused.LAUNCHES)
    try:
        got = {c: front.submit(x, accuracy_class=c).result(timeout=120)
               for c in ("exact", "fast", "balanced")}
    finally:
        b.stop()
    assert fused.LAUNCHES["quant_dense"] - before["quant_dense"] > 0
    assert got["exact"].tobytes() == f32.infer(x).tobytes()
    assert got["fast"].tobytes() == cheap.infer(x).tobytes()
    esc = softmax_margin(got["fast"]) < state.threshold
    assert got["balanced"][~esc].tobytes() == got["fast"][~esc].tobytes()
    if esc.any():
        assert got["balanced"][esc].tobytes() == f32.infer(
            x[esc]).tobytes()
    agree = float(np.mean(got["balanced"].argmax(-1)
                          == got["exact"].argmax(-1)))
    assert agree >= 0.995, agree
    block = metrics.snapshot()["cascade"]
    assert block["by_class"] == {"balanced": 1, "exact": 1, "fast": 1}
    assert block["escalated_rows"] == int(esc.sum())


@pytest.mark.gpu
def test_two_catalog_models_on_card_are_each_routers_dispatch():
    """The MLP (fitted, at int8 and then megakernel) and LeNet-5 (seeded,
    float32) from build_tenancy on the card, each model's engines on a
    stream of its own (never the default stream): 96 mixed requests a
    tenant through the scheduler, every batch bit for bit its model's
    own router's dispatch of the same rows on the engine that computed
    it, every answer its slice, nothing built after warmup, the observed
    skip maximum within drr_skip_bound, and both kernels of the MLP's
    precisions launched."""
    _need_card()
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.ops import kernel_lib
    from distributedmnist_tpu_torch.serve import build_tenancy
    from distributedmnist_tpu_torch.serve import scheduler as policy

    catalog, sched = build_tenancy(Config(
        model="mlp", device="cuda", serve_models="mlp,lenet",
        serve_tenants=("light:weight=2,deadline_ms=5000,model=mlp;"
                       "heavy:weight=1,model=lenet"),
        serve_max_batch=64, serve_queue_depth=8192))
    seen = []
    try:
        mlp, lenet = catalog.get("mlp"), catalog.get("lenet")
        mlp.registry.add(_fit_mlp(), version="v1")
        mlp.registry.promote("v1")
        lenet.registry.add(models.init_params("lenet", 3), version="v1")
        lenet.registry.promote("v1")
        for dt in ("int8", "megakernel"):
            mlp.registry.add_variant("v1", dt)
        streams = [e.factory.replica_streams[0] for e in (mlp, lenet)]
        assert streams[0].cuda_stream != streams[1].cuda_stream
        for st in streams:
            assert st.cuda_stream != torch.cuda.default_stream(
                st.device).cuda_stream
        for entry in (mlp, lenet):
            dispatch, fetch = entry.router.dispatch, entry.router.fetch

            def rec_dispatch(x, *a, _d=dispatch, **kw):
                rh = _d(x, *a, **kw)
                rh.parts = x
                return rh

            def rec_fetch(rh, _f=fetch, _name=entry.name):
                out = _f(rh)
                seen.append((_name, rh.engine, rh.parts, out))
                return out

            entry.router.dispatch, entry.router.fetch = rec_dispatch, \
                rec_fetch

        def builds():
            return kernel_lib.load_events() + sum(
                e.factory.engine_builds for e in catalog.entries())

        rng = _rng(12)
        reqs = [(t, rng.integers(0, 256, (int(n), 28, 28, 1),
                                 dtype=np.uint8))
                for n in rng.integers(1, 17, 96) for t in ("light", "heavy")]
        before, steady = dict(fused.LAUNCHES), builds()
        runs = []          # (the run's batches, its answers) a precision
        for dt in ("int8", "megakernel"):
            mlp.registry.promote("v1", infer_dtype=dt)
            start = len(seen)
            futs = [(x, sched.submit(x, tenant=t)) for t, x in reqs]
            outs = [(x, f.result(timeout=120)) for x, f in futs]
            runs.append((seen[start:], outs))
        assert builds() == steady
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before}
        snap = sched.snapshot()
        bound = policy.drr_skip_bound(
            len(snap["tenants"]), sched._max_head_cost_s, sched.quantum_s,
            min(c.weight for c in sched.classes().values()))
        assert snap["max_skip_observed"] <= bound
    finally:
        sched.stop()
    singles = {}
    for batches, outs in runs:
        rows = {}
        for name, engine, parts, out in batches:
            if id(engine) not in singles:
                r = catalog.get(name).factory.make_router()
                r.set_live(engine, "v1")
                singles[id(engine)] = r
            assert singles[id(engine)].infer(parts).tobytes() == \
                out.tobytes(), name
            off = 0
            for p in parts:
                rows[id(p)] = out[off:off + p.shape[0]]
                off += p.shape[0]
        for x, got in outs:
            assert got.tobytes() == rows[id(x)].tobytes()
        assert {name for name, _, _, _ in batches} == {"mlp", "lenet"}
    assert launched["quant_dense"] > 0 and launched["mlp_megakernel"] > 0
