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
hand-written all-reduce, losses within 1e-6), and the bench's sweep and
smoke over 2 ranks sharing the card (and over NCCL, a card a rank, where
2 or more cards are visible). Then the rest of training:
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
bound held. Then the gateway: two int8 workers of the serve CLI behind
`--gateway 2`, every answer the argmax of an in-process int8 router's
logits for the same rows, no CUDA context in the gateway; and the
autoscaler's WindowActuator stepping a batcher over the card's engines
with nothing built after warmup. Serving over a card group: two shards
sharing the card (and an engine over 2 and over 4 cards where that many
are visible) against the one-card engine at every precision, a
2-replica fleet on 4 cards taking 2 disjoint cards each and a 3-replica
fleet on 4 cards as logical replicas over all 4. Last, the gate entry
points: the
multichip dry run's every leg on the card (serve-reload and dp:2proc
launching dense_relu), the training steps' fingerprints on the card
equal to the CPU snapshot's, and one calibration point whose accuracies
on the card are within 0.01 of the CPU's in the same call. Every test
is marked `gpu` and skips without a card.

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
from distributedmnist_tpu_torch.utils.device import training_numerics

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
    with training_numerics():
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
    with training_numerics():
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
    """The bench's throughput mode at --model mlp, a tiny window, one
    rank in this process (--num-devices 1, whatever the cards): one
    record measured on the card, its steps through dense_relu."""
    _need_card()
    from distributedmnist_tpu_torch import bench

    fused.reset_launches()
    assert bench.main(["throughput", "--model", "mlp", "--global-batch",
                       "64", "--steps-per-call", "4", "--warmup-steps",
                       "4", "--bench-steps", "8", "--repeats", "1",
                       "--num-devices", "1", "--inline"]) == 0
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


# the bench's sweep and smoke over ranks: windows cut short
BENCH_RANK_ARGS = {
    "sweep": ("--sweep-batches", "64,512", "--steps-per-call", "16",
              "--warmup-steps", "16", "--bench-steps", "32", "--repeats",
              "1"),
    "smoke": (),
}


def _bench_over_ranks(mode, tmp_path, n, chips, backend, env=None):
    """The bench's `mode` at --model mlp over n ranks (--num-devices n;
    the bench starts them): one record with n_chips `chips`, every rank
    up on `backend` with dense_relu launched; the sweep measures its
    all-reduce, and smoke restores on every rank."""
    from torch_dp_util import run_bench

    rc, records, _, err = run_bench(
        [mode, "--model", "mlp", "--num-devices", str(n),
         *BENCH_RANK_ARGS[mode], "--inline"], str(tmp_path), timeout=300,
        env_extra=env)
    assert rc == 0, err[-3000:]
    assert len(records) == 1
    d = records[0]["detail"]
    assert d["backend"] == "cuda" and records[0]["value"] > 0
    for r in range(n):
        assert (f"[rank {r}] bench: backend up: {n}x cuda on {chips} "
                f"chip(s) over {backend}") in err
        [counts] = fused.parse_launches(err, f"[rank {r}] bench: launches ")
        assert counts["dense_relu"] > 0
    if mode == "sweep":
        assert d["n_chips_measured"] == chips
        assert d["allreduce_modeled"] is False
        assert d["strong_scaling"]["step_ms"] == \
            d["curve_img_s_chip"]["64"]["step_ms"]
    else:
        assert d["n_chips"] == chips and d["final_accuracy"] >= 0.85
        assert d["legs"] == ["train", "eval", "checkpoint-save",
                             "restore-resume", "accuracy-floor"]
        assert err.count("restored checkpoint at step 64") == n


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("sweep", "smoke"))
def test_bench_over_two_ranks_sharing_the_card(mode, tmp_path):
    """The bench's sweep and smoke over 2 ranks on cuda:0: the ranks share
    the card over gloo, so the record counts one chip."""
    _need_card()
    _bench_over_ranks(mode, tmp_path, 2, 1, "gloo",
                      {"CUDA_VISIBLE_DEVICES": "0"})


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("sweep", "smoke"))
def test_bench_over_ranks_on_their_own_cards_over_nccl(mode, tmp_path):
    """On a machine with 2 or more cards, the bench's sweep and smoke over
    one rank a card (up to 4) over NCCL, each card a chip."""
    _need_card()
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs 2 or more cards: one rank a card")
    _bench_over_ranks(mode, tmp_path, n, n, "nccl")


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
    with training_numerics():
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
    assert factory.replica_devices == [[torch.device("cuda", i)]
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


GROUP_ROWS = (1, 2, 3, 7, 64, 127, 128, 255, 256, 511, 512)
GROUP_CASES = ([("mlp", dt) for dt in ("float32", "bfloat16", "int8",
                                       "megakernel")]
               + [("lenet", dt) for dt in ("float32", "bfloat16", "int8")])


def _group_close(model, infer_dtype, got, want):
    """int8 bit for bit, the float precisions at this file's tolerances
    (LeNet's float32 at its serving tolerance: cuDNN may pick another
    algorithm at another row count)."""
    scale = max(1.0, float(np.abs(want).max()))
    if infer_dtype == "int8":
        assert got.tobytes() == want.tobytes()
    elif infer_dtype == "bfloat16":
        atol = (3e-2 if model == "lenet" else 2e-2) * scale
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=atol)
    else:
        atol = (1e-4 if model == "lenet" else 1e-5) * scale
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _group_against_one_card(eng, one, model, infer_dtype, x):
    """A group engine's logits against a one-card engine's at
    GROUP_ROWS."""
    for n in GROUP_ROWS:
        got, want = eng.infer(x[:n]), one.infer(x[:n])
        assert got.shape == (n, 10)
        _group_close(model, infer_dtype, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("model,infer_dtype", GROUP_CASES)
def test_two_shards_sharing_the_card_equal_the_one_card_engine(
        model, infer_dtype):
    """The group [cuda:0, cuda:0]: the ladder in multiples of 2, each
    dispatch split into two shards launched on the card, the fast lane's
    row route and exact fit, and the answers the one-card engine's."""
    _need_card()
    from distributedmnist_tpu_torch.serve import InferenceEngine

    params = models.init_params(model, 5)
    dev = torch.device("cuda", 0)
    eng = InferenceEngine(model, params, devices=[dev, dev], max_batch=512,
                          infer_dtype=infer_dtype)
    one = InferenceEngine(model, params, device="cuda", max_batch=512,
                          infer_dtype=infer_dtype)
    assert eng.n_chips == 2 and eng.buckets[0] == 2
    assert eng.buckets[-1] == 512
    eng.warmup(cost_samples=1)
    x = _rng(17).integers(0, 256, (512, 28, 28, 1), dtype=np.uint8)
    before = dict(fused.LAUNCHES)
    _group_against_one_card(eng, one, model, infer_dtype, x)
    eng._fast_row_ok = True
    for n in (1, 2):
        h = eng.dispatch_fast(x[:n])
        assert h is not None, n
        _group_close(model, infer_dtype, eng.fetch(h), one.infer(x[:n]))
    kernel = {"bfloat16": "dense_relu", "int8": "quant_dense",
              "megakernel": "mlp_megakernel"}.get(
        infer_dtype, "dense_relu" if model == "mlp" else None)
    if kernel is not None:
        assert fused.LAUNCHES[kernel] > before[kernel]


@pytest.mark.gpu
@pytest.mark.parametrize("k", (2, 4))
def test_group_engine_over_k_cards(k):
    """An engine over the first k cards: the weights (each variant's
    prepared once) copied to every card, each shard launched on its own
    card, every precision's answers the one-card engine's."""
    _need_card()
    if torch.cuda.device_count() < k:
        pytest.skip(f"needs {k} cards")
    from distributedmnist_tpu_torch.serve import InferenceEngine

    devs = [torch.device("cuda", i) for i in range(k)]
    x = _rng(18).integers(0, 256, (512, 28, 28, 1), dtype=np.uint8)
    for model, dt in GROUP_CASES:
        params = models.init_params(model, 6)
        eng = InferenceEngine(model, params, devices=devs, max_batch=512,
                              infer_dtype=dt)
        assert eng.buckets[0] == k and sorted(
            eng._device_forwards, key=lambda d: d.index) == devs
        assert all(p.device == devs[0] for p in eng.params.values())
        one = InferenceEngine(model, params, device="cuda", max_batch=512,
                              infer_dtype=dt)
        _group_against_one_card(eng, one, model, dt, x)


def _serve_fleet_on_cards(replicas: int):
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import build_serving

    registry, fleet, factory = build_serving(Config(
        model="mlp", device="cuda", serve_max_batch=64,
        serve_replicas=replicas))
    registry.add(_fit_mlp(), version="v1")
    registry.promote("v1")
    registry.add_variant("v1", "int8")
    return registry, fleet, factory


@pytest.mark.gpu
def test_two_replica_fleet_on_four_cards_takes_two_cards_each():
    """The JAX registry's rule: 2 replicas on 4 cards get 2 disjoint cards
    each, every engine data-parallel over its replica's 2, and each batch
    bit for bit the single Router's dispatch on that replica."""
    _need_card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    registry, fleet, factory = _serve_fleet_on_cards(2)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert factory.replica_devices == [cards[:2], cards[2:]]
    assert (factory.n_chips, factory.total_chips) == (2, 4)
    assert factory.total_chips == factory.n_chips * fleet.n_replicas
    assert factory.buckets == (2, 4, 8, 16, 32, 64)
    for i, eng in enumerate(registry.get("v1").engines):
        assert eng.devices == factory.replica_devices[i]
        assert [s.device for s in eng.streams] == eng.devices
    rng = _rng(19)
    reqs = [rng.integers(0, 256, (int(n), 28, 28, 1), dtype=np.uint8)
            for n in rng.integers(1, 33, 96)]
    for dt in ("float32", "int8"):
        registry.promote("v1", infer_dtype=dt)
        served = _fleet_batches_against_single_routers(registry, fleet,
                                                       factory, reqs)
        assert served == {"r0", "r1"}, dt


@pytest.mark.gpu
def test_three_replica_fleet_on_four_cards_is_logical_over_all_four():
    """3 replicas do not divide 4 cards: every replica is a logical
    replica over all 4 (JAX's rule), on streams of its own on each card,
    n_chips 4 a replica and 4 in all."""
    _need_card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    registry, fleet, factory = _serve_fleet_on_cards(3)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert factory.replica_devices == [cards] * 3
    assert (factory.n_chips, factory.total_chips) == (4, 4)
    assert factory.total_chips != factory.n_chips * fleet.n_replicas
    assert factory.buckets == (4, 8, 16, 32, 64)
    streams = {s.cuda_stream for g in factory.replica_streams
               for s in g}
    assert len(streams) == 12
    rng = _rng(20)
    reqs = [rng.integers(0, 256, (int(n), 28, 28, 1), dtype=np.uint8)
            for n in rng.integers(1, 33, 96)]
    for dt in ("float32", "int8"):
        registry.promote("v1", infer_dtype=dt)
        served = _fleet_batches_against_single_routers(registry, fleet,
                                                       factory, reqs)
        assert len(served) >= 2, (dt, served)


@pytest.mark.gpu
def test_cascade_on_the_trained_lenet_on_card(tmp_path):
    """Config 2 trained for its 10 epochs at seed 709 (fit runs cuDNN's
    deterministic algorithms: chip_smoke.py's checkpoint), served from
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
    out = trainer.fit(cfg, data=mnist.synthetic_mnist(seed=709))
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
        streams = [e.factory.replica_streams[0][0] for e in (mlp, lenet)]
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


@pytest.mark.gpu
def test_gateway_two_workers_int8_on_card_equal_an_in_process_router(
        tmp_path):
    """`python -m distributedmnist_tpu_torch.serve --gateway 2` over the
    fitted MLP at int8, both workers on the card: every answer of 48
    sequential requests of 1-16 rows (each alone in its worker's batch)
    is the argmax of an in-process int8 router's logits on the card for
    the same rows, at the same bucket ladder; SIGTERM exits 0, each
    worker launched quant_dense and the gateway made no CUDA context."""
    _need_card()
    import os
    import sys

    from distributedmnist_tpu_torch.checkpoint import Checkpointer
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import build_serving
    from distributedmnist_tpu_torch.serve.process import ServerProcess

    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": _fit_mlp(), "optimizer": {}, "scheduler": {}})
    ck.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    srv = ServerProcess(
        [sys.executable, "-m", "distributedmnist_tpu_torch.serve",
         "--model", "mlp", "--checkpoint-dir", str(tmp_path),
         "--serve-max-batch", "16", "--serve-infer-dtype", "int8",
         "--serve-cache", "--gateway", "2", "--port", "0"],
        env=env, cwd=repo, ready_timeout=300, ready_metric="gateway_ready")
    rng = _rng(13)
    reqs = [rng.integers(0, 256, (int(n), 784), dtype=np.uint8)
            for n in rng.integers(1, 17, 48)]
    try:
        def fleet_ok():
            code, body = srv.call("/healthz")
            return code == 200 and all(
                r.get("ok") and r.get("live_infer_dtype") == "int8"
                for r in body["workers"])

        srv.wait_for("both workers live at int8", fleet_ok, timeout=300)
        try:
            got = [srv.ok("/predict", data=x.tobytes())["classes"]
                   for x in reqs]
        except RuntimeError as e:     # the server's side of a refusal
            raise RuntimeError(f"{e}\n{srv.stderr()}") from e
    finally:
        done = srv.stop()
    assert done.rc == 0, done.stderr
    assert "gateway: cuda initialized False" in done.stderr
    assert len(done.launches) == 2
    assert all(n["quant_dense"] > 0 for n in done.launches)
    registry, router, _ = build_serving(Config(
        model="mlp", device="cuda", checkpoint_dir=str(tmp_path),
        serve_max_batch=16))
    mv = registry.bootstrap(promote=False)
    assert registry.go_live(mv.version, "int8") == "int8"
    want = [router.infer(x.reshape(-1, 28, 28, 1)).argmax(-1).tolist()
            for x in reqs]
    assert got == want, ([i for i, (g, w) in enumerate(zip(got, want))
                          if g != w], done.stderr)


@pytest.mark.gpu
def test_window_actuator_steps_a_card_batcher_without_builds():
    """The WindowActuator walks a batcher over the card's MLP engines up
    and down its whole unit range while requests flow: the window and
    bucket ceiling follow the plan, every answer is finite and of its
    request's shape, and nothing is built or loaded after warmup."""
    _need_card()
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.ops import kernel_lib
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  build_serving)
    from distributedmnist_tpu_torch.serve.autoscale import WindowActuator

    registry, router, factory = build_serving(Config(
        model="mlp", device="cuda", serve_max_batch=64))
    registry.add(_fit_mlp(), version="v1")
    registry.promote("v1")
    steady = kernel_lib.load_events() + factory.engine_builds
    b = DynamicBatcher(router, max_batch=4, max_inflight=4).start()
    rng = _rng(21)
    try:
        act = WindowActuator(b, floor=1, ceiling=4, base_max_batch=4)
        for u in (1, 2, 3, 4, 3, 2, 1):
            assert act.scale_to(u) == u
            window, bucket = act.plan(u)
            assert (b.window(), b.max_batch) == (window, bucket)
            xs = [rng.integers(0, 256, (int(n), 28, 28, 1), dtype=np.uint8)
                  for n in rng.integers(1, bucket + 1, 16)]
            outs = [f.result(timeout=120) for f in [b.submit(x) for x in xs]]
            for x, out in zip(xs, outs):
                assert out.shape == (x.shape[0], 10)
                assert np.isfinite(out).all()
    finally:
        b.stop()
    assert kernel_lib.load_events() + factory.engine_builds == steady


@pytest.mark.gpu
def test_dryrun_multichip_2_on_the_card():
    """Every leg of the multichip dry run on the card: 2 ranks sharing
    it over gloo (or a card each over NCCL), serve-reload's float32 MLP
    engines launching dense_relu."""
    _need_card()
    from distributedmnist_tpu_torch import dryrun

    rec = dryrun.dryrun_multichip(2)
    assert rec["legs"] == dryrun.dryrun_legs(2)
    assert rec["launches"]["serve-reload"]["dense_relu"] > 0
    assert rec["launches"]["dp:2proc"]["dense_relu"] > 0


@pytest.mark.gpu
def test_train_fingerprints_on_the_card_equal_the_snapshot():
    """The training steps recorded on the card (dense_relu.cu, cuDNN's
    convolutions, the foreach updates) give the CPU snapshot's
    fingerprints, with no transfer, float64 or sync finding."""
    _need_card()
    from distributedmnist_tpu_torch.analysis import torchcheck as tc

    fps, findings = tc.train_step_fingerprints("cuda")
    assert [f.format() for f in findings] == []
    assert fps == tc.load_snapshot()["fingerprints"][tc.TRAIN_LABEL]


@pytest.mark.gpu
def test_calibration_point_on_the_card_matches_the_cpu():
    """One calibration point (the set's own 0.44:3, cut to 8,192 train
    images and 2 epochs) on the card and on the CPU in the same call:
    each model's test accuracy within 0.01, the MLP fits launching
    dense_relu."""
    _need_card()
    from distributedmnist_tpu_torch import calibrate_synthetic as cal

    def point(device):
        return cal.calibrate([(0.44, 3)], ["mlp", "lenet"], 2, 8192, 2048,
                             device)[0]["accuracy"]

    before = fused.LAUNCHES["dense_relu"]
    card = point("cuda")
    assert fused.LAUNCHES["dense_relu"] > before
    cpu = point("cpu")
    for model in ("mlp", "lenet"):
        assert abs(card[model] - cpu[model]) <= 0.01, (card, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_config2_repeats_itself_bit_for_bit_on_card(tmp_path, dtype):
    """Config 2 at seed 709 for one epoch (468 steps), fit twice in this
    process and once in each of two child processes: every logged loss,
    the test accuracy and every parameter (torch.equal) the same."""
    _need_card()
    from torch_repro_util import differences, fit_record, run_child

    data = mnist.synthetic_mnist(seed=709)
    runs = [fit_record("lenet-adam", steps=468, seed=709, device="cuda",
                       dtype=dtype, data=data) for _ in range(2)]
    for i in range(2):
        out = str(tmp_path / f"child{i}.pt")
        rc, err = run_child(out, "--dtype", dtype, "--steps", "468",
                            "--seed", "709")
        assert rc == 0, err[-3000:]
        runs.append(torch.load(out))
    for i, run in enumerate(runs[1:], 1):
        assert differences(runs[0], run) == [], i
    assert runs[0]["test_accuracy"] >= 0.9
    assert all(v.device.type == "cpu" for v in runs[0]["params"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ("mlp-dp2", "lenet-dp8"))
def test_two_ranks_sharing_the_card_repeat_bit_for_bit(tmp_path, preset):
    """Config 3's MLP and config 4's LeNet-5 as 2 ranks sharing the card
    over gloo (each rank its own process, each entering the training
    scope through fit), launched twice with two fits a launch: every
    rank's logged losses (a block's last on the card), final loss and
    test accuracy the same in all four fits."""
    _need_card()
    from torch_dp_util import collect, spawn_smoke

    fits = []
    for launch in range(2):
        d = tmp_path / f"launch{launch}"
        d.mkdir()
        recs, logs = collect(spawn_smoke(
            2, str(d), [{}, {}],
            ("--device", "cuda", "--preset", preset, "--steps", "30"),
            env_extra={"CUDA_VISIBLE_DEVICES": "0"}), 2)
        assert "dist: backend gloo, 2 ranks on 1 card(s)" in logs[0]
        fits.extend(rec for rank in recs for rec in rank)
    assert len(fits) == 8
    for rec in fits:
        assert rec["steps"] == 30 and rec["backend"] == "gloo"
        assert (rec["losses"], rec["final_loss"], rec["test_accuracy"]) \
            == (fits[0]["losses"], fits[0]["final_loss"],
                fits[0]["test_accuracy"])
    assert fits[0]["losses"][-1] == fits[0]["final_loss"]


@pytest.mark.gpu
@pytest.mark.parametrize("preset,dtype,pipeline", (
    ("lenet-adam", "float32", "device"), ("lenet-adam", "bfloat16", "device"),
    ("lenet-adam", "float32", "stream"), ("lenet-adam", "bfloat16", "stream"),
    ("mlp-sgd", "float32", "device")))
def test_training_runs_under_deterministic_algorithms_on_card(
        tmp_path, preset, dtype, pipeline):
    """Configs 1 and 2 in a fresh child process that sets
    CUBLAS_WORKSPACE_CONFIG before torch is imported and calls
    torch.use_deterministic_algorithms(True): no op of the training path
    (forward, backward, update, eval) is refused."""
    _need_card()
    from torch_repro_util import run_child

    out = str(tmp_path / "run.pt")
    rc, err = run_child(out, "--preset", preset, "--dtype", dtype,
                        "--pipeline", pipeline, "--steps", "200",
                        deterministic_algorithms=True)
    assert rc == 0, err[-3000:]
    rec = torch.load(out)
    assert np.isfinite(rec["final_loss"]) and len(rec["losses"]) >= 1


@pytest.mark.gpu
def test_bench_time_to_accuracy_repeats_its_steps_on_card(capsys):
    """The bench's time-to-accuracy mode for LeNet-5 at its defaults (3
    seeds), one rank in this process (--num-devices 1), run twice: the
    same steps and evals to the target, and the same final accuracy,
    seed by seed."""
    _need_card()
    from distributedmnist_tpu_torch import bench

    runs = []
    for _ in range(2):
        assert bench.main(["time-to-accuracy", "--num-devices", "1",
                           "--inline"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        d = rec["detail"]
        runs.append((d["steps_to_target"], d["evals_to_target"],
                     [(t["seed"], t["steps"], t["reached"],
                       t["final_accuracy"]) for t in d["trial_results"]]))
    assert runs[0] == runs[1]
    assert len(runs[0][2]) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("infer_dtype", ("float32", "bfloat16", "int8"))
def test_lenet_serving_is_unmoved_by_the_training_scope_on_card(
        infer_dtype):
    """The training scope's settings are process-wide, so a server
    thread running beside a fit sees them: LeNet-5's serving engine
    answers the same bytes inside the scope as outside it."""
    _need_card()
    from distributedmnist_tpu_torch.serve import InferenceEngine

    eng = InferenceEngine("lenet", models.init_params("lenet", 5),
                          device="cuda", max_batch=128,
                          infer_dtype=infer_dtype)
    x = mnist.synthetic_mnist(seed=5, train_n=16, test_n=128)["test_x"]
    outside = [eng.infer(x[:b]) for b in (1, 7, 128)]
    with training_numerics():
        inside = [eng.infer(x[:b]) for b in (1, 7, 128)]
    assert [o.tobytes() for o in inside] == [o.tobytes() for o in outside]
