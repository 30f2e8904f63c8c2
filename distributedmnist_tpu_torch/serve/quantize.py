"""The inference variants of the MLP and LeNet-5: weight quantization and
the forwards the bfloat16, int8 and megakernel engines run (the port of
the JAX package's serve/quantize.py).

The float32 engine runs the model's own forward and is the parity
oracle. A variant here is a forward specialized for inference that the
registry serves only after its parity gate passes:

- **bfloat16**: the /255 input normalization folded into the first
  layer's kernel at load. The MLP's hidden layer and LeNet's fc1 and
  fc2 go through the fused dense+relu kernel in bf16 with f32
  accumulation; the logits are a bf16 matmul. LeNet's convolutions and
  pools run in bf16.
- **int8**: per-output-channel symmetric weight quantization. The MLP
  centres its pixels to int8 at 128 (the +128 offset folded into the
  first bias) and runs both layers through the int8 dense kernel.
  LeNet's convolutions run in float32 over the quantized weights'
  round trip (conv1's scales absorb the 1/255), and fc1, fc2 and logits
  go through the int8 dense kernel. Every activation that enters the
  int8 kernel is quantized by a STATIC scale calibrated once at build,
  on the calibration batch, by a numpy replica of the layers before it
  (exact for the int8 products; each stage is calibrated on the
  previous stage's quantized output).
- **megakernel** (the MLP only): full f32 numerics with /255 folded into
  w1, the whole forward in one kernel launch.

The JAX package's weight-only int8 route exists for XLA-CPU serving
only; no device of the port takes it, so int8 always takes the true
int8 route here, on the CPU (plain versions) as on the card (kernels).

prepare_inference() is the entry point: it returns the prepared
parameters (CPU tensors) and a forward(params, x_u8) -> f32 logits. An
engine prepares a variant once and copies the same prepared tensors to
each of its devices (a group engine's cards), one forward a device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from distributedmnist_tpu_torch.models.lenet import LAYERS
from distributedmnist_tpu_torch.ops import conv, fused

INFER_DTYPES = ("float32", "bfloat16", "int8", "megakernel")
MEGAKERNEL = "megakernel"
MEGAKERNEL_MODELS = ("mlp",)

# The registry's held-out parity batch (serve/registry.py) — the int8
# calibration batch is built from the same seed.
PARITY_ROWS = 128
PARITY_SEED = 709


def variant_supported(model: str, infer_dtype: str) -> bool:
    """Whether model `model` can build the `infer_dtype` variant: the
    megakernel exists for the MLP only; other dtypes are model-agnostic."""
    if infer_dtype != MEGAKERNEL:
        return infer_dtype in INFER_DTYPES
    return model in MEGAKERNEL_MODELS


def quantize_channelwise(w) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization of a dense (in, out)
    kernel: scale[j] = max|W[:, j]| / 127 (an all-zero channel gets 1.0 so
    dequant stays exact), Wq = clip(round(W / scale), -127, 127)."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim < 2:
        raise ValueError(
            f"channelwise quantization wants a >=2-D kernel, got shape "
            f"{w.shape}")
    flat = w.reshape(-1, w.shape[-1])
    scale = np.max(np.abs(flat), axis=0) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize(q, scale) -> np.ndarray:
    """The quantization round-trip's float side: q * scale, float32."""
    return np.asarray(q, dtype=np.float32) * np.asarray(scale,
                                                        dtype=np.float32)


def quantize_act_static(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(h / scale), -127, 127) as int8, with the calibrated
    scalar scale. A division, as the JAX package has it: multiplying by
    the reciprocal rounds differently. torch.round rounds half to even,
    as jnp.round does."""
    return torch.clamp(torch.round(h / scale), -127, 127).to(torch.int8)


# Headroom on the calibration batch's max|activation|: the fixed scale
# must cover inputs denser than any calibration row.
ACT_CALIBRATION_HEADROOM = 1.25

# Seeded uniform-random uint8 rows appended to the held-out calibration
# batch: dense worst-case pixels digit-like images never produce.
_CALIB_PROBE_ROWS = 32


def calibration_batch(rows: int = PARITY_ROWS) -> np.ndarray:
    """The activation-calibration inputs: the held-out parity batch plus
    the seeded dense-random probe block."""
    from distributedmnist_tpu_torch.data import synthetic_mnist

    data = synthetic_mnist(seed=PARITY_SEED, train_n=16, test_n=rows)
    held = np.asarray(data["test_x"][:rows], dtype=np.uint8)
    rng = np.random.default_rng(PARITY_SEED)
    probe = rng.integers(0, 256,
                         size=(_CALIB_PROBE_ROWS,) + held.shape[1:],
                         dtype=np.uint8)
    return np.concatenate([held, probe], axis=0)


def _static_act_scale(h_abs_max: float) -> np.ndarray:
    """The calibrated scale as a 0-d float32 array."""
    s = max(float(h_abs_max) * ACT_CALIBRATION_HEADROOM / 127.0, 1e-8)
    return np.asarray(s, dtype=np.float32)


def _mlp_weights(params) -> tuple:
    """(w1, b1, w2, b2) as float32 numpy from the port's MLP params."""
    return tuple(np.asarray(torch.as_tensor(params[k]).detach().cpu(),
                            dtype=np.float32)
                 for k in ("hidden_kernel", "hidden_bias", "logits_kernel",
                           "logits_bias"))


def center_pixels(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> int8 centred at 128; the +128 offset is folded into
    the layer-1 bias at build."""
    return (x_u8.to(torch.int16) - 128).to(torch.int8)


def _prepare_mlp(params, infer_dtype: str, calib_x=None):
    w1, b1, w2, b2 = _mlp_weights(params)
    if infer_dtype == "bfloat16":
        prep = {"w1": torch.from_numpy(w1 / np.float32(255.0)).bfloat16(),
                "b1": torch.from_numpy(b1).bfloat16(),
                "w2": torch.from_numpy(w2).bfloat16(),
                "b2": torch.from_numpy(b2).bfloat16()}

        def forward(p, x_u8):
            x = x_u8.reshape(x_u8.shape[0], -1).to(torch.bfloat16)
            h = fused.dense_relu_inference(x, p["w1"], p["b1"])
            return (h @ p["w2"]).float() + p["b2"].float()

        return prep, forward

    q1, s1 = quantize_channelwise(w1)
    q2, s2 = quantize_channelwise(w2)
    s1_eff = (s1 / 255.0).astype(np.float32)
    b1_eff = (b1 + 128.0 * q1.astype(np.float32).sum(axis=0) * s1_eff
              ).astype(np.float32)
    # Static activation calibration: replicate layer 1 in numpy over the
    # calibration batch — the int8 product is exact in both worlds, so
    # max|h| here is the served route's.
    calib = (np.asarray(calib_x, dtype=np.uint8)
             if calib_x is not None else calibration_batch())
    xc = calib.reshape(calib.shape[0], -1).astype(np.int32) - 128
    h = np.maximum(
        (xc @ q1.astype(np.int32)).astype(np.float32) * s1_eff + b1_eff,
        0.0)
    act_scale = _static_act_scale(np.max(np.abs(h)))
    prep = {"w1q": torch.from_numpy(q1), "s1": torch.from_numpy(s1_eff),
            "b1": torch.from_numpy(b1_eff), "w2q": torch.from_numpy(q2),
            # the layer-2 dequant factor, weight scale x activation scale,
            # multiplied in float32 once here
            "s2": torch.from_numpy((s2 * act_scale).astype(np.float32)),
            "b2": torch.from_numpy(b2),
            "act_scale": torch.from_numpy(act_scale)}

    def forward(p, x_u8):
        x = center_pixels(x_u8.reshape(x_u8.shape[0], -1))
        h = fused.quant_dense(x, p["w1q"], p["s1"], p["b1"], relu=True)
        hq = quantize_act_static(h, p["act_scale"])
        return fused.quant_dense(hq, p["w2q"], p["s2"], p["b2"], relu=False)

    return prep, forward


def _prepare_mlp_megakernel(params):
    w1, b1, w2, b2 = _mlp_weights(params)
    prep = {"w1": torch.from_numpy((w1 / 255.0).astype(np.float32)),
            "b1": torch.from_numpy(b1), "w2": torch.from_numpy(w2),
            "b2": torch.from_numpy(b2)}

    def forward(p, x_u8):
        x = x_u8.reshape(x_u8.shape[0], -1).to(torch.float32)
        return fused.mlp_megakernel(x, p["w1"], p["b1"], p["w2"], p["b2"])

    return prep, forward


def _np_im2col_conv(x, kernel, bias, padding: str) -> np.ndarray:
    """Numpy replica of the JAX package's patch-matmul convolution (NHWC,
    stride 1), for the activation calibration: the same shifted-slice
    accumulation, so the calibrated scales equal the JAX package's bit
    for bit."""
    kh, kw, cin, feat = kernel.shape
    if padding == "SAME":
        x = np.pad(x, ((0, 0), (kh // 2, kh // 2),
                       (kw // 2, kw // 2), (0, 0)))
    n, h, w, c = x.shape
    oh, ow = h - kh + 1, w - kw + 1
    out = np.zeros((n, oh, ow, feat), dtype=np.float32)
    for i in range(kh):
        for j in range(kw):
            out += x[:, i:i + oh, j:j + ow, :] @ kernel[i, j]
    return out + bias


def _np_avg_pool2(x) -> np.ndarray:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))


LENET_LAYERS = tuple(name for name, _, _ in LAYERS)
LENET_DENSE = ("fc1", "fc2", "logits")


def lenet_int8_dense_stack(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LeNet's int8 dense stack on the flattened (B, 400) float32 trunk
    output: each layer quantizes its input by its static scale and runs
    the int8 dense kernel, relu'd but for the logits."""
    for n in LENET_DENSE:
        xq = quantize_act_static(x, p[f"{n}.act_scale"])
        x = fused.quant_dense(xq, p[f"{n}.q"], p[f"{n}.scale"],
                              p[f"{n}.bias"], relu=n != "logits")
    return x


def lenet_trunk(p: dict, x: torch.Tensor) -> torch.Tensor:
    """conv -> relu -> pool twice in x's dtype, flattened NHWC to (B,
    400). The flatten copies where the pool's output is not NHWC in
    memory, since the dense kernels take contiguous rows only."""
    x = conv.avg_pool2(torch.relu(conv.conv2d(
        x, p["conv1.kernel"], p["conv1.bias"], "SAME")))
    x = conv.avg_pool2(torch.relu(conv.conv2d(
        x, p["conv2.kernel"], p["conv2.bias"], "VALID")))
    return x.reshape(x.shape[0], -1).contiguous()


def _prepare_lenet(params, infer_dtype: str, calib_x=None):
    W = {n: np.asarray(torch.as_tensor(params[f"{n}.kernel"]).detach().cpu(),
                       dtype=np.float32) for n in LENET_LAYERS}
    B = {n: np.asarray(torch.as_tensor(params[f"{n}.bias"]).detach().cpu(),
                       dtype=np.float32) for n in LENET_LAYERS}
    if infer_dtype == "bfloat16":
        prep = {}
        for n in LENET_LAYERS:
            k = W[n] / np.float32(255.0) if n == "conv1" else W[n]
            prep[f"{n}.kernel"] = torch.from_numpy(k).bfloat16()
            prep[f"{n}.bias"] = torch.from_numpy(B[n]).bfloat16()

        def forward(p, x_u8):
            x = lenet_trunk(p, x_u8.to(torch.bfloat16))   # /255 in conv1
            for n in ("fc1", "fc2"):
                x = fused.dense_relu_inference(x, p[f"{n}.kernel"],
                                               p[f"{n}.bias"])
            return (x @ p["logits.kernel"] + p["logits.bias"]).float()

        return prep, forward

    # int8: every kernel quantized per output channel; conv1's scales
    # absorb the 1/255 input normalization. The convs run in f32 over the
    # round trip; the dense stack runs the int8 values.
    q, s = {}, {}
    for n in LENET_LAYERS:
        q[n], s[n] = quantize_channelwise(W[n])
    s["conv1"] = (s["conv1"] / 255.0).astype(np.float32)
    conv_k = {n: dequantize(q[n], s[n]) for n in ("conv1", "conv2")}
    # Static activation calibration: the calibration batch through a
    # numpy replica of the trunk, then through the quantized dense stack
    # stage by stage, each scale set on the previous stage's quantized
    # output — the distribution that stage sees when serving.
    calib = (np.asarray(calib_x, dtype=np.uint8)
             if calib_x is not None else calibration_batch())
    x = calib.astype(np.float32)
    x = _np_im2col_conv(x, conv_k["conv1"], B["conv1"], "SAME")
    x = _np_avg_pool2(np.maximum(x, 0.0))
    x = _np_im2col_conv(x, conv_k["conv2"], B["conv2"], "VALID")
    x = _np_avg_pool2(np.maximum(x, 0.0))
    x = x.reshape(x.shape[0], -1).astype(np.float32)
    prep = {}
    for n in ("conv1", "conv2"):
        prep[f"{n}.kernel"] = torch.from_numpy(conv_k[n])
        prep[f"{n}.bias"] = torch.from_numpy(B[n])
    for n in LENET_DENSE:
        act = _static_act_scale(np.max(np.abs(x)))
        xq = np.clip(np.round(x / float(act)), -127.0, 127.0)
        acc = (xq.astype(np.int32) @ q[n].astype(np.int32)).astype(
            np.float32)
        x = acc * (s[n] * float(act)) + B[n]
        if n != "logits":
            x = np.maximum(x, 0.0)
        prep[f"{n}.q"] = torch.from_numpy(q[n])
        # the dequant factor, weight scale x activation scale, multiplied
        # in float32 once here
        prep[f"{n}.scale"] = torch.from_numpy((s[n] * act).astype(np.float32))
        prep[f"{n}.bias"] = torch.from_numpy(B[n])
        prep[f"{n}.act_scale"] = torch.from_numpy(act)

    def forward(p, x_u8):
        return lenet_int8_dense_stack(
            p, lenet_trunk(p, x_u8.to(torch.float32)))   # /255 in conv1

    return prep, forward


def prepare_inference(model: str, params, infer_dtype: str, *,
                      calib_x=None) -> tuple[dict, Callable]:
    """(prepared params as CPU tensors, forward(params, x_u8) -> f32
    logits) for a variant of model `model` ("mlp" or "lenet") with
    float32 `params` (the model's state_dict). float32 is refused: it
    serves the model's own forward. `calib_x` overrides the int8
    activation-calibration batch."""
    if infer_dtype == "float32":
        raise ValueError(
            "float32 serves the reference forward — the inference fast "
            "path only exists for the variants")
    if infer_dtype not in INFER_DTYPES:
        raise ValueError(
            f"unknown infer dtype {infer_dtype!r} (expected one of "
            f"{INFER_DTYPES})")
    if model not in ("mlp", "lenet"):
        raise ValueError(f"no inference variants for model {model!r} "
                         "(expected mlp|lenet)")
    if infer_dtype == MEGAKERNEL:
        if not variant_supported(model, MEGAKERNEL):
            raise ValueError(
                f"no megakernel for model {model!r}: the whole-net fused "
                "forward exists for the MLP only (MEGAKERNEL_MODELS)")
        return _prepare_mlp_megakernel(params)
    if model == "lenet":
        return _prepare_lenet(params, infer_dtype, calib_x=calib_x)
    return _prepare_mlp(params, infer_dtype, calib_x=calib_x)
