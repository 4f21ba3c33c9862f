"""Layered CNNs from the paper's evaluation (LeNet-5, AlexNet) in PyTorch.

The port of :mod:`repro.models.cnn`, with its layout kept at the public
functions so the two packages exchange parameters as they are: a model
is an ordered list of layer specs, params are a list with one
``{"w", "b"}`` dict per layer, conv weights are HWIO and activations are
NHWC.  Each layer carries the metadata the profiling stage needs
(parameter count, per-sample output elements, forward FLOPs).

Inside a conv layer the NHWC batch is viewed as NCHW (a channels-last
view, no copy) for ``F.conv2d``.  ``SAME`` padding is XLA's: the total
``max((out - 1) * stride + kernel - in, 0)`` is split with the smaller
half first, which is asymmetric for AlexNet's stride-4 ``conv1``
(``F.conv2d``'s own ``padding="same"`` refuses stride > 1).  The first
Dense after a conv flattens in NHWC (h, w, c) order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    out_ch: int
    kernel: int
    stride: int = 1
    padding: str = "SAME"
    pool: int = 1  # max-pool window == stride applied after ReLU (1 = none)


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    name: str
    out: int
    relu: bool = True


LayerSpec = Any  # ConvSpec | DenseSpec


@dataclasses.dataclass
class LayerMeta:
    name: str
    param_count: int
    out_elems: int      # per sample
    flops_fwd: int      # per sample
    out_shape: Tuple[int, ...]  # per sample

    @property
    def param_bytes(self) -> int:
        return 4 * self.param_count

    @property
    def out_bytes(self) -> int:
        return 4 * self.out_elems


@dataclasses.dataclass
class LayeredModel:
    """A sequential model with per-layer params and segment execution."""
    name: str
    specs: Tuple[LayerSpec, ...]
    input_shape: Tuple[int, ...]  # per-sample, e.g. (32, 32, 3)
    num_classes: int

    # ---- init ----------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Params:
        """He-normal weights, zero biases, drawn from ``generator`` on its
        own device and placed on ``device`` (default: the generator's)."""
        gdev = generator.device
        device = gdev if device is None else torch.device(device)
        params: Params = []
        shape = self.input_shape
        for spec in self.specs:
            if isinstance(spec, ConvSpec):
                fan_in = spec.kernel * spec.kernel * shape[-1]
                wshape = (spec.kernel, spec.kernel, shape[-1], spec.out_ch)
                nout = spec.out_ch
                shape = _conv_out_shape(shape, spec)
            else:
                fan_in = int(np.prod(shape))
                wshape = (fan_in, spec.out)
                nout = spec.out
                shape = (spec.out,)
            if device.type == "meta":         # shapes only: draw nothing
                w = torch.empty(wshape, dtype=torch.float32, device=device)
            else:
                w = torch.randn(wshape, generator=generator, device=gdev,
                                dtype=torch.float32) * math.sqrt(2.0 / fan_in)
            params.append({"w": w.to(device),
                           "b": torch.zeros(nout, dtype=torch.float32,
                                            device=device)})
        return params

    # ---- metadata (the profiling stage's MP_i / MO_i / FLOPs) ----------
    def layer_meta(self) -> List[LayerMeta]:
        metas: List[LayerMeta] = []
        shape = self.input_shape
        for spec in self.specs:
            if isinstance(spec, ConvSpec):
                out_shape = _conv_out_shape(shape, spec)
                # conv output spatial size *before* pooling:
                pre = _conv_out_shape(shape, dataclasses.replace(spec, pool=1))
                flops = 2 * spec.kernel * spec.kernel * shape[-1] * \
                    spec.out_ch * pre[0] * pre[1]
                pcount = spec.kernel * spec.kernel * shape[-1] * spec.out_ch \
                    + spec.out_ch
            else:
                fan_in = int(np.prod(shape))
                out_shape = (spec.out,)
                flops = 2 * fan_in * spec.out
                pcount = fan_in * spec.out + spec.out
            metas.append(LayerMeta(spec.name, pcount,
                                   int(np.prod(out_shape)), int(flops),
                                   out_shape))
            shape = out_shape
        return metas

    @property
    def num_layers(self) -> int:
        return len(self.specs)

    # ---- execution ------------------------------------------------------
    def apply_segment(self, params: Sequence[Dict[str, torch.Tensor]],
                      x: torch.Tensor, start: int, stop: int
                      ) -> torch.Tensor:
        """Run layers ``start..stop-1`` (0-indexed) on batch ``x``."""
        for i in range(start, stop):
            x = self.apply_layer(params[i], x, i)
        return x

    def apply_layer(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                    i: int) -> torch.Tensor:
        spec = self.specs[i]
        if isinstance(spec, ConvSpec):
            xc = x.permute(0, 3, 1, 2)                   # NHWC -> NCHW view
            w = p["w"].permute(3, 2, 0, 1)               # HWIO -> OIHW
            pad = (0, 0)
            if spec.padding == "SAME":
                (hl, hh), (wl, wh) = (
                    _same_pads(n, spec.kernel, spec.stride)
                    for n in x.shape[1:3])
                if hl == hh and wl == wh:
                    pad = (hl, wl)
                else:
                    xc = F.pad(xc, (wl, wh, hl, hh))
            y = F.conv2d(xc, w, stride=spec.stride, padding=pad)
            y = torch.relu(y + p["b"][:, None, None])
            if spec.pool > 1:
                y = F.max_pool2d(y, spec.pool, spec.pool)
            return y.permute(0, 2, 3, 1)                 # back to NHWC
        # Dense: flatten if needed (NHWC order).
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        y = x @ p["w"] + p["b"]
        return torch.relu(y) if spec.relu else y

    def apply(self, params: Sequence[Dict[str, torch.Tensor]],
              x: torch.Tensor) -> torch.Tensor:
        return self.apply_segment(params, x, 0, self.num_layers)

    def loss(self, params: Sequence[Dict[str, torch.Tensor]],
             x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy."""
        logp = torch.log_softmax(self.apply(params, x), dim=-1)
        return -logp.gather(1, labels.long()[:, None]).mean()


def _same_pads(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def _conv_out_shape(shape: Tuple[int, ...], spec: ConvSpec
                    ) -> Tuple[int, ...]:
    h, w, _ = shape
    if spec.padding == "SAME":
        oh = -(-h // spec.stride)
        ow = -(-w // spec.stride)
    else:  # VALID
        oh = (h - spec.kernel) // spec.stride + 1
        ow = (w - spec.kernel) // spec.stride + 1
    if spec.pool > 1:
        oh //= spec.pool
        ow //= spec.pool
    return (oh, ow, spec.out_ch)


# ---------------------------------------------------------------------------
# The two CNNs from §VI-A.
# ---------------------------------------------------------------------------

def lenet5(num_classes: int = 10) -> LayeredModel:
    """LeNet-5 on CIFAR-10 (32x32x3), 5 trainable layers."""
    return LayeredModel(
        name="lenet5",
        specs=(
            ConvSpec("conv1", 6, 5, padding="VALID", pool=2),
            ConvSpec("conv2", 16, 5, padding="VALID", pool=2),
            DenseSpec("fc1", 120),
            DenseSpec("fc2", 84),
            DenseSpec("fc3", num_classes, relu=False),
        ),
        input_shape=(32, 32, 3),
        num_classes=num_classes,
    )


def alexnet(num_classes: int = 200) -> LayeredModel:
    """AlexNet (classic 224x224 geometry, tiny-ImageNet classes upscaled
    to the canonical input size, as the paper's Chainer reference does),
    8 trainable layers."""
    return LayeredModel(
        name="alexnet",
        specs=(
            ConvSpec("conv1", 64, 11, stride=4, padding="SAME", pool=2),
            ConvSpec("conv2", 192, 5, padding="SAME", pool=2),
            ConvSpec("conv3", 384, 3, padding="SAME"),
            ConvSpec("conv4", 256, 3, padding="SAME"),
            ConvSpec("conv5", 256, 3, padding="SAME", pool=2),
            DenseSpec("fc6", 4096),
            DenseSpec("fc7", 4096),
            DenseSpec("fc8", num_classes, relu=False),
        ),
        input_shape=(224, 224, 3),
        num_classes=num_classes,
    )


def alexnet_tiny(num_classes: int = 200) -> LayeredModel:
    """AlexNet on native 64x64 tiny-ImageNet (the small-input variant the
    smoke tests use)."""
    m = alexnet(num_classes)
    return LayeredModel(name="alexnet_tiny", specs=m.specs,
                        input_shape=(64, 64, 3),
                        num_classes=num_classes)

