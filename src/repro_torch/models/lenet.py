"""LeNet-5 — the paper's evaluation network (MNIST, Table I), NHWC.

conv(1→6, 5×5) → avgpool 2×2 → conv(6→16, 5×5) → avgpool 2×2 →
fc(256→120) → fc(120→84) → fc(84→10) on 28×28 inputs.  A compressed conv
(a :class:`~repro_torch.core.dispatch.ConvPayload` from ``compile_lenet``)
runs through :func:`~repro_torch.core.dispatch.conv_dispatch`, a compressed
FC through :func:`~repro_torch.core.dispatch.payload_dispatch`; with a
fusion plan each conv's pool rides its kernel's emit and fc1→fc2→fc3 run as
one ``fc_stack_matmul`` launch.  An uncompressed layer is the plain masked
dense layer (``F.conv2d`` on NCHW views of the NHWC tensors, ``@``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.cost_model import LayerSpec
from ..core.dispatch import (
    ConvPayload,
    conv_dispatch,
    fc_stack_dispatch,
    payload_dispatch,
    resolve as resolve_dispatch,
)
from ..core.families._util import he_init
from ..core.quant import fake_quant
from ..device import resolve_device
from ..kernels.sparse_matmul.kernel import pool_nhwc

__all__ = ["ACT_IN_ELEMS", "ACT_OUT_ELEMS", "CONV_OUT_HW", "LAYERS",
           "LENET_CONV_IN_HW", "init_lenet", "lenet_forward",
           "lenet_fusion_plan", "lenet_layer_specs", "lenet_loss"]

Params = Dict[str, torch.Tensor]

# (name, kind, shape): conv (kh, kw, cin, cout), fc (K, N)
LAYERS = [
    ("conv1", "conv", (5, 5, 1, 6)),    # out 24x24x6 -> pool 12x12x6
    ("conv2", "conv", (5, 5, 6, 16)),   # out 8x8x16  -> pool 4x4x16
    ("fc1", "linear", (256, 120)),
    ("fc2", "linear", (120, 84)),
    ("fc3", "linear", (84, 10)),
]

# Static conv geometry on the 28x28 input (VALID, stride 1)
CONV_OUT_HW = {"conv1": (24, 24), "conv2": (8, 8)}
LENET_CONV_IN_HW = {"conv1": (28, 28), "conv2": (12, 12)}
ACT_IN_ELEMS = {"conv1": 28 * 28 * 1, "conv2": 12 * 12 * 6,
                "fc1": 256, "fc2": 120, "fc3": 84}
ACT_OUT_ELEMS = {"conv1": 24 * 24 * 6, "conv2": 8 * 8 * 16,
                 "fc1": 120, "fc2": 84, "fc3": 10}

_AVG2 = ("avg", 2)


def init_lenet(seed: int = 0, device=None) -> Params:
    """``{name_w, name_b}``: weights normal / sqrt(fan_in) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    ``device="cpu"``), biases zero."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = {}
    for name, _, shape in LAYERS:
        fan_in = int(np.prod(shape[:-1]))
        params[name + "_w"] = he_init(gen, shape, torch.float32, fan_in)
        params[name + "_b"] = torch.zeros((shape[-1],), dtype=torch.float32,
                                          device=dev)
    return params


def _conv(x, w, b):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1) + b


def lenet_fusion_plan(compressed) -> Dict[str, object]:
    """The layer-fusion plan of a compressed LeNet: ``{name: {"pool":
    ("avg", 2)}}`` for each compressed conv (the pool runs in the conv
    kernel's emit) and ``"fc_stack": ("fc1", "fc2", "fc3")`` when all three
    FC layers are compressed (one fused launch)."""
    plan: Dict[str, object] = {}
    if not compressed:
        return plan
    for name in ("conv1", "conv2"):
        if isinstance(compressed.get(name), ConvPayload):
            plan[name] = {"pool": _AVG2}
    if all(n in compressed for n in ("fc1", "fc2", "fc3")):
        plan["fc_stack"] = ("fc1", "fc2", "fc3")
    return plan


def lenet_forward(
    params: Params,
    images: torch.Tensor,                      # (B, 28, 28, 1)
    masks: Optional[Dict[str, torch.Tensor]] = None,
    compressed: Optional[Dict[str, object]] = None,
    qat_bits: Optional[Dict[str, int]] = None,
    dispatch=None,
    fusion=None,
) -> torch.Tensor:
    """Logits (B, 10).  ``masks`` applies static pruning to the dense
    layers; ``qat_bits`` ({name: bits}) fake-quantises their weights per
    output channel with a straight-through gradient (quantisation-aware
    re-sparse fine-tuning); ``compressed`` switches named layers (convs and
    FCs) to their compiled payloads; ``dispatch`` selects kernel or plain
    versions ("auto" | "kernel" | "twin" | None = ``REPRO_TORCH_DISPATCH``);
    ``fusion=True`` derives :func:`lenet_fusion_plan` from ``compressed``,
    a dict is used as the plan, None/False runs layer by layer."""
    dcfg = resolve_dispatch(dispatch)
    if fusion is True:
        plan = lenet_fusion_plan(compressed)
    elif isinstance(fusion, dict):
        plan = fusion
    else:
        plan = {}

    def w(name):
        ww = params[name + "_w"]
        if masks is not None and name in masks:
            ww = ww * masks[name].to(ww.dtype)
        if qat_bits and name in qat_bits:
            ww = fake_quant(ww, qat_bits[name], axis=-1)
        return ww

    def conv_block(name, x):
        cw = compressed.get(name) if compressed is not None else None
        if cw is None:
            return pool_nhwc(torch.relu(_conv(x, w(name), params[name + "_b"])),
                             _AVG2)
        entry = plan.get(name)
        pool = entry.get("pool") if isinstance(entry, dict) else None
        y = conv_dispatch(cw, x, dispatch=dcfg, bias=params[name + "_b"],
                          activation="relu", leaf=name, pool=pool)
        return y if pool is not None else pool_nhwc(y, _AVG2)

    x = conv_block("conv1", images)
    x = conv_block("conv2", x)
    x = x.reshape(x.shape[0], -1)  # (B, 256)

    stack = plan.get("fc_stack")
    if stack and compressed is not None \
            and all(n in compressed for n in stack):
        return fc_stack_dispatch(
            [compressed[n] for n in stack], x,
            biases=[params[n + "_b"] for n in stack],
            activations=["relu" if n != stack[-1] else None for n in stack],
            dispatch=dcfg, leaves=tuple(stack))

    for name in ("fc1", "fc2", "fc3"):
        act = "relu" if name != "fc3" else None
        cw = compressed.get(name) if compressed is not None else None
        if cw is not None:
            x = payload_dispatch(cw, x, dispatch=dcfg,
                                 bias=params[name + "_b"], activation=act,
                                 leaf=name)
        else:
            y = x @ w(name) + params[name + "_b"]
            x = torch.relu(y) if name != "fc3" else y
    return x


def lenet_loss(params: Params, images: torch.Tensor, labels: torch.Tensor,
               masks: Optional[Dict[str, torch.Tensor]] = None,
               qat_bits: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Mean cross-entropy of the dense (optionally masked / fake-quantised)
    forward."""
    logits = lenet_forward(params, images, masks=masks, qat_bits=qat_bits)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.to(torch.int64)[:, None]).mean()


def lenet_layer_specs(
    batch: int = 1,
    densities: Optional[Dict[str, Tuple[float, float]]] = None,
) -> List[LayerSpec]:
    """Layer IR for the DSE and the compile pass's policy pick
    (per-invocation numbers, as ``repro.models.lenet.lenet_layer_specs``).

    densities: {layer: (max_block_density, max_element_density)} from the
    reference global-magnitude pruning pass.
    """
    densities = densities or {}
    specs = []
    for name, kind, shape in LAYERS:
        wel = int(np.prod(shape))
        if kind == "conv":
            flops = 2.0 * wel * int(np.prod(CONV_OUT_HW[name])) * batch
        else:
            flops = 2.0 * wel * batch
        bd, ed = densities.get(name, (1.0, 1.0))
        specs.append(LayerSpec(
            name=name, kind=kind, flops=flops, weight_elems=wel,
            act_bytes=4.0 * batch * (ACT_IN_ELEMS[name] + ACT_OUT_ELEMS[name]),
            max_block_density=bd, max_element_density=ed,
        ))
    return specs
