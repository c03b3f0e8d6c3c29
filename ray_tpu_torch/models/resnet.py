"""ResNet-18/34/50/101 in plain PyTorch (port of ray_tpu/models/resnet.py),
the model of the DDP reference configuration (ResNet-50 on CIFAR-10).

Functional, with the JAX package's trees: `apply(params, state, x,
config, train)` returns (logits, new batch-norm state). Weights keep the
JAX layouts (convolutions HWIO, images NHWC at the boundary) so they
carry across one-to-one (`params_from_numpy`); inside, activations are
NCHW views of channels-last memory and convolutions run through
`torch.nn.functional.conv2d` (cuDNN on the card; the JAX package's
`lax.conv_general_dilated` is no Pallas kernel either).

Numerics follow the JAX package, not `torch.nn`: batch norm is a function
whose running variance takes the biased batch variance, `new = m·old +
(1-m)·batch`; "SAME" padding pads (total // 2) before and the rest after,
so a stride-2 convolution on an even size pads 0 before and 1 after, and
the stem's max pool likewise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import resolve_device, to_torch

STAGES = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: str = "resnet50"
    num_classes: int = 10
    width: int = 64
    small_inputs: bool = True     # CIFAR stem (3x3, no maxpool)
    dtype: Any = torch.float32
    bn_momentum: float = 0.9


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (n, c, h, w); w: HWIO. "SAME" padding, as the JAX package's."""
    kh, kw = w.shape[0], w.shape[1]
    (t, b), (lft, r) = (_same_pads(x.shape[2], kh, stride),
                        _same_pads(x.shape[3], kw, stride))
    if (t, lft) != (b, r):
        x, pad = F.pad(x, (lft, r, t, b)), 0
    else:
        pad = (t, lft)
    return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                    padding=pad)


def batch_norm(x, p, s, train: bool, momentum: float):
    """x: (n, c, h, w). Train: batch statistics (biased variance) and the
    running update new = momentum·old + (1-momentum)·batch."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
        # The running stats are an output, not differentiated (JAX's aux).
        bm, bv = mean.detach(), var.detach()
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * bm,
                 "var": momentum * s["var"] + (1 - momentum) * bv}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(var + 1e-5).to(x.dtype).view(shape)
    out = ((x - mean.to(x.dtype).view(shape)) * inv
           * p["scale"].to(x.dtype).view(shape)
           + p["bias"].to(x.dtype).view(shape))
    return out, new_s


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, "SAME" (padding with -inf)."""
    (t, b), (lft, r) = _same_pads(x.shape[2], 3, 2), _same_pads(
        x.shape[3], 3, 2)
    x = F.pad(x, (lft, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def init(config: ResNetConfig, generator: torch.Generator,
         device="cuda") -> Tuple[Dict, Dict]:
    """He-normal convolutions (HWIO), N(0, 0.01²) head, unit batch-norm
    scales and zero biases, running stats (0, 1): the JAX package's trees,
    drawn from `generator` (which must live on `device`), fp32."""
    dev = resolve_device(device)

    def conv_w(kh, kw, cin, cout):
        return torch.randn((kh, kw, cin, cout), generator=generator,
                           device=dev) * math.sqrt(2.0 / (kh * kw * cin))

    def bn(c):
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev)}

    def bn_state(c):
        return {"mean": torch.zeros(c, device=dev),
                "var": torch.ones(c, device=dev)}

    blocks, bottleneck = STAGES[config.depth]
    w = config.width
    stem_k = 3 if config.small_inputs else 7
    params: Dict = {"stem": {"conv": conv_w(stem_k, stem_k, 3, w),
                             "bn": bn(w)}}
    state: Dict = {"stem": bn_state(w)}
    cin = w
    for si, n in enumerate(blocks):
        cmid = w * (2 ** si)
        cout = cmid * (4 if bottleneck else 1)
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            bp: Dict = {}
            bs: Dict = {}
            if bottleneck:
                bp["conv1"] = conv_w(1, 1, cin, cmid)
                bp["conv2"] = conv_w(3, 3, cmid, cmid)
                bp["conv3"] = conv_w(1, 1, cmid, cout)
                chans = (("1", cmid), ("2", cmid), ("3", cout))
            else:
                bp["conv1"] = conv_w(3, 3, cin, cmid)
                bp["conv2"] = conv_w(3, 3, cmid, cout)
                chans = (("1", cmid), ("2", cout))
            for i, c in chans:
                bp[f"bn{i}"] = bn(c)
                bs[f"bn{i}"] = bn_state(c)
            if stride != 1 or cin != cout:
                bp["proj"] = conv_w(1, 1, cin, cout)
                bp["proj_bn"] = bn(cout)
                bs["proj_bn"] = bn_state(cout)
            params[f"s{si}b{bi}"] = bp
            state[f"s{si}b{bi}"] = bs
            cin = cout
    params["head"] = {
        "w": torch.randn((cin, config.num_classes), generator=generator,
                         device=dev) * 0.01,
        "b": torch.zeros(config.num_classes, device=dev)}
    return params, state


def params_from_numpy(tree: Dict, device="cuda",
                      dtype=torch.float32) -> Dict:
    """A JAX param or state tree (`jax.tree.map(np.asarray, ...)`) as the
    port's tensors on `device` (fp32 unless `dtype` says otherwise), same
    keys and layouts."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return to_torch(np.asarray(tree)).to(dev, dtype, copy=True)


def apply(params: Dict, state: Dict, x: torch.Tensor, config: ResNetConfig,
          train: bool = True) -> Tuple[torch.Tensor, Dict]:
    """x: (n, h, w, 3) -> logits (n, classes) in the head's dtype (fp32),
    new batch-norm state."""
    blocks, bottleneck = STAGES[config.depth]
    mom = config.bn_momentum
    x = x.to(config.dtype).permute(0, 3, 1, 2)     # channels-last NCHW
    new_state: Dict = {}
    p = params["stem"]
    x = conv(x, p["conv"], stride=1 if config.small_inputs else 2)
    x, new_state["stem"] = batch_norm(x, p["bn"], state["stem"], train, mom)
    x = torch.relu(x)
    if not config.small_inputs:
        x = _max_pool_same(x)
    for si, n in enumerate(blocks):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            name = f"s{si}b{bi}"
            bp, bs = params[name], state[name]
            ns: Dict = {}
            if bottleneck:
                y, ns["bn1"] = batch_norm(conv(x, bp["conv1"]), bp["bn1"],
                                          bs["bn1"], train, mom)
                y, ns["bn2"] = batch_norm(conv(torch.relu(y), bp["conv2"],
                                               stride),
                                          bp["bn2"], bs["bn2"], train, mom)
                y, ns["bn3"] = batch_norm(conv(torch.relu(y), bp["conv3"]),
                                          bp["bn3"], bs["bn3"], train, mom)
            else:
                y, ns["bn1"] = batch_norm(conv(x, bp["conv1"], stride),
                                          bp["bn1"], bs["bn1"], train, mom)
                y, ns["bn2"] = batch_norm(conv(torch.relu(y), bp["conv2"]),
                                          bp["bn2"], bs["bn2"], train, mom)
            shortcut = x
            if "proj" in bp:
                shortcut, ns["proj_bn"] = batch_norm(
                    conv(x, bp["proj"], stride), bp["proj_bn"],
                    bs["proj_bn"], train, mom)
            x = torch.relu(y + shortcut)
            new_state[name] = ns
    x = x.mean(dim=(2, 3))
    head = params["head"]
    logits = x.to(head["w"].dtype) @ head["w"] + head["b"]
    return logits, new_state


def loss_fn(params, state, batch, config: ResNetConfig):
    """batch: {"image": (n, h, w, 3), "label": (n,) int} -> (mean cross
    entropy, {"loss", "accuracy", "state": the new batch-norm state})."""
    logits, new_state = apply(params, state, batch["image"], config,
                              train=True)
    labels = batch["label"].long()
    loss = -torch.log_softmax(logits, dim=-1).gather(
        -1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc, "state": new_state}
