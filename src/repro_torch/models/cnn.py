"""The paper's evaluation models (the reference's ``models/cnn.py``): the
MNIST CNN (105,866 parameters) and the downsized AlexNet (998,250).

Each conv is a 3x3 stride-1 convolution with SAME padding (padding 1),
a bias and a ReLU, then a 2x2 max pool that floors; two dense layers
follow.  Parameters keep the reference's layout, so
``bridge.from_numpy`` carries its trees with nothing transposed: conv
``w`` in HWIO and dense ``w`` as ``(in, out)``.  The forward permutes
inside: images come in NHWC, the convs run in NCHW through
``torch.nn.functional.conv2d``, and the activations go back to NHWC
before the flatten, because fc1's rows are in NHWC order.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Params = Dict[str, Any]


def init_cnn(gen: torch.Generator, device, *,
             image_shape: Tuple[int, int, int], channels: Tuple[int, ...],
             hidden: int, num_classes: int) -> Params:
    """Conv weights normal * sqrt(2 / fan_in), dense weights normal *
    1/sqrt(in), biases zero; drawn from ``gen`` in the order conv0, conv1,
    ..., fc1, fc2."""
    h, w, cin = image_shape
    tree: Params = {}
    c_prev = cin
    for i, c in enumerate(channels):
        tree[f"conv{i}"] = {
            "w": dense_init(gen, (3, 3, c_prev, c), device,
                            scale=(2.0 / (9 * c_prev)) ** 0.5),
            "b": torch.zeros((c,), device=device),
        }
        c_prev = c
        h, w = h // 2, w // 2  # 2x2 max pool after each conv
    tree["fc1"] = {"w": dense_init(gen, (h * w * c_prev, hidden), device),
                   "b": torch.zeros((hidden,), device=device)}
    tree["fc2"] = {"w": dense_init(gen, (hidden, num_classes), device),
                   "b": torch.zeros((num_classes,), device=device)}
    return tree


def cnn_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)
    i = 0
    while f"conv{i}" in params:
        p = params[f"conv{i}"]
        x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1)
        x = F.relu(x + p["b"][:, None, None])
        x = F.max_pool2d(x, 2)
        i += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def cnn_loss(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean cross-entropy of the batch's labels, fp32 log-softmax."""
    logp = F.log_softmax(cnn_forward(params, batch["images"])
                         .to(torch.float32), dim=-1)
    labels = batch["labels"].to(torch.int64)
    return -torch.gather(logp, 1, labels[:, None])[:, 0].mean()


def cnn_accuracy(params: Params, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    logits = cnn_forward(params, batch["images"])
    return (torch.argmax(logits, -1) == batch["labels"].to(torch.int64)) \
        .to(torch.float32).mean()


def param_count(params: Params) -> int:
    return sum(x.numel() for p in params.values() for x in p.values())


def make_paper_model(arch: str, gen: torch.Generator, device) -> Params:
    """The paper's model by arch id (``"mnist-cnn"`` | ``"cifar-alexnet"``)."""
    if arch == "mnist-cnn":
        from repro_torch.configs import mnist_cnn as C
    elif arch == "cifar-alexnet":
        from repro_torch.configs import cifar_alexnet as C
    else:
        raise KeyError(arch)
    return init_cnn(gen, device, image_shape=C.IMAGE_SHAPE,
                    channels=C.CHANNELS, hidden=C.HIDDEN,
                    num_classes=C.NUM_CLASSES)
