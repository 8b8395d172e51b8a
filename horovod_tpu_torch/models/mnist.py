"""The MNIST nets (counterpart of ``horovod_tpu/models/mnist.py``; the
framework's first-run example, ``train_mnist.py``).

Both take the registry's (B, 28, 28, 1) float32 images, or (B, 28, 28),
compute in f32 and return (B, 10) logits. flax's default initialisers:
lecun_normal (a normal truncated at two standard deviations, variance
1 / fan_in) for every kernel, zeros for the biases.

``MnistCNN`` is the LeNet-shaped net of the reference's torch example: conv
5x5 → 10, relu, 2x2 max-pool, conv 5x5 → 20, relu, max-pool, fc 50, relu,
dropout 0.5 in a forward with ``deterministic=False`` (``models/dropout.py``),
fc 10. The convolutions run NCHW; the (B, 20, 4, 4) activation is flattened
in the flax NHWC order, (h, w, c), so ``fc1`` holds the JAX kernel's rows
as they are.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import dropout


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax ``lecun_normal``: variance_scaling(1, fan_in, truncated_normal)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def _images(x: torch.Tensor) -> torch.Tensor:
    return (x[..., None] if x.dim() == 3 else x).float()


class _Layer(nn.Module):
    """A kernel and a bias; ``fan_in`` is the kernel's inputs per output."""

    def __init__(self, shape: Sequence[int], fan_in: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape, device=device))
        self.bias = nn.Parameter(torch.empty(shape[0], device=device))
        self.fan_in = fan_in

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.weight, self.fan_in, generator)
        with torch.no_grad():
            self.bias.zero_()


class Linear(_Layer):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__((cout, cin), cin, device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv(_Layer):
    """flax ``nn.Conv(cout, (k, k), padding="VALID")`` on NCHW."""

    def __init__(self, cin: int, cout: int, k: int, device=None):
        super().__init__((cout, cin, k, k), cin * k * k, device)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias)


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in model.modules():
        if isinstance(m, _Layer):
            m.reset_parameters(generator)


class MnistMLP(nn.Module):
    """flatten → Dense(f) → relu for each of ``features`` → Dense(10)."""

    def __init__(self, features: Sequence[int] = (128, 64), num_classes: int = 10,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [28 * 28, *features, num_classes]
        self.dense = nn.ModuleList(Linear(a, b, device) for a, b in zip(dims, dims[1:]))
        _init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _images(x).reshape(x.shape[0], -1)
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
        return self.dense[-1](x)


class MnistCNN(nn.Module):
    """See the module docstring."""

    def __init__(self, num_classes: int = 10, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv(1, 10, 5, device)
        self.conv2 = Conv(10, 20, 5, device)
        self.fc1 = Linear(4 * 4 * 20, 50, device)
        self.fc2 = Linear(50, num_classes, device)
        self.drop = dropout.Dropout(0.5)
        dropout.number_sites(self)
        _init(self, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        with dropout.scope(self, deterministic):
            x = _images(x).permute(0, 3, 1, 2)
            x = F.max_pool2d(torch.relu(self.conv1(x)), 2)
            x = F.max_pool2d(torch.relu(self.conv2(x)), 2)
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # the NHWC order
            x = self.drop(torch.relu(self.fc1(x)))
            return self.fc2(x)
