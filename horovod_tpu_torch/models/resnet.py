"""ResNet v1.5 family in ``torch.nn`` (counterpart of
``horovod_tpu/models/resnet.py``).

The numerics follow the flax model, so weights carried across with
``models/convert.py`` give the same logits and the same updated batch
statistics:

* the input is the (N, H, W, 3) float32 batch the JAX model takes; inside,
  activations are NCHW tensors in ``channels_last`` memory, which is the
  flax NHWC layout in memory;
* parameters in ``param_dtype`` (f32), compute in ``dtype`` (bf16 by
  default): each convolution and the head cast their input and weights to
  ``dtype``; the logits are f32;
* flax ``nn.Conv`` pads ``"SAME"`` unless told otherwise: a stride-2 3x3
  conv on an even input pads 0 before and 1 after, so it is padded
  asymmetrically here before the convolution; ``conv_init`` has explicit
  (3, 3) padding;
* ``BatchNorm`` is flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: batch
  mean and E[x^2] - E[x]^2 variance (clamped at 0) in f32, normalised in f32
  and cast to ``dtype``, running stats ``ra = 0.9 ra + 0.1 batch`` with the
  biased variance; eval mode uses the running stats;
* the statistics are over the whole data-parallel batch: the JAX step
  shards the batch over ``dp`` under jit, so its means are global; here
  each rank holds its slice and the per-channel sums and count are
  all-reduced when the world is larger than one;
* ``fuse_bn_conv_stages`` routes the [norm -> relu -> 1x1 conv] tail of the
  bottleneck blocks of those stages through ``FusedBNReluConv1x1``
  (``ops/fused_bn_conv.py``: the CUDA kernel on the card, its plain version
  on the CPU).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_bn_conv import bn_relu_conv1x1
from ..ops.sync_batch_norm import _GlobalSum, _world

MOMENTUM = 0.9
EPSILON = 1e-5


# ---------------------------------------------------------------------------
# Batch statistics over the data-parallel group.
class _ChannelSums(torch.autograd.Function):
    """(sum over rows of x, sum over rows of x^2) in f32 for an (M, C)
    tensor. Saves x in its own dtype, not an f32 copy."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        return xf.sum(0), (xf * xf).sum(0)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        return (g1 + 2.0 * g2 * x.float()).to(x.dtype)


def batch_stats(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel of an (M, C) activation over the global
    batch, in f32: var = max(E[x^2] - E[x]^2, 0), as flax computes it."""
    s1, s2 = _ChannelSums.apply(x2d)
    count = torch.full((1,), float(x2d.shape[0]), device=x2d.device)
    if _world() > 1:
        packed = _GlobalSum.apply(torch.cat([s1, s2, count]))
        C = x2d.shape[1]
        s1, s2, count = packed[:C], packed[C:2 * C], packed[2 * C:]
    mean = s1 / count
    var = torch.clamp_min(s2 / count - mean * mean, 0.0)
    return mean, var


def _bn_apply_plain(x, mean, var, scale, bias, eps, dtype):
    y = (x.float() - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return y.to(dtype)


class _BNApply(torch.autograd.Function):
    """((x - mean) * rsqrt(var + eps) * scale + bias) in f32, cast to
    ``dtype``. Saves x in its own dtype; the backward recomputes the f32
    intermediates and differentiates them."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, eps, dtype):
        ctx.save_for_backward(x, mean, var, scale, bias)
        ctx.eps, ctx.dtype = eps, dtype
        return _bn_apply_plain(x, mean, var, scale, bias, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            y = _bn_apply_plain(*leaves, ctx.eps, ctx.dtype)
            grads = torch.autograd.grad(y, leaves, g)
        return (*grads, None, None)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N*H*W, C); a view for a channels_last tensor."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def _unrows(y2d: torch.Tensor, like: torch.Tensor, channels: int) -> torch.Tensor:
    N, _, H, W = like.shape
    return y2d.reshape(N, H, W, channels).permute(0, 3, 1, 2)


@torch.no_grad()
def _update_running(ra: torch.Tensor, batch: torch.Tensor, momentum: float):
    ra.copy_(momentum * ra + (1 - momentum) * batch)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` as the ResNet configures it (see the module
    docstring); ``scale_init`` is 1 or, on the last norm of a block, 0."""

    def __init__(self, features: int, dtype=torch.bfloat16, scale_init: float = 1.0,
                 momentum: float = MOMENTUM, eps: float = EPSILON, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))
        self.scale_init, self.momentum, self.eps, self.dtype = scale_init, momentum, eps, dtype
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(self.scale_init)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        x2d = _rows(x)
        if self.training:
            mean, var = batch_stats(x2d)
            _update_running(self.running_mean, mean, self.momentum)
            _update_running(self.running_var, var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y2d = _BNApply.apply(x2d, mean, var, self.weight, self.bias, self.eps, self.dtype)
        return _unrows(y2d, x, x.shape[1])


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME": output ceil(size / s), the extra pixel after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: f32 (O, I, kh, kw) weights cast to
    ``dtype``, "SAME" padding unless ``padding`` is given, and the
    variance_scaling(2, fan_out, normal) initialiser."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        cout, _, kh, kw = self.weight.shape
        self.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)), generator=generator)

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        if self.padding is not None:
            return F.conv2d(x, w, stride=self.stride, padding=self.padding)
        (ht, hb), (wl, wr) = (_same_pads(n, self.k, self.stride) for n in x.shape[2:])
        if ht == hb and wl == wr:
            return F.conv2d(x, w, stride=self.stride, padding=(ht, wl))
        x = F.pad(x, (wl, wr, ht, hb)).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride)


class FusedBNReluConv1x1(nn.Module):
    """BN-apply + ReLU + 1x1 conv in one pass over the activation through
    ``bn_relu_conv1x1``. Owns the BN state flax's BatchNorm would (batch
    stats in train mode, running-stat EMA) plus the conv kernel, kept
    (Cin, Cout) as the flax parameter is. The kernel's own output stats are
    discarded, as in the JAX module. Rows are padded with zeros to a
    multiple of 512 above 512 (the op's block contract) and sliced off."""

    def __init__(self, cin: int, features: int, dtype=torch.bfloat16,
                 momentum: float = MOMENTUM, eps: float = EPSILON, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(cin, device=device))
        self.bias = nn.Parameter(torch.empty(cin, device=device))
        self.kernel = nn.Parameter(torch.empty(cin, features, device=device))
        self.register_buffer("running_mean", torch.empty(cin, device=device))
        self.register_buffer("running_var", torch.empty(cin, device=device))
        self.features, self.dtype, self.momentum, self.eps = features, dtype, momentum, eps

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.kernel.normal_(0.0, math.sqrt(2.0 / self.features), generator=generator)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        x2d = _rows(x)
        if self.training:
            mu, var = batch_stats(x2d)
            _update_running(self.running_mean, mu, self.momentum)
            _update_running(self.running_var, var, self.momentum)
        else:
            mu, var = self.running_mean, self.running_var
        m = x2d.shape[0]
        pad = (-m) % 512 if m > 512 else 0
        if pad:
            x2d = F.pad(x2d, (0, 0, 0, pad))
        y2d, _, _ = bn_relu_conv1x1(x2d.contiguous(), mu, var, self.scale, self.bias,
                                    self.kernel.to(self.dtype), self.eps)
        return _unrows(y2d[:m], x, self.features)


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(cin, filters, 3, stride, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = Conv(filters, filters, 3, **kw)
        self.bn2 = BatchNorm(filters, scale_init=0.0, **kw)
        self.proj = stride != 1 or cin != filters
        if self.proj:
            self.conv_proj = Conv(cin, filters, 1, stride, **kw)
            self.norm_proj = BatchNorm(filters, **kw)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return torch.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck (ResNet-50/101/152).
    ``fuse_bn_conv1x1`` routes the [norm -> relu -> 1x1 conv] tail through
    ``FusedBNReluConv1x1``."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.bfloat16,
                 device=None, fuse_bn_conv1x1: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = filters * 4
        self.fused = fuse_bn_conv1x1
        self.conv1 = Conv(cin, filters, 1, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = Conv(filters, filters, 3, stride, **kw)
        if fuse_bn_conv1x1:
            self.fused_bn_conv3 = FusedBNReluConv1x1(filters, out, **kw)
        else:
            self.bn2 = BatchNorm(filters, **kw)
            self.conv3 = Conv(filters, out, 1, **kw)
        self.bn3 = BatchNorm(out, scale_init=0.0, **kw)
        self.proj = stride != 1 or cin != out
        if self.proj:
            self.conv_proj = Conv(cin, out, 1, stride, **kw)
            self.norm_proj = BatchNorm(out, **kw)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.conv2(y)
        if self.fused:
            y = self.fused_bn_conv3(y)
        else:
            y = self.conv3(torch.relu(self.bn2(y)))
        y = self.bn3(y)
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """``forward(images)`` takes (N, H, W, 3) float32 and returns (N,
    num_classes) f32 logits; ``train()``/``eval()`` pick batch or running
    statistics, as the JAX model's ``train`` argument does."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16,
                 fuse_bn_conv_stages: Sequence[int] = (), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        blocks, cin = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2 ** i
                fuse = {}
                if i in fuse_bn_conv_stages and block_cls is BottleneckResNetBlock:
                    fuse["fuse_bn_conv1x1"] = True
                blocks.append(block_cls(cin, filters, 2 if i > 0 and j == 0 else 1,
                                        **fuse, **kw))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers: variance_scaling(2, fan_out, normal) for
        the convolutions and the fused kernel, lecun_normal (truncated) for
        the head, zero biases, unit (or zero) BN scales, running mean 0 and
        variance 1. Draws from ``generator`` (on the parameters' device)."""
        for mod in self.modules():
            if isinstance(mod, (Conv, FusedBNReluConv1x1)):
                mod.reset_parameters(generator)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()
        fan_in = self.head.in_features
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.head.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.head.bias.zero_()

    def forward(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2)     # channels_last NCHW view
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        x = x.float().mean((2, 3)).to(self.dtype)
        dt = self.dtype
        return F.linear(x, self.head.weight.to(dt), self.head.bias.to(dt)).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)

RESNET_CONFIGS = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
}
