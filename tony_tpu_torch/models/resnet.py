"""The ResNet family in PyTorch: the counterpart of
``tony_tpu/models/resnet.py`` (ResNet-50 is the north-star model of
``BASELINE.md``).

The module keeps the reference's interface and dtypes: it takes NHWC
images, computes in ``dtype`` (bf16 by default) over fp32 parameters and
fp32 batch statistics, and returns fp32 logits; the last norm of every
block starts at zero scale. Inside, activations run channels-last (the
NHWC input permuted to an NCHW view is already in that memory format),
which is what the card's convolutions want.

``forward(x, train)`` has the flax semantics. ``train=False`` normalises
by the running statistics. ``train=True`` normalises by the batch's
biased variance, computed as flax computes it (E[x^2] - E[x]^2 in fp32,
clipped at 0), and updates the running statistics in place with
momentum 0.9 and that biased variance (``nn.BatchNorm2d`` would take the
unbiased one).

Flax's ``"SAME"`` padding puts the odd pixel at the end: a stride-2 3x3
convolution or the 3x3 stride-2 max pool pads an even input by (0, 1),
where torch's symmetric ``padding=1`` would shift every window by one.
Both pad explicitly (``same_padding``).

Convolutions and pooling are cuDNN's through ``torch.nn.functional``,
as the reference computes them outside any Pallas kernel.
``models.convert.from_jax_resnet`` maps the reference's ``params`` and
``batch_stats`` onto this module's ``state_dict``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

CL = torch.channels_last
# flax nn.BatchNorm as the reference builds it (resnet.py:82-84)
MOMENTUM, EPS = 0.9, 1e-5


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of one spatial dim under ``"SAME"``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: a normal of variance 1 / fan_in,
    truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: an fp32 OIHW kernel, computed in
    ``dtype``; ``padding`` is ``"SAME"`` or ((top, bottom), (left,
    right))."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(
            cout, cin, k, k, dtype=torch.float32, device=device))

    def forward(self, x):
        if self.padding == "SAME":
            (t, b), (lt, r) = (same_padding(n, self.k, self.stride)
                               for n in x.shape[2:])
        else:
            (t, b), (lt, r) = self.padding
        if t or b or lt or r:
            x = F.pad(x, (lt, r, t, b))
        w = self.weight.to(self.dtype, memory_format=CL)
        return F.conv2d(x.to(self.dtype).contiguous(memory_format=CL), w,
                        stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim (``MOMENTUM``,
    ``EPS``): fp32 ``scale`` and ``bias`` parameters, fp32 ``mean`` and
    ``var`` buffers (flax's ``batch_stats``), output in ``dtype``."""

    def __init__(self, c: int, zero_scale: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.dtype, self.zero_scale = dtype, zero_scale
        self.scale = nn.Parameter(torch.zeros(c, **f32) if zero_scale
                                  else torch.ones(c, **f32))
        self.bias = nn.Parameter(torch.zeros(c, **f32))
        self.register_buffer("mean", torch.zeros(c, **f32))
        self.register_buffer("var", torch.ones(c, **f32))

    def forward(self, x, train: bool):
        if not train:
            # fused: (x - mean) * rsqrt(var + eps) * scale + bias in fp32
            return F.batch_norm(x.to(self.dtype), self.mean, self.var,
                                self.scale, self.bias, False, 0.0, EPS)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        with torch.no_grad():
            m = MOMENTUM
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + EPS) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class ResNetBlock(nn.Module):
    """Two 3x3 convolutions; a 1x1 projection where the shape changes."""

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, act: Callable = F.relu, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.act = act
        self.convs = nn.ModuleList([Conv(cin, filters, 3, strides, **kw),
                                    Conv(filters, filters, 3, **kw)])
        self.norms = nn.ModuleList([BatchNorm(filters, **kw),
                                    BatchNorm(filters, True, **kw)])
        self._proj(cin, filters, strides, kw)

    def _proj(self, cin: int, cout: int, strides: int, kw: dict) -> None:
        self.out_channels = cout
        self.conv_proj = self.norm_proj = None
        if cin != cout or strides != 1:
            self.conv_proj = Conv(cin, cout, 1, strides, **kw)
            self.norm_proj = BatchNorm(cout, **kw)

    def _residual(self, x, y, train: bool):
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), train)
        return self.act(x + y)

    def forward(self, x, train: bool):
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y), train)
            if i < len(self.convs) - 1:
                y = self.act(y)
        return self._residual(x, y, train)


class BottleneckResNetBlock(ResNetBlock):
    """1x1, strided 3x3, then 1x1 up to 4 x ``filters``."""

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, act: Callable = F.relu, device=None):
        nn.Module.__init__(self)
        kw = dict(dtype=dtype, device=device)
        self.act = act
        out = filters * 4
        self.convs = nn.ModuleList([Conv(cin, filters, 1, **kw),
                                    Conv(filters, filters, 3, strides, **kw),
                                    Conv(filters, out, 1, **kw)])
        self.norms = nn.ModuleList([BatchNorm(filters, **kw),
                                    BatchNorm(filters, **kw),
                                    BatchNorm(out, True, **kw)])
        self._proj(cin, out, strides, kw)


class ResNet(nn.Module):
    """``forward(x [B, H, W, 3], train) -> logits [B, num_classes]`` in
    fp32. ``device`` defaults to ``cuda``, which must exist; pass
    ``device="cpu"`` for the CPU."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, act: Callable = F.relu, device=None):
        super().__init__()
        from tony_tpu_torch.ops.platform import resolve_device

        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.act = dtype, act
        self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)), **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        blocks, cin = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2 ** i, strides,
                                        act=act, **kw))
                cin = blocks[-1].out_channels
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, dtype=torch.float32,
                              device=device)

    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """Seeded random weights as flax initialises them: lecun-normal
        kernels, zero biases, unit norm scales (zero on each block's
        last norm), running mean 0 and variance 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                elif isinstance(m, BatchNorm):
                    m.scale.fill_(0.0 if m.zero_scale else 1.0)
                    m.bias.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0)
            _lecun_normal_(self.head.weight, self.head.in_features,
                           generator)
            self.head.bias.zero_()
        return self

    def forward(self, x, train: bool = True):
        # NHWC permuted to NCHW: a view whose memory is channels-last
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.act(self.bn_init(self.conv_init(x), train))
        (t, b), (lt, r) = (same_padding(n, 3, 2) for n in x.shape[2:])
        x = F.max_pool2d(F.pad(x, (lt, r, t, b), value=-math.inf), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean(dim=(2, 3))
        return self.head(x.float()).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)
