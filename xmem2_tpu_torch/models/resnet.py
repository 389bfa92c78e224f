"""ResNet trunks: ResNet-50 conv1..layer3 (key encoder) and ResNet-18
conv1..layer3 with extra input channels (value encoder).

Counterpart of xmem2_tpu/models/resnet.py (reference model/resnet.py:46-152).
Submodule names follow the reference state dict, e.g.
`layer1.0.conv1.weight`, `layer1.0.downsample.0` (conv) / `.1` (bn); the key
encoder names its layer1 `res2` (reference modules.py:162).
"""

from typing import Optional

import torch
from torch import nn

from xmem2_tpu_torch.nn import functional as XF
from xmem2_tpu_torch.ops.bn_epilogue import bn_epilogue


def to_compute_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x cast to the weight's dtype (the compute dtype), as the JAX package's
    conv2d(dtype=...) does. Under autocast (training's bf16 mode, float32
    weights) autocast picks the dtype itself: casting to the weight's first
    would copy every activation to float32 and back."""
    if torch.is_autocast_enabled(x.device.type):
        return x
    return x.to(w.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that casts its input to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(to_compute_dtype(x, self.weight))


class BatchNorm2d(nn.Module):
    """Frozen inference batch norm, computed in float32. Holds the reference
    state-dict names (weight, bias, running_mean, running_var); the
    checkpoint's num_batches_tracked counters are dropped on load. A call
    may add a residual and apply a ReLU after the norm: one pass on the card
    (ops/bn_epilogue.py)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        return bn_epilogue(x, self.weight, self.bias, self.running_mean,
                           self.running_var, residual, relu)


def conv3x3(cin, cout, stride=1):
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    """ResNet-18 block (reference model/resnet.py:46-75)."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, stride)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = conv3x3(cout, cout)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride=stride, bias=False),
                BatchNorm2d(cout))

    def forward(self, x):
        out = self.bn1(self.conv1(x), relu=True)
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn2(self.conv2(out), residual, relu=True)


class Bottleneck(nn.Module):
    """ResNet-50 block (reference model/resnet.py:78-114); `dilation` dilates
    and pads the 3x3 conv (the interactive layer's dilated trunks)."""
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride=stride, bias=False),
                BatchNorm2d(cout))

    def forward(self, x):
        out = self.bn1(self.conv1(x), relu=True)
        out = self.bn2(self.conv2(out), relu=True)
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn3(self.conv3(out), residual, relu=True)


def cast_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every parameter but the batch norms' in `dtype`, in place: the compute
    dtype of Conv2d, which casts its input to its weight's dtype (the JAX
    package's conv2d(dtype=...)); batch norm stays float32."""
    for m in model.modules():
        if not isinstance(m, BatchNorm2d):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


def make_layer(block, cin, planes, blocks, stride):
    cout = planes * getattr(block, 'expansion', 1)
    layers = [block(cin, planes, stride)]
    layers += [block(cout, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class Stem(nn.Module):
    """conv1 (7x7 s2) + bn + relu + maxpool (3x3 s2), shared by both trunks
    (the reference value encoder pools before its relu; max and relu
    commute)."""

    def __init__(self, cin):
        super().__init__()
        self.conv1 = Conv2d(cin, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)

    def stem(self, x):
        return XF.max_pool(self.bn1(self.conv1(x), relu=True), 3, 2, 1)


class ResNet50Trunk(Stem):
    """Key encoder trunk: returns (f4, f8, f16) = (res2, layer2, layer3)."""

    def __init__(self):
        super().__init__(3)
        self.res2 = make_layer(Bottleneck, 64, 64, 3, 1)
        self.layer2 = make_layer(Bottleneck, 256, 128, 4, 2)
        self.layer3 = make_layer(Bottleneck, 512, 256, 6, 2)

    def forward(self, x):
        f4 = self.res2(self.stem(x))
        f8 = self.layer2(f4)
        f16 = self.layer3(f8)
        return f4, f8, f16


class ResNet18Trunk(Stem):
    """Value encoder trunk: layer3 features (1/16, 256 channels)."""

    def __init__(self, cin):
        super().__init__(cin)
        self.layer1 = make_layer(BasicBlock, 64, 64, 2, 1)
        self.layer2 = make_layer(BasicBlock, 64, 128, 2, 2)
        self.layer3 = make_layer(BasicBlock, 128, 256, 2, 2)

    def trunk(self, x):
        return self.layer3(self.layer2(self.layer1(self.stem(x))))
