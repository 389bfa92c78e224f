"""Scribble-to-mask network: DeepLabV3+ with a ResNet-50 backbone accepting
6 input channels (image, previous mask, positive + negative scribbles).

Counterpart of xmem2_tpu/interactive/s2m/network.py. Parity targets in the
reference repo:
  - inference/interact/s2m/s2m_network.py:56 (deeplabv3plus_resnet50,
    output_stride=16: layer4 stride replaced with dilation 2)
  - inference/interact/s2m/_deeplab.py:30-54 (DeepLabHeadV3Plus), :113-165
    (ASPP with global-pool branch), the final bilinear upsample of
    _SimpleSegmentationModel (s2m/utils.py)
  - inference/interact/s2m/s2m_resnet.py (torchvision-style ResNet-50 with
    replace_stride_with_dilation)

The module carries the reference state-dict names (`backbone.*`,
`classifier.*`), so saves/s2m.pth loads with load_state_dict(strict=True).
Widths are read off a state dict (build_s2m), so narrow test networks take
the same code. NCHW; convolutions run in the weights' dtype, batch norm and
the resizes in float32, as the JAX package's dtype= convention.
"""

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from xmem2_tpu_torch.config import resolve_device
from xmem2_tpu_torch.models.resnet import BatchNorm2d, Bottleneck, Conv2d
from xmem2_tpu_torch.nn import functional as XF


def conv_bn_relu(cin: int, cout: int, k: int = 1, dilation: int = 1
                 ) -> nn.Sequential:
    """Sequential(conv (no bias), bn, relu): torch indices 0, 1, 2."""
    return nn.Sequential(
        Conv2d(cin, cout, k, padding=dilation * (k // 2), dilation=dilation,
               bias=False),
        BatchNorm2d(cout), nn.ReLU())


def dilated_layer(cin: int, planes: int, blocks: int, stride: int,
                  first_dilation: int, dilation: int) -> nn.Sequential:
    """Bottleneck stack: the first block strides (or not) at
    `first_dilation`, the rest run at `dilation`."""
    cout = planes * Bottleneck.expansion
    layers = [Bottleneck(cin, planes, stride, first_dilation)]
    layers += [Bottleneck(cout, planes, 1, dilation)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class S2MBackbone(nn.Module):
    """ResNet-50, output stride 16: returns (low_level=layer1, out=layer4).
    The layer4 stride folds into dilation (torchvision
    replace_stride_with_dilation: the first block at the previous dilation
    1, the others at 2; JAX _layer :40-51)."""

    def __init__(self, cin: int = 6, stem: int = 64, base: int = 64):
        super().__init__()
        self.conv1 = Conv2d(cin, stem, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(stem)
        e = Bottleneck.expansion
        self.layer1 = dilated_layer(stem, base, 3, 1, 1, 1)
        self.layer2 = dilated_layer(base * e, base * 2, 4, 2, 1, 1)
        self.layer3 = dilated_layer(base * 2 * e, base * 4, 6, 2, 1, 1)
        self.layer4 = dilated_layer(base * 4 * e, base * 8, 3, 1, 1, 2)

    def forward(self, x):
        x = XF.max_pool(self.bn1(self.conv1(x), relu=True), 3, 2, 1)
        low = self.layer1(x)
        return low, self.layer4(self.layer3(self.layer2(low)))


class ASPPPooling(nn.Sequential):
    """Global-pool branch: Sequential(pool, conv, bn, relu) whose 1x1 result
    is broadcast back to the input's size (reference _deeplab.py:118-133;
    a bilinear upsample of a 1x1 map is a broadcast, JAX :81-84)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         Conv2d(cin, cout, 1, bias=False), BatchNorm2d(cout),
                         nn.ReLU())

    def forward(self, x):
        gp = x.mean(dim=(2, 3), keepdim=True)
        for m in list(self)[1:]:
            gp = m(gp)
        return gp.expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    """1x1 + three dilated 3x3 + global-pool branch -> project (reference
    _deeplab.py:135-165; dropout is identity at inference)."""

    def __init__(self, cin: int, rates: Sequence[int] = (6, 12, 18),
                 cout: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn_relu(cin, cout)]
            + [conv_bn_relu(cin, cout, 3, r) for r in rates]
            + [ASPPPooling(cin, cout)])
        self.project = conv_bn_relu(cout * (len(rates) + 2), cout)

    def forward(self, x):
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class DeepLabHeadV3Plus(nn.Module):
    def __init__(self, cin: int, low_cin: int, ch: int = 256, low_ch: int = 48,
                 num_classes: int = 1):
        super().__init__()
        self.project = conv_bn_relu(low_cin, low_ch)
        self.aspp = ASPP(cin, (6, 12, 18), ch)
        self.classifier = nn.Sequential(
            *conv_bn_relu(low_ch + ch, ch, 3), Conv2d(ch, num_classes, 1))

    def forward(self, low, out):
        low = self.project(low)
        feat = XF.resize_bilinear(self.aspp(out), low.shape[-2:])
        return self.classifier(torch.cat([low, feat], dim=1))


class S2MNet(nn.Module):
    """deeplabv3plus_resnet50 with 6 input channels, output stride 16.
    forward: [B, 6, H, W] -> float32 logits [B, 1, H, W] (upsampled to the
    input size, JAX :103)."""

    def __init__(self, stem: int = 64, base: int = 64, ch: int = 256,
                 low_ch: int = 48):
        super().__init__()
        e = Bottleneck.expansion
        self.backbone = S2MBackbone(6, stem, base)
        self.classifier = DeepLabHeadV3Plus(base * 8 * e, base * e, ch,
                                            low_ch)

    def forward(self, x):
        h, w = x.shape[-2:]
        low, out = self.backbone(x)
        y = self.classifier(low, out)
        return XF.resize_bilinear(y.float(), (h, w))


def s2m_widths(sd: Mapping[str, np.ndarray]) -> Dict[str, int]:
    """S2MNet's constructor widths read off a reference-layout state dict."""
    return {'stem': int(sd['backbone.conv1.weight'].shape[0]),
            'base': int(sd['backbone.layer1.0.conv1.weight'].shape[0]),
            'ch': int(sd['classifier.aspp.project.0.weight'].shape[0]),
            'low_ch': int(sd['classifier.project.0.weight'].shape[0])}


def load_s2m_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The reference saves/s2m.pth (or a file of the same layout) as numpy
    arrays, num_batches_tracked dropped."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if not k.endswith('num_batches_tracked')}


def build_s2m(sd: Mapping[str, np.ndarray], device=None) -> S2MNet:
    """An S2MNet holding the state dict (float32, strict names) on `device`:
    CUDA unless the caller passes another."""
    device = resolve_device(device)
    with torch.device('meta'):
        model = S2MNet(**s2m_widths(sd))
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in sd.items()}, strict=True, assign=True)
    return model.to(device).eval().requires_grad_(False)
