"""fBRS click-to-mask model: DistMapsModel with a dilated (output-stride-8)
ResNet-50-v1s DeepLabV3+ and a separable-conv head.

Counterpart of xmem2_tpu/interactive/fbrs/model.py. Parity targets in the
reference repo:
  - DistMapsModel (rgb_conv 5->8->3, dist maps, feature extractor, head):
    fbrs/model/is_deeplab_model.py:30-78
  - DeepLabV3Plus (skip_project, ASPP rates 12/24/36 whose pooled branch
    nests under `gap`, _DeepLabHead of two separable convs):
    fbrs/model/modeling/deeplab_v3.py
  - ResNet-50-v1s: deep 3-conv stem, layer3 dilation 2, layer4 dilation 4
    (fbrs/model/modeling/resnetv1b.py:114-196)
  - SepConvHead: fbrs/model/modeling/basic_blocks.py:27-54
All interpolations here use align_corners=True, as in the reference. The
module carries the reference state-dict names, so fbrs.pth loads strictly;
widths are read off the state dict. NCHW.

The forward is split as the JAX package's (head_input, deeplab_head,
logits_from_deeplab, ...) so the f-BRS predictors can optimize a scale and
bias on intermediate features (predictor.py).
"""

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from xmem2_tpu_torch.interactive.s2m.network import conv_bn_relu, \
    dilated_layer
from xmem2_tpu_torch.models.resnet import BatchNorm2d, Bottleneck, Conv2d
from xmem2_tpu_torch.nn import functional as XF


class ResNetV1s(nn.Module):
    """Deep-stem dilated ResNet-50 (output stride 8). forward -> (c1, c4).
    resnetv1b._make_layer: the first block at dilation 1 (dilation <= 2) or
    dilation // 2 (dilation 4), the others at `dilation` (JAX :45-52)."""

    def __init__(self, stem: int = 32, base: int = 64):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2d(3, stem, 3, stride=2, padding=1, bias=False),
            BatchNorm2d(stem), nn.ReLU(),
            Conv2d(stem, stem, 3, padding=1, bias=False),
            BatchNorm2d(stem), nn.ReLU(),
            Conv2d(stem, 2 * stem, 3, padding=1, bias=False))
        self.bn1 = BatchNorm2d(2 * stem)
        e = Bottleneck.expansion
        self.layer1 = dilated_layer(2 * stem, base, 3, 1, 1, 1)
        self.layer2 = dilated_layer(base * e, base * 2, 4, 2, 1, 1)
        self.layer3 = dilated_layer(base * 2 * e, base * 4, 6, 1, 1, 2)
        self.layer4 = dilated_layer(base * 4 * e, base * 8, 3, 1, 2, 4)

    def forward(self, x):
        x = XF.max_pool(self.bn1(self.conv1(x), relu=True), 3, 2, 1)
        c1 = self.layer1(x)
        return c1, self.layer4(self.layer3(self.layer2(c1)))


class SeparableConv2d(nn.Module):
    """depthwise 3x3 (groups=cin) + pointwise + BN + relu (basic_blocks.py:
    57-73; body.0 dw, body.1 pw, body.2 bn)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False),
            Conv2d(cin, cout, 1, bias=False), BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.body(x)


class AsppPooling(nn.Module):
    """_AsppPooling: gap = Sequential(pool, conv, bn, relu), broadcast back
    (an align_corners upsample of a 1x1 map)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.gap = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 Conv2d(cin, cout, 1, bias=False),
                                 BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        gp = x.mean(dim=(2, 3), keepdim=True)
        for m in list(self.gap)[1:]:
            gp = m(gp)
        return gp.expand(-1, -1, *x.shape[-2:])


class FbrsASPP(nn.Module):
    """_ASPP (deeplab_v3.py:115-147); dropout is identity at inference."""

    def __init__(self, cin: int, ch: int, rates=(12, 24, 36)):
        super().__init__()
        self.concurent = nn.ModuleList(
            [conv_bn_relu(cin, ch)]
            + [conv_bn_relu(cin, ch, 3, r) for r in rates]
            + [AsppPooling(cin, ch)])
        self.project = conv_bn_relu(5 * ch, ch)

    def forward(self, x):
        return self.project(torch.cat([b(x) for b in self.concurent], dim=1))


class SkipProject(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.skip_project = conv_bn_relu(cin, cout)

    def forward(self, x):
        return self.skip_project(x)


class DeepLabHead(nn.Module):
    """_DeepLabHead: two separable convs + 1x1 (deeplab_v3.py:99-112)."""

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.block = nn.Sequential(SeparableConv2d(cin, ch),
                                   SeparableConv2d(ch, ch), Conv2d(ch, ch, 1))

    def forward(self, x):
        return self.block(x)


class DeepLabV3Plus(nn.Module):
    def __init__(self, stem: int = 32, base: int = 64, ch: int = 256,
                 skip: int = 32):
        super().__init__()
        e = Bottleneck.expansion
        self.backbone = ResNetV1s(stem, base)
        self.skip_project = SkipProject(base * e, skip)
        self.aspp = FbrsASPP(base * 8 * e, ch)
        self.head = DeepLabHead(ch + skip, ch)


class SepConvHead(nn.Module):
    """SepConvHead(1, in=ch, mid=ch//2, 2 layers)."""

    def __init__(self, ch: int):
        super().__init__()
        self.layers = nn.Sequential(SeparableConv2d(ch, ch // 2),
                                    SeparableConv2d(ch // 2, ch // 2),
                                    Conv2d(ch // 2, 1, 1))

    def forward(self, x):
        return self.layers(x)


class FBRSModel(nn.Module):
    """DistMapsModel over the DeepLabV3+ backbone. forward(image [B, 3, H, W]
    normalized, coord_features [B, 2, H, W]) -> float32 logits [B, 1, H, W]."""

    def __init__(self, stem: int = 32, base: int = 64, ch: int = 256,
                 skip: int = 32):
        super().__init__()
        self.rgb_conv = nn.Sequential(Conv2d(5, 8, 1), nn.LeakyReLU(0.2),
                                      BatchNorm2d(8), Conv2d(8, 3, 1))
        self.feature_extractor = DeepLabV3Plus(stem, base, ch, skip)
        self.head = SepConvHead(ch)

    @property
    def num_channels(self) -> int:
        """ch of the DeepLabV3Plus (JAX num_deeplab_channels)."""
        return self.feature_extractor.aspp.project[0].out_channels

    @property
    def num_c4_channels(self) -> int:
        return self.feature_extractor.aspp.concurent[0][0].in_channels

    def rgb_with_clicks(self, image, coord_features):
        """rgb_conv(concat(image, dist maps)) (is_deeplab_model.py:55-58)."""
        return self.rgb_conv(torch.cat([image, coord_features], dim=1))

    def backbone_features(self, x):
        """(skip-projected c1, c4): the f-BRS-A insertion operands
        (reference brs.py:126-137). x: rgb_conv output."""
        fe = self.feature_extractor
        c1, c4 = fe.backbone(x)
        return fe.skip_project(c1), c4

    def aspp_concat(self, c4, c1):
        """aspp(c4) upsampled to c1 + concat: the 'after_aspp' features
        (reference brs.py:94-99, 131-136)."""
        a = self.feature_extractor.aspp(c4)
        a = XF.resize_bilinear(a, c1.shape[-2:], align_corners=True)
        return torch.cat([a, c1], dim=1)

    def head_input(self, x):
        """'after_aspp' features for f-BRS-B (brs.py:121-141)."""
        c1, c4 = self.backbone_features(x)
        return self.aspp_concat(c4, c1)

    def deeplab_head(self, feats):
        """'after_aspp' -> 'after_deeplab' features."""
        return self.feature_extractor.head(feats)

    def logits_from_deeplab(self, x, out_hw):
        """'after_deeplab' features -> float32 logits at out_hw (SepConvHead
        + upsample, brs.py:101-104)."""
        return XF.resize_bilinear(self.head(x).float(), out_hw,
                                  align_corners=True)

    def forward(self, image, coord_features):
        x = self.rgb_with_clicks(image, coord_features)
        return self.logits_from_deeplab(
            self.deeplab_head(self.head_input(x)), image.shape[-2:])


def fbrs_widths(sd: Mapping[str, np.ndarray]) -> Dict[str, int]:
    """FBRSModel's constructor widths read off a reference-layout state
    dict (ch: the ASPP projection, reference deeplab_v3.py:27)."""
    fe = 'feature_extractor.'
    return {
        'stem': int(sd[fe + 'backbone.conv1.0.weight'].shape[0]),
        'base': int(sd[fe + 'backbone.layer1.0.conv1.weight'].shape[0]),
        'ch': int(sd[fe + 'aspp.project.0.weight'].shape[0]),
        'skip': int(sd[fe + 'skip_project.skip_project.0.weight'].shape[0])}
