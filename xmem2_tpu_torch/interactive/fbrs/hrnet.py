"""fBRS HRNet+OCR interactive-segmentation backbone, NCHW.

Counterpart of xmem2_tpu/interactive/fbrs/hrnet.py. Parity targets in the
reference repo:
  - HighResolutionNet (stem, layer1, 4-branch stages with transitions and
    multi-scale fusion, final upsample+concat): fbrs/model/modeling/
    hrnet_ocr.py:157-345; HighResolutionModule fusion rules :88-155
  - BasicBlockV1b / BottleneckV1b: fbrs/model/modeling/resnetv1b.py:6-80
  - SpatialGather / SpatialOCR / ObjectAttentionBlock2D: fbrs/model/
    modeling/ocr.py
  - DistMapsHRNetModel wrapper: fbrs/model/is_hrnet_model.py:24-66
The modules carry the reference state-dict names (transition1.1.0.0,
f_pixel.1.0, ...): passthrough transitions and same-branch fusions are
None entries of their ModuleLists, as in the reference. Small HRNets have 2
blocks a branch, big ones 4 (hrnet_ocr.py:170-205). All interpolations use
align_corners=True, as in the reference.
"""

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from xmem2_tpu_torch.models.resnet import (
    BasicBlock, BatchNorm2d, Bottleneck, Conv2d)
from xmem2_tpu_torch.nn import functional as XF


def _conv_bn(cin, cout, k=1, stride=1, relu=True) -> nn.Sequential:
    layers = [Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False), BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else \
        nn.Sequential(*layers)


class HighResolutionModule(nn.Module):
    """Per-branch basic blocks, then full multi-scale fusion
    (hrnet_ocr.py:129-155)."""

    def __init__(self, channels: List[int], num_blocks: int):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c) for _ in range(num_blocks)])
            for c in channels)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:      # 1x1 conv + bn, upsampled afterwards
                    row.append(_conv_bn(channels[j], channels[i], relu=False))
                elif j == i:
                    row.append(None)
                else:          # stride-2 chain, relu on all but the last
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j],
                                 channels[i] if k == i - j - 1
                                 else channels[j], 3, 2,
                                 relu=k != i - j - 1)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, f in enumerate(row):
                if j == i:
                    t = xs[j]
                else:
                    t = f(xs[j])
                    if j > i:
                        t = XF.resize_bilinear(t, xs[i].shape[-2:],
                                               align_corners=True)
                y = t if y is None else y + t
            out.append(torch.relu(y))
        return out


def _transition(pre: List[int], cur: List[int]) -> nn.ModuleList:
    """_make_transition_layer (hrnet_ocr.py:239-271)."""
    layers = []
    for i, c in enumerate(cur):
        if i < len(pre):
            layers.append(_conv_bn(pre[i], c, 3) if c != pre[i] else None)
        else:
            layers.append(nn.Sequential(*[
                _conv_bn(pre[-1], c if j == i - len(pre) else pre[-1], 3, 2)
                for j in range(i + 1 - len(pre))]))
    return nn.ModuleList(layers)


def _apply_transition(trans: nn.ModuleList, xs):
    out = []
    for i, t in enumerate(trans):
        x = xs[i] if i < len(xs) else xs[-1]
        out.append(x if t is None else t(x))
    return out


class OCRTower(nn.Sequential):
    """1x1 conv at even indices, Sequential(bn, relu) at odd (ocr.py:92-117).
    """

    def __init__(self, cin: int, cout: int, n_convs: int):
        layers = []
        for i in range(n_convs):
            layers += [Conv2d(cin if i == 0 else cout, cout, 1, bias=False),
                       nn.Sequential(BatchNorm2d(cout), nn.ReLU())]
        super().__init__(*layers)


class ObjectAttentionBlock2D(nn.Module):
    def __init__(self, cin: int, key_ch: int):
        super().__init__()
        self.f_pixel = OCRTower(cin, key_ch, 2)
        self.f_object = OCRTower(cin, key_ch, 2)
        self.f_down = OCRTower(cin, key_ch, 1)
        self.f_up = OCRTower(key_ch, cin, 1)

    def forward(self, feats, proxy):
        """feats [B, C, H, W]; proxy [B, C, K, 1] -> [B, C, H, W]."""
        b, _, h, w = feats.shape
        query = self.f_pixel(feats).flatten(2).float()          # [B, kc, P]
        key = self.f_object(proxy).flatten(2).float()            # [B, kc, K]
        value = self.f_down(proxy).flatten(2).float()
        kc = query.shape[1]
        sim = torch.softmax(query.mT @ key * kc ** -0.5, dim=-1)  # [B, P, K]
        # contiguous, as proxy below: a 1x1 convolution over this
        # transposed view would return channels-last activations
        ctx = (sim @ value.mT).mT.reshape(b, kc, h, w).contiguous()
        return self.f_up(ctx.to(feats.dtype))


class SpatialOCR(nn.Module):
    """SpatialOCR_Module (ocr.py:30-61): attention context + conv_bn."""

    def __init__(self, cin: int, key_ch: int):
        super().__init__()
        self.object_context_block = ObjectAttentionBlock2D(cin, key_ch)
        self.conv_bn_dropout = nn.Sequential(
            Conv2d(2 * cin, cin, 1, bias=False),
            nn.Sequential(BatchNorm2d(cin), nn.ReLU()))

    def forward(self, feats, context):
        """context [B, K, C] from spatial_gather."""
        proxy = context.mT[..., None].contiguous().to(feats.dtype)  # [B,C,K,1]
        ctx = self.object_context_block(feats, proxy)
        return self.conv_bn_dropout(torch.cat([ctx, feats], dim=1))


def spatial_gather(feats: torch.Tensor, probs: torch.Tensor,
                   scale: float = 1.0) -> torch.Tensor:
    """SpatialGather_Module (ocr.py:7-27): per-class softmax over space,
    context[k] = sum_p softmax(probs)[k, p] * feats[p], float32.
    feats [B, C, H, W]; probs [B, K, H, W] -> [B, K, C]."""
    pr = torch.softmax(scale * probs.flatten(2).float(), dim=2)    # [B, K, P]
    return pr @ feats.flatten(2).float().mT


class HighResolutionNet(nn.Module):
    def __init__(self, width: int = 18, ocr_width: int = 64,
                 small: bool = False, num_classes: int = 1):
        super().__init__()
        nb = 2 if small else 4
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if b == 0 else 256, 64)
                                      for b in range(nb)])
        pre = [256]
        for s, (branches, modules) in enumerate(
                ((2, 1), (3, 3 if small else 4), (4, 2 if small else 3)),
                start=1):
            cur = [width * 2 ** i for i in range(branches)]
            setattr(self, f'transition{s}', _transition(pre, cur))
            setattr(self, f'stage{s + 1}', nn.Sequential(
                *[HighResolutionModule(cur, nb) for _ in range(modules)]))
            pre = cur
        last = sum(pre)
        mid = 2 * ocr_width
        self.conv3x3_ocr = nn.Sequential(Conv2d(last, mid, 3, padding=1),
                                         BatchNorm2d(mid), nn.ReLU())
        self.ocr_distri_head = SpatialOCR(mid, ocr_width)
        self.cls_head = Conv2d(mid, num_classes, 1)
        self.aux_head = nn.Sequential(Conv2d(last, last, 1), BatchNorm2d(last),
                                      nn.ReLU(), Conv2d(last, num_classes, 1))

    def compute_hrnet_feats(self, x):
        """Stem -> layer1 -> stages 2..4 -> upsample+concat
        (hrnet_ocr.py:347-394). Returns [B, 15 * width, H/4, W/4]."""
        x = self.bn1(self.conv1(x), relu=True)
        x = self.bn2(self.conv2(x), relu=True)
        xs = [self.layer1(x)]
        for s in (1, 2, 3):
            xs = _apply_transition(getattr(self, f'transition{s}'), xs)
            xs = getattr(self, f'stage{s + 1}')(xs)
        hw = xs[0].shape[-2:]
        return torch.cat([xs[0]] + [
            XF.resize_bilinear(t, hw, align_corners=True) for t in xs[1:]],
            dim=1)

    def ocr(self, feats):
        """feats -> (the OCR output before cls_head, aux logits)."""
        out_aux = self.aux_head(feats)
        f = self.conv3x3_ocr(feats)
        return self.ocr_distri_head(f, spatial_gather(f, out_aux)), out_aux

    def forward(self, x):
        """(out, out_aux) logits at 1/4 resolution (hrnet_ocr.py:335-345)."""
        f, out_aux = self.ocr(self.compute_hrnet_feats(x))
        return self.cls_head(f), out_aux


class HRNetModel(nn.Module):
    """DistMapsHRNetModel: rgb_conv over [image | dist maps], HRNet+OCR,
    upsampled to the input size."""

    def __init__(self, width: int = 18, ocr_width: int = 64,
                 small: bool = False):
        super().__init__()
        self.rgb_conv = nn.Sequential(Conv2d(5, 8, 1), nn.LeakyReLU(0.2),
                                      BatchNorm2d(8), Conv2d(8, 3, 1))
        self.feature_extractor = HighResolutionNet(width, ocr_width, small)

    def rgb_with_clicks(self, image, coord_features):
        return self.rgb_conv(torch.cat([image, coord_features], dim=1))

    def forward(self, image, coord_features):
        out, _ = self.feature_extractor(
            self.rgb_with_clicks(image, coord_features))
        return XF.resize_bilinear(out.float(), image.shape[-2:],
                                  align_corners=True)


def is_hrnet_state_dict(sd: Mapping[str, np.ndarray]) -> bool:
    return 'feature_extractor.stage2.0.branches.0.0.conv1.weight' in sd


def hrnet_widths(sd: Mapping[str, np.ndarray]) -> Dict:
    """HRNetModel's constructor arguments read off a state dict: small has
    2 layer1 bottlenecks, big 4 (JAX predictor.py:36-52)."""
    fe = 'feature_extractor.'
    return {
        'width': int(sd[fe + 'stage2.0.branches.0.0.conv1.weight'].shape[0]),
        'ocr_width': int(sd[fe + 'conv3x3_ocr.0.weight'].shape[0]) // 2,
        'small': fe + 'layer1.2.conv1.weight' not in sd}
