"""The XMem network in plain PyTorch, float32, written from the published
equations (Cheng and Schwing, "XMem", ECCV 2022; github.com/hkchengrex/XMem
model/network.py, modules.py, group_modules.py, cbam.py, resnet.py).

Functional: every layer reads its weights from a state dict with the
reference checkpoint's names, so the benchmark hands this file the same
.pth file that the program loads. Imports nothing of the program.

Precision: a `Precision` object decides how each convolution and linear
layer rounds its operands. The default computes in float32 with TF32 off;
`Precision('fp8')` is the benchmark's control, one step below the
configuration's precisions (see Precision). A `FlopCounter` adds up the multiply-adds of every product, so
the work counts come from this file at the cell's shapes.
"""

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class FlopCounter:
    """Floating-point operations of the convolutions and linear layers
    (2 per multiply-add) while it is the active counter of a Precision."""

    def __init__(self):
        self.flops = 0.0


class Precision:
    """'f32': products in float32, TF32 off. 'fp8', the step below the
    configuration's precisions: each convolution's and linear layer's
    operands, and the values stored in memory, rounded to float8 e4m3
    (per-tensor scale to the format's largest normal), then multiplied in
    float32; the similarity, stated in float32 without TF32, in TF32."""

    def __init__(self, name: str = 'f32', counter: Optional[FlopCounter] = None):
        if name not in ('f32', 'fp8'):
            raise ValueError(f'unknown precision {name!r}')
        self.name = name
        self.counter = counter

    def round(self, x: Tensor) -> Tensor:
        if self.name == 'f32' or x.device.type == 'meta':
            return x
        with torch.no_grad():
            amax = x.abs().amax().clamp_min(1e-12)
            scale = 448.0 / amax
            q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        # the rounded value, written as x plus a detached difference
        return x + (q - x).detach()

    @contextlib.contextmanager
    def similarity(self):
        """The similarity's products: TF32 for 'fp8', float32 otherwise."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.name == 'fp8'
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def conv(self, x: Tensor, w: Tensor, b: Optional[Tensor], stride=1,
             padding=0) -> Tensor:
        out = F.conv2d(self.round(x), self.round(w), b, stride, padding)
        if self.counter is not None:
            self.counter.flops += 2.0 * out.numel() * w[0].numel()
        return out

    def linear(self, x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
        out = F.linear(self.round(x), self.round(w), b)
        if self.counter is not None:
            self.counter.flops += 2.0 * out.numel() * w.shape[1]
        return out


class XMemRef:
    """encode_key / encode_value / segment of XMem over a state dict. The
    last call's frame features, value-encoder trunk features, readout and
    mask logits stay readable (last_*) for weights.calibrate."""

    def __init__(self, sd: Dict[str, Tensor], device, prec: Precision = None):
        self.sd = {k: v.to(device=device, dtype=torch.float32)
                   for k, v in sd.items() if v.is_floating_point()}
        self.p = prec or Precision()
        self.hidden_dim = self.sd['decoder.hidden_update.transform.weight'] \
            .shape[0] // 3

    # -- primitives -----------------------------------------------------------
    def conv(self, name, x, stride=1, padding=None):
        w = self.sd[name + '.weight']
        pad = (w.shape[-1] // 2) if padding is None else padding
        return self.p.conv(x, w, self.sd.get(name + '.bias'), stride, pad)

    def bn(self, name, x):
        sd = self.sd
        scale = sd[name + '.weight'] / torch.sqrt(sd[name + '.running_var']
                                                  + 1e-5)
        shift = sd[name + '.bias'] - sd[name + '.running_mean'] * scale
        return x * scale[:, None, None] + shift[:, None, None]

    def gconv(self, name, g, **kw):
        """A convolution applied to every object of g [B, N, C, H, W]."""
        b, n = g.shape[:2]
        out = self.conv(name, g.flatten(0, 1), **kw)
        return out.reshape((b, n) + out.shape[1:])

    # -- ResNet trunks ----------------------------------------------------------
    def stem(self, pre, x):
        x = torch.relu(self.bn(pre + 'bn1', self.conv(pre + 'conv1', x,
                                                      stride=2, padding=3)))
        return F.max_pool2d(x, 3, 2, 1)

    def bottleneck(self, pre, x, stride):
        out = torch.relu(self.bn(pre + '.bn1', self.conv(pre + '.conv1', x)))
        out = torch.relu(self.bn(pre + '.bn2', self.conv(
            pre + '.conv2', out, stride=stride, padding=1)))
        out = self.bn(pre + '.bn3', self.conv(pre + '.conv3', out))
        if pre + '.downsample.0.weight' in self.sd:
            x = self.bn(pre + '.downsample.1', self.conv(
                pre + '.downsample.0', x, stride=stride, padding=0))
        return torch.relu(out + x)

    def basic(self, pre, x, stride):
        out = torch.relu(self.bn(pre + '.bn1', self.conv(
            pre + '.conv1', x, stride=stride, padding=1)))
        out = self.bn(pre + '.bn2', self.conv(pre + '.conv2', out, padding=1))
        if pre + '.downsample.0.weight' in self.sd:
            x = self.bn(pre + '.downsample.1', self.conv(
                pre + '.downsample.0', x, stride=stride, padding=0))
        return torch.relu(out + x)

    def layer(self, pre, x, blocks, stride, block):
        for i in range(blocks):
            x = block(f'{pre}.{i}', x, stride if i == 0 else 1)
        return x

    # -- group blocks -------------------------------------------------------------
    def res_block(self, pre, g):
        out = self.gconv(pre + '.conv1', torch.relu(g))
        out = self.gconv(pre + '.conv2', torch.relu(out))
        if pre + '.downsample.weight' in self.sd:
            g = self.gconv(pre + '.downsample', g)
        return out + g

    def cbam(self, pre, x):
        def mlp(v):
            v = torch.relu(self.p.linear(v, self.sd[pre + '.ChannelGate.mlp.1.weight'],
                                         self.sd[pre + '.ChannelGate.mlp.1.bias']))
            return self.p.linear(v, self.sd[pre + '.ChannelGate.mlp.3.weight'],
                                 self.sd[pre + '.ChannelGate.mlp.3.bias'])
        att = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        x = x * att[:, :, None, None]
        pooled = torch.cat([x.amax(dim=1, keepdim=True),
                            x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(pre + '.SpatialGate.spatial.conv',
                                           pooled))

    def fusion(self, pre, x, g):
        """FeatureFusionBlock: x [B, C, h, w] broadcast to every object."""
        n = g.shape[1]
        g = torch.cat([x[:, None].expand((x.shape[0], n) + x.shape[1:]), g],
                      dim=2)
        g = self.res_block(pre + '.block1', g)
        r = self.cbam(pre + '.attention', g.flatten(0, 1)).reshape(g.shape)
        return self.res_block(pre + '.block2', g + r)

    def gru(self, values, h):
        c = self.hidden_dim
        forget = torch.sigmoid(values[:, :, :c])
        update = torch.sigmoid(values[:, :, c:2 * c])
        new = torch.tanh(values[:, :, 2 * c:])
        return forget * h * (1.0 - update) + update * new

    # -- the three calls of inference -------------------------------------------
    def encode_key(self, frame: Tensor):
        """frame [B, 3, H, W] -> (key, shrinkage, selection, f16, f8, f4)."""
        pre = 'key_encoder.'
        x = self.stem(pre, frame)
        f4 = self.layer(pre + 'res2', x, 3, 1, self.bottleneck)
        f8 = self.layer(pre + 'layer2', f4, 4, 2, self.bottleneck)
        f16 = self.layer(pre + 'layer3', f8, 6, 2, self.bottleneck)
        self.last_f16 = f16
        key = self.conv('key_proj.key_proj', f16)
        shrinkage = self.conv('key_proj.d_proj', f16) ** 2 + 1.0
        selection = torch.sigmoid(self.conv('key_proj.e_proj', f16))
        return key, shrinkage, selection, f16, f8, f4

    def encode_value(self, frame, f16, hidden, masks, deep_update=True):
        """masks [B, N, H, W] -> (value [B, N, Cv, h, w], hidden)."""
        b, n = masks.shape[:2]
        others = masks.sum(dim=1, keepdim=True) - masks if n > 1 \
            else torch.zeros_like(masks)
        g = torch.cat([frame[:, None].expand((b, n) + frame.shape[1:]),
                       masks[:, :, None], others[:, :, None]], dim=2)
        pre = 'value_encoder.'
        x = self.stem(pre, g.flatten(0, 1))
        x = self.layer(pre + 'layer1', x, 2, 1, self.basic)
        x = self.layer(pre + 'layer2', x, 2, 2, self.basic)
        x = self.layer(pre + 'layer3', x, 2, 2, self.basic)
        self.last_trunk = x
        g = self.fusion(pre + 'fuser', f16, x.reshape((b, n) + x.shape[1:]))
        if deep_update:
            values = self.gconv(pre + 'hidden_reinforce.transform',
                                torch.cat([g, hidden], dim=2))
            hidden = self.gru(values, hidden)
        return g, hidden

    def decode(self, feats: Tuple[Tensor, Tensor, Tensor], readout: Tensor,
               hidden: Tensor):
        """The decoder up to the mask head: (g16, g8, g4, logits at 1/4
        size), logits [B, N, 1, H/4, W/4]."""
        f16, f8, f4 = feats
        pre = 'decoder.'
        b, n = readout.shape[:2]
        self.last_readout = readout
        g16 = self.fusion(pre + 'fuser', f16, torch.cat([readout, hidden], 2))

        def up(name, skip_f, g):
            skip = self.conv(f'{pre}{name}.skip_conv', skip_f)
            h, w = g.shape[-2:]
            g = F.interpolate(g.flatten(0, 1), size=(2 * h, 2 * w),
                              mode='bilinear', align_corners=False)
            g = g.reshape((b, n) + g.shape[1:]) + skip[:, None]
            return self.res_block(f'{pre}{name}.out_conv', g)

        g8 = up('up_16_8', f8, g16)
        g4 = up('up_8_4', f4, g8)
        logits = self.conv(pre + 'pred', torch.relu(g4.flatten(0, 1)))
        self.last_logits = logits
        return g16, g8, g4, logits.reshape((b, n) + logits.shape[1:])

    def update_hidden(self, g16, g8, g4, logits, hidden):
        """The decoder's GRU over the three scales (modules.py
        HiddenUpdater); g4 gains the logits as a channel."""
        b, n = g16.shape[:2]
        hu = 'decoder.hidden_update.'

        def area(g, f):
            x = F.avg_pool2d(g.flatten(0, 1), f)
            return x.reshape((b, n) + x.shape[1:])

        g = (self.gconv(hu + 'g16_conv', g16)
             + self.gconv(hu + 'g8_conv', area(g8, 2))
             + self.gconv(hu + 'g4_conv', area(torch.cat([g4, logits], 2),
                                               4)))
        return self.gru(self.gconv(hu + 'transform',
                                   torch.cat([g, hidden], dim=2)), hidden)

    def segment(self, feats: Tuple[Tensor, Tensor, Tensor], readout: Tensor,
                hidden: Tensor, h_out: bool = True):
        """readout [B, N, Cv, h, w]; hidden [B, N, Ch, h, w] -> (hidden',
        prob [B, 1 + N, H, W] with the background first)."""
        g16, g8, g4, logits = self.decode(feats, readout, hidden)
        b, n = readout.shape[:2]
        if h_out:
            hidden = self.update_hidden(g16, g8, g4, logits, hidden)
        h4, w4 = logits.shape[-2:]
        logits = F.interpolate(logits.flatten(0, 1), size=(4 * h4, 4 * w4),
                               mode='bilinear', align_corners=False)
        prob = torch.sigmoid(logits.reshape((b, n, 4 * h4, 4 * w4)))
        return hidden, aggregate(prob, dim=1)


def aggregate(prob: Tensor, dim: int) -> Tensor:
    """Soft aggregation (reference model/aggregate.py): the background is
    prod(1 - p), and the stack is renormalised through the softmax of its
    logits, clamped to (1e-7, 1 - 1e-7)."""
    bg = torch.prod(1.0 - prob, dim=dim, keepdim=True)
    p = torch.cat([bg, prob], dim=dim).clamp(1e-7, 1.0 - 1e-7)
    return torch.softmax(torch.log(p / (1.0 - p)), dim=dim)


def similarity(mk: Tensor, ms: Tensor, qk: Tensor, qe: Tensor) -> Tensor:
    """Anisotropic L2 similarity (reference model/memory_util.py:7-35):
    sim[p, n] = -sum_c qe[p, c] (mk[n, c] - qk[p, c])^2 * ms[n] / sqrt(Ck),
    expanded into products. mk [N, Ck], ms [N], qk / qe [P, Ck] -> [P, N]."""
    a_sq = qe @ (mk * mk).T
    two_ab = 2.0 * ((qk * qe) @ mk.T)
    b_sq = (qe * qk * qk).sum(-1, keepdim=True)
    return (-a_sq + two_ab - b_sq) * ms[None, :] / math.sqrt(mk.shape[1])
