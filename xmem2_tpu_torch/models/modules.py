"""XMem network blocks, NCHW.

Counterpart of xmem2_tpu/models/modules.py (reference model/modules.py,
model/group_modules.py, model/cbam.py). Group tensors carry an object dim:
[B, N_obj, C, H, W]; group ops fold objects into the batch dim. Submodule
names follow the reference state dict so a reference .pth loads directly.
The two GRUs keep the reference's nonstandard gate order (new value computed
before the forget gate, reference modules.py:64-72) for weight compatibility.
"""

from typing import Tuple

import torch
from torch import nn

from xmem2_tpu_torch.models.resnet import Conv2d, to_compute_dtype
from xmem2_tpu_torch.nn import functional as XF


# ---------------------------------------------------------------------------
# group helpers (reference model/group_modules.py)
# ---------------------------------------------------------------------------

def _fold(g: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    b, n = g.shape[:2]
    return g.reshape((b * n,) + g.shape[2:]), (b, n)


def _unfold(x: torch.Tensor, bn: Tuple[int, int]) -> torch.Tensor:
    return x.reshape(bn + x.shape[1:])


def gconv(conv: nn.Module, g: torch.Tensor) -> torch.Tensor:
    x, bn = _fold(g)
    return _unfold(conv(x), bn)


def upsample_groups(g: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    x, bn = _fold(g)
    h, w = x.shape[-2:]
    return _unfold(XF.resize_bilinear(x, (h * ratio, w * ratio)), bn)


def downsample_groups(g: torch.Tensor, ratio: float = 0.5) -> torch.Tensor:
    x, bn = _fold(g)
    return _unfold(XF.interpolate_area_down(x, ratio), bn)


def distribute(x: torch.Tensor, g: torch.Tensor, method: str = 'cat'):
    """MainToGroupDistributor: broadcast frame features x [B, C, H, W] to
    every object slot of g [B, N, Cg, H, W] (reference group_modules.py
    :58-82)."""
    n = g.shape[1]
    xb = x[:, None].expand((x.shape[0], n) + x.shape[1:])
    if method == 'cat':
        return torch.cat([xb.to(g.dtype), g], dim=2)
    if method == 'add':
        return xb + g
    raise NotImplementedError(method)


def _conv_part(conv: nn.Conv2d, x: torch.Tensor, lo: int, hi: int,
               with_bias: bool) -> torch.Tensor:
    """The conv restricted to input channels [lo, hi) (a conv over a channel
    concat is the sum of convs over the parts; the bias is added once)."""
    bias = conv.bias if with_bias else None
    w = conv.weight[:, lo:hi]
    return nn.functional.conv2d(to_compute_dtype(x, w), w, bias, conv.stride,
                                conv.padding)


class GroupResBlock(nn.Module):
    """Reference group_modules.py:36-55."""

    def __init__(self, cin, cout):
        super().__init__()
        self.downsample = None if cin == cout else Conv2d(cin, cout, 3,
                                                          padding=1)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)

    def forward(self, g):
        out = gconv(self.conv1, torch.relu(g))
        out = gconv(self.conv2, torch.relu(out))
        if self.downsample is not None:
            g = gconv(self.downsample, g)
        return out + g

    def fused_distribute(self, x: torch.Tensor, g: torch.Tensor):
        """forward(distribute(x, g)) with the frame-feature part of conv1 and
        downsample computed once per frame instead of once per object (the
        JAX package's _fused_distribute_resblock, modules.py:123-148). x is
        identical across the N object slots distribute broadcasts it to, so
        its contribution is broadcast; relu commutes with the concat. Exact
        up to float32 summation order."""
        cx = x.shape[1]
        cin = self.conv1.weight.shape[1]
        out_x = _conv_part(self.conv1, torch.relu(x), 0, cx, True)
        xg, bn = _fold(torch.relu(g))
        out = _unfold(_conv_part(self.conv1, xg, cx, cin, False), bn)
        out = out + out_x[:, None].to(out.dtype)
        out = gconv(self.conv2, torch.relu(out))
        skip_x = _conv_part(self.downsample, x, 0, cx, True)
        gg, bn = _fold(g)
        skip = _unfold(_conv_part(self.downsample, gg, cx, cin, False), bn)
        return out + skip + skip_x[:, None].to(out.dtype)


# ---------------------------------------------------------------------------
# CBAM (reference model/cbam.py)
# ---------------------------------------------------------------------------

class ChannelGate(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        # indices 1 and 3 carry the reference's state-dict names mlp.1/mlp.3
        self.mlp = nn.Sequential(nn.Flatten(), nn.Linear(c, c // reduction),
                                 nn.ReLU(), nn.Linear(c // reduction, c))

    def _mlp(self, v):
        w1, w3 = self.mlp[1], self.mlp[3]
        v = nn.functional.linear(to_compute_dtype(v, w1.weight), w1.weight,
                                 w1.bias)
        return nn.functional.linear(torch.relu(v), w3.weight, w3.bias)

    def forward(self, x):
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        att = torch.sigmoid(self._mlp(avg).float() + self._mlp(mx).float())
        return x * att[:, :, None, None].to(x.dtype)


class _SpatialConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3)


class SpatialGate(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial = _SpatialConv()

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=1, keepdim=True),
                            x.mean(dim=1, keepdim=True)], dim=1)
        gate = self.spatial.conv(pooled)
        return x * torch.sigmoid(gate.float()).to(x.dtype)


class CBAM(nn.Module):
    """Channel gate (avg + max pooled shared MLP) then spatial gate (7x7)."""

    def __init__(self, c):
        super().__init__()
        self.ChannelGate = ChannelGate(c)
        self.SpatialGate = SpatialGate()

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


# ---------------------------------------------------------------------------
# fusion / GRUs / projection (reference model/modules.py)
# ---------------------------------------------------------------------------

class FeatureFusionBlock(nn.Module):
    """Reference modules.py:22-41."""

    def __init__(self, x_in, g_in, g_mid, g_out):
        super().__init__()
        self.block1 = GroupResBlock(x_in + g_in, g_mid)
        self.attention = CBAM(g_mid)
        self.block2 = GroupResBlock(g_mid, g_out)

    def forward(self, x, g):
        if g.shape[1] > 1 and self.block1.downsample is not None:
            # multi-object: frame features enter conv1/downsample once
            g = self.block1.fused_distribute(x, g)
        else:
            g = self.block1(distribute(x, g))
        flat, bn = _fold(g)
        r = _unfold(self.attention(flat), bn)
        return self.block2(g + r)


def _gru_gate(values: torch.Tensor, h: torch.Tensor, hidden_dim: int):
    """Shared nonstandard-GRU update (reference modules.py:64-72, 93-97);
    values [B, N, 3*Ch, H, W], channels split along dim 2."""
    forget = torch.sigmoid(values[:, :, :hidden_dim])
    update = torch.sigmoid(values[:, :, hidden_dim:hidden_dim * 2])
    new_value = torch.tanh(values[:, :, hidden_dim * 2:])
    return forget * h * (1.0 - update) + update * new_value


class HiddenUpdater(nn.Module):
    """Multi-scale GRU in the decoder (reference modules.py:44-74); g4
    already carries the logits channel."""

    def __init__(self, g_dims, mid_dim, hidden_dim):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.g16_conv = Conv2d(g_dims[0], mid_dim, 1)
        self.g8_conv = Conv2d(g_dims[1], mid_dim, 1)
        self.g4_conv = Conv2d(g_dims[2], mid_dim, 1)
        self.transform = Conv2d(mid_dim + hidden_dim, hidden_dim * 3, 3,
                                padding=1)

    def forward(self, g16, g8, g4, h):
        g = (gconv(self.g16_conv, g16)
             + gconv(self.g8_conv, downsample_groups(g8, 0.5))
             + gconv(self.g4_conv, downsample_groups(g4, 0.25)))
        values = gconv(self.transform, torch.cat([g, h.to(g.dtype)], dim=2))
        return _gru_gate(values.float(), h.float(), self.hidden_dim)


class HiddenReinforcer(nn.Module):
    """Single GRU in the value encoder (reference modules.py:77-99)."""

    def __init__(self, g_dim, hidden_dim):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.transform = Conv2d(g_dim + hidden_dim, hidden_dim * 3, 3,
                                padding=1)

    def forward(self, g, h):
        values = gconv(self.transform, torch.cat([g, h.to(g.dtype)], dim=2))
        return _gru_gate(values.float(), h.float(), self.hidden_dim)


class KeyProjection(nn.Module):
    """Key, shrinkage (d^2 + 1) and selection (sigmoid) heads (reference
    modules.py:194-211); all three come out in float32."""

    def __init__(self, in_dim, key_dim):
        super().__init__()
        self.key_proj = Conv2d(in_dim, key_dim, 3, padding=1)
        self.d_proj = Conv2d(in_dim, 1, 3, padding=1)
        self.e_proj = Conv2d(in_dim, key_dim, 3, padding=1)

    def forward(self, x, need_s=True, need_e=True):
        key = self.key_proj(x).float()
        shrinkage = self.d_proj(x).float() ** 2 + 1.0 if need_s else None
        selection = torch.sigmoid(self.e_proj(x).float()) if need_e else None
        return key, shrinkage, selection


class UpsampleBlock(nn.Module):
    """2x upsample + skip add (reference modules.py:178-191)."""

    def __init__(self, skip_dim, g_up_dim, g_out_dim):
        super().__init__()
        self.skip_conv = Conv2d(skip_dim, g_up_dim, 3, padding=1)
        self.out_conv = GroupResBlock(g_up_dim, g_out_dim)

    def forward(self, skip_f, up_g):
        skip = self.skip_conv(skip_f)
        g = upsample_groups(up_g, 2)
        return self.out_conv(distribute(skip, g, method='add'))
