"""Functional primitives the inference path uses, NCHW.

Counterpart of xmem2_tpu/nn/functional.py. Convolutions are
torch.nn.functional.conv2d (cuDNN on the card), called by the modules in
models/. Every op here computes in float32 and returns the input's dtype, as
the JAX package does, so the bf16 mode rounds at the same places.
"""

from typing import Tuple

import torch
import torch.nn.functional as F


def batch_norm(x: torch.Tensor, weight, bias, running_mean, running_var,
               eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm with running statistics, in float32:
    x * scale + shift with scale = w / sqrt(var + eps)."""
    dt = x.dtype
    scale = weight.float() * torch.rsqrt(running_var.float() + eps)
    shift = bias.float() - running_mean.float() * scale
    return (x.float() * scale[:, None, None] + shift[:, None, None]).to(dt)


def batch_norm_train(x: torch.Tensor, weight, bias, eps: float = 1e-5,
                     group=None):
    """Training batch norm over NCHW with batch statistics over (N, H, W) in
    float32 (xmem2_tpu/nn/functional.py:76-96). With a process group (e.g.
    torch.distributed.group.WORLD) the statistics are those of the group's
    whole batch (SyncBN): one all_reduce of the stacked [mean, mean of
    squares], summed and divided by the group's size (the JAX package's
    pmean; gloo has no AVG). torch.distributed.nn.functional.all_reduce is
    differentiable, so the backward runs through autograd. Returns (out in
    x's dtype, mean, var). The trainers keep batch norm frozen, as the
    reference does, and do not call it."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    mean_sq = (x32 * x32).mean(dim=(0, 2, 3))
    if group is not None:
        from torch.distributed.nn.functional import all_reduce
        stats = all_reduce(torch.stack([mean, mean_sq]), group=group) \
            / torch.distributed.get_world_size(group)
        mean, mean_sq = stats[0], stats[1]
    var = mean_sq - mean * mean
    inv = torch.rsqrt(var + eps)
    out = (x32 - mean[:, None, None]) * (inv * weight.float())[:, None, None] \
        + bias.float()[:, None, None]
    return out.to(x.dtype), mean, var


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """torch nn.MaxPool2d semantics over the two trailing dims."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Average pooling with stride = window, in float32."""
    return F.avg_pool2d(x.float(), window).to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize, no antialiasing, over the two trailing dims of
    [..., H, W] (torch F.interpolate(mode='bilinear'), the function the JAX
    package reproduces by hand), computed in float32. align_corners=True is
    the convention of the f-BRS models and transforms. Integer upscale
    factors (the decoder's 2x/4x) and arbitrary sizes (frame resize, mask
    resize back) take the same call; the JAX package's shifted-add path for
    integer factors is a TPU gather-avoidance computing the same values."""
    h, w = x.shape[-2:]
    out_hw = tuple(int(s) for s in out_hw)
    if (h, w) == out_hw:
        return x
    lead = x.shape[:-2]
    x4 = x.float().reshape((-1, 1) + (h, w)) if x.dim() != 4 else x.float()
    out = F.interpolate(x4, size=out_hw, mode='bilinear',
                        align_corners=align_corners)
    return out.reshape(lead + tuple(out_hw)).to(x.dtype)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') over [..., H, W]:
    src = floor(dst * in / out)."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    hi = torch.floor(torch.arange(oh, device=x.device) * (h / oh)).long()
    wi = torch.floor(torch.arange(ow, device=x.device) * (w / ow)).long()
    return x.index_select(-2, hi).index_select(-1, wi)


def interpolate_area_down(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """torch F.interpolate(mode='area') for integer downscale factors (the
    decoder's 1/2 and 1/4): exact average pooling over [..., H, W]."""
    factor = int(round(1.0 / ratio))
    if abs(1.0 / ratio - factor) > 1e-6:
        raise ValueError('area resize only supports integer factors')
    lead = x.shape[:-3]
    c, h, w = x.shape[-3:]
    out = avg_pool(x.reshape((-1, c, h, w)), factor)
    return out.reshape(lead + out.shape[1:])
