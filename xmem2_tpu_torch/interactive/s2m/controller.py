"""S2MController — per-object scribble-to-mask inference.

Counterpart of xmem2_tpu/interactive/s2m/controller.py (reference
inference/interact/s2m_controller.py:8-38): for each object, concatenate
[image, prev_mask_k, positive scribbles, negative scribbles] (6 channels),
pad by 16, run the DeepLabV3+ net, sigmoid. The objects go through the
network as one batch of K.
"""

from typing import Mapping

import numpy as np
import torch

from xmem2_tpu_torch.config import (
    pin_f32_precision, resolve_device, resolve_dtype_name, torch_dtype)
from xmem2_tpu_torch.interactive.s2m.network import build_s2m
from xmem2_tpu_torch.models.resnet import cast_weights
from xmem2_tpu_torch.ops.tensor import pad_divide_by, unpad


class S2MController:
    """ignore_class is usually 255; 0 is the background label (NOT ignore).
    `state_dict` is the reference-layout S2M state dict
    (network.load_s2m_state_dict). Runs on CUDA unless device='cpu';
    compute_dtype 'auto' is bfloat16 on CUDA, float32 on the CPU."""

    def __init__(self, state_dict: Mapping[str, np.ndarray], num_objects: int,
                 ignore_class: int = 255, compute_dtype='auto', device=None):
        self.device = resolve_device(device)
        pin_f32_precision()
        dtype = torch_dtype(resolve_dtype_name(compute_dtype, self.device))
        self.model = cast_weights(build_s2m(state_dict, self.device), dtype)
        self.num_objects = num_objects
        self.ignore_class = ignore_class

    @torch.no_grad()
    def interact(self, image: torch.Tensor, prev_mask: np.ndarray,
                 scr_mask: np.ndarray) -> torch.Tensor:
        """image [H, W, 3] (normalized, on the device); prev_mask [H, W] int
        (object ids); scr_mask [H, W] int scribble labels. Returns
        per-object probabilities [num_objects, H, W] float32."""
        dev = self.device
        ks = torch.arange(1, self.num_objects + 1, device=dev)[:, None, None]
        scr = torch.from_numpy(np.asarray(scr_mask).astype(np.int64)).to(dev)
        prev = torch.from_numpy(np.asarray(prev_mask).astype(np.int64)) \
            .to(dev)
        p_srb = (scr == ks).float()
        n_srb = ((scr != ks) & (scr != self.ignore_class)).float()
        prev_k = (prev == ks).float()
        img = image.to(dev).float().permute(2, 0, 1)
        inp = torch.cat([img[None].expand(self.num_objects, -1, -1, -1),
                         prev_k[:, None], p_srb[:, None], n_srb[:, None]],
                        dim=1)
        inp, pads = pad_divide_by(inp, 16)
        prob = torch.sigmoid(self.model(inp))             # [K, 1, H', W']
        return unpad(prob, pads)[:, 0]
