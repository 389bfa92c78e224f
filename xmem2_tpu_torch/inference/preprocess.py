"""On-device pre-processing: raw uint8 frames -> normalised, resized floats.

Counterpart of xmem2_tpu/inference/preprocess.py. Uploading the raw uint8
frame and normalising/resizing on the device is numerically the reference's
host transform (video_reader.py:56-65): normalisation and bilinear resize are
both linear, so they commute.
"""

import torch

from xmem2_tpu_torch.nn.functional import resize_bilinear
from xmem2_tpu_torch.utils.resize_np import shorter_side_size

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_frame(img_u8: torch.Tensor, size: int = -1) -> torch.Tensor:
    """img_u8 [H0, W0, 3] uint8 -> [H, W, 3] float32, ImageNet-normalised,
    shorter side resized to `size` (if > 0)."""
    mean = torch.tensor(IMAGENET_MEAN, device=img_u8.device)
    std = torch.tensor(IMAGENET_STD, device=img_u8.device)
    x = (img_u8.float() / 255.0 - mean) / std
    if size > 0:
        h, w = img_u8.shape[:2]
        x = resize_bilinear(x.permute(2, 0, 1), shorter_side_size(h, w, size))
        x = x.permute(1, 2, 0)
    return x
