"""Visualization overlays + conversion helpers for the interactive GUI.

Counterpart of xmem2_tpu/interactive/interactive_utils.py (reference
inference/interact/interactive_utils.py, numpy renderers :76-110). The
overlays and mask conversions are numpy and byte-equal to the JAX package's;
image_to_torch puts a frame on the device. Modes: davis / fade / light /
popup / layered.
"""

import numpy as np
import torch

from xmem2_tpu_torch.utils.palette import davis_palette_np

# scales for better visualization (reference :29-31)
color_map_np = (davis_palette_np.astype(np.float32) * 1.5).clip(0, 255) \
    .astype(np.uint8)
color_map = color_map_np.tolist()
grayscale_weights = np.array([[0.3, 0.59, 0.11]], np.float32)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def image_to_torch(frame: np.ndarray, device):
    """frame H*W*3 uint8 -> (normalized [H, W, 3] f32, raw/255 f32), both
    on `device`."""
    raw = torch.from_numpy(np.ascontiguousarray(frame)).to(device).float() \
        / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    return (raw - mean) / std, raw


def prob_to_numpy_mask(prob) -> np.ndarray:
    """prob [1+O, H, W] (tensor or array) -> argmax index mask uint8 on the
    host. A tensor is reduced where it lies and only the mask is copied."""
    if torch.is_tensor(prob):
        return torch.argmax(prob, dim=0).to(torch.uint8).cpu().numpy()
    return np.argmax(np.asarray(prob), axis=0).astype(np.uint8)


def index_numpy_to_one_hot(mask: np.ndarray, num_classes: int) -> np.ndarray:
    """[H, W] int -> [num_classes, H, W] float one-hot."""
    return np.eye(num_classes, dtype=np.float32)[mask].transpose(2, 0, 1)


def get_visualization(mode, image, mask, layer, target_object):
    if mode == 'fade':
        return overlay_davis(image, mask, fade=True)
    if mode == 'davis':
        return overlay_davis(image, mask)
    if mode == 'light':
        return overlay_davis(image, mask, 0.9)
    if mode == 'popup':
        return overlay_popup(image, mask, target_object)
    if mode == 'layered':
        if layer is None:
            print('Layer file not given. Defaulting to DAVIS.')
            return overlay_davis(image, mask)
        return overlay_layer(image, mask, layer, target_object)
    raise NotImplementedError(mode)


def overlay_davis(image, mask, alpha=0.5, fade=False):
    """DAVIS-style colored overlay (reference :76-88)."""
    im_overlay = image.copy()
    colored_mask = color_map_np[mask]
    foreground = image * alpha + (1 - alpha) * colored_mask
    binary_mask = mask > 0
    im_overlay[binary_mask] = foreground[binary_mask]
    if fade:
        im_overlay[~binary_mask] = im_overlay[~binary_mask] * 0.6
    return im_overlay.astype(image.dtype)


def overlay_popup(image, mask, target_object):
    """Foreground colored, background grayscale (reference :90-97)."""
    im_overlay = image.copy()
    binary_mask = ~np.isin(mask, target_object)
    gray = (im_overlay[binary_mask] * grayscale_weights).sum(-1, keepdims=True)
    im_overlay[binary_mask] = gray
    return im_overlay.astype(image.dtype)


def overlay_layer(image, mask, layer, target_object):
    """Insert an RGBA layer between foreground and background
    (reference :99-109)."""
    obj_mask = np.isin(mask, target_object).astype(np.float32)
    layer_alpha = layer[:, :, 3].astype(np.float32) / 255
    layer_rgb = layer[:, :, :3]
    background_alpha = np.maximum(obj_mask, layer_alpha)[:, :, None]
    obj_mask = obj_mask[:, :, None]
    im_overlay = (image * (1 - background_alpha) + layer_rgb * (1 - obj_mask)
                  + image * obj_mask).clip(0, 255)
    return im_overlay.astype(image.dtype)
