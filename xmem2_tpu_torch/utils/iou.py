"""IoU helpers (reference util/tensor_util.py:6-44), numpy."""

import numpy as np


def compute_iou(seg: np.ndarray, gt: np.ndarray) -> float:
    seg = seg.astype(bool)
    gt = gt.astype(bool)
    inter = np.logical_and(seg, gt).sum()
    union = np.logical_or(seg, gt).sum()
    return float((inter + 1e-6) / (union + 1e-6))


def compute_array_iou(seg: np.ndarray, gt: np.ndarray) -> float:
    """Mean per-object IoU of two index masks (reference tensor_util.py:18-44:
    objects enumerated from the PREDICTION; empty prediction compares
    backgrounds)."""
    seg = np.squeeze(seg)
    gt = np.squeeze(gt)
    ious = []
    for color in np.unique(seg):
        if color == 0:
            continue
        ious.append(compute_iou(seg == color, gt == color))
    if not ious:
        ious.append(compute_iou(seg == 0, gt == 0))
    return float(sum(ious) / len(ious))
