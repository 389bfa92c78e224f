"""DAVIS evaluation metrics: region jaccard (J) and boundary F-measure (F).

A copy of xmem2_tpu/utils/metrics.py (reference util/metrics.py:
batched_jaccard :11, f_measure :137, batched_f_measure :200), which mirrors
the official DAVIS toolkit. skimage's disk structuring element is generated
inline; dilation via cv2 as in the reference, or scipy where cv2 is absent.
"""

import numpy as np

__all__ = ['batched_jaccard', 'f_measure', 'batched_f_measure']


def _object_ids(y_true, nb_objects):
    if nb_objects is None:
        ids = np.unique(y_true[(y_true < 255) & (y_true > 0)])
        return ids, len(ids)
    return np.arange(1, nb_objects + 1), nb_objects


def batched_jaccard(y_true, y_pred, average_over_objects=True, nb_objects=None):
    """Per-frame jaccard over a video: y_true/y_pred [B, H, W] int masks.
    Empty-union frames score 1 (reference metrics.py:64-68)."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    assert y_true.ndim == 3 and y_pred.shape == y_true.shape

    objects_ids, nb = _object_ids(y_true, nb_objects)
    if nb == 0:
        raise ValueError('Number of objects in y_true should be higher than 0.')

    jaccard = np.empty((len(y_true), nb), np.float64)
    for i, obj_id in enumerate(objects_ids):
        mt, mp = y_true == obj_id, y_pred == obj_id
        union = (mt | mp).sum(axis=(1, 2))
        inter = (mt & mp).sum(axis=(1, 2))
        jaccard[:, i] = np.where(np.isclose(union, 0), 1.0,
                                 inter / np.maximum(union, 1))
    return jaccard.mean(axis=1) if average_over_objects else jaccard


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide boundary map, pixels offset 1/2 px towards the origin
    (reference metrics.py:75-134, the classic Martin bmap)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk(radius: int) -> np.ndarray:
    """Circular structuring element (skimage.morphology.disk)."""
    r = int(radius)
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def _dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    try:
        import cv2
        return cv2.dilate(img.astype(np.uint8), kernel)
    except ImportError:
        from scipy.ndimage import binary_dilation
        return binary_dilation(img, structure=kernel.astype(bool)).astype(np.uint8)


def f_measure(true_mask, pred_mask, bound_th=0.008) -> float:
    """Boundary F-measure between two binary [H, W] masks
    (reference metrics.py:137-197)."""
    true_mask = np.asarray(true_mask, bool)
    pred_mask = np.asarray(pred_mask, bool)
    assert true_mask.shape == pred_mask.shape

    bound_pix = bound_th if bound_th >= 1 else \
        np.ceil(bound_th * np.linalg.norm(true_mask.shape))

    fg_boundary = _seg2bmap(pred_mask)
    gt_boundary = _seg2bmap(true_mask)

    kernel = _disk(bound_pix)
    fg_dil = _dilate(fg_boundary, kernel)
    gt_dil = _dilate(gt_boundary, kernel)

    gt_match = gt_boundary * fg_dil
    fg_match = fg_boundary * gt_dil
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()

    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = fg_match.sum() / float(n_fg)
        recall = gt_match.sum() / float(n_gt)

    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def batched_f_measure(y_true, y_pred, average_over_objects=True,
                      nb_objects=None, bound_th=0.008):
    """Per-frame boundary F over a video (reference metrics.py:200-255)."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    assert y_true.ndim == 3 and y_pred.shape == y_true.shape

    objects_ids, nb = _object_ids(y_true, nb_objects)
    if nb == 0:
        raise ValueError('Number of objects in y_true should be higher than 0.')

    out = np.empty((len(y_true), nb), np.float64)
    for i, obj_id in enumerate(objects_ids):
        for fi in range(len(y_true)):
            out[fi, i] = f_measure(y_true[fi] == obj_id, y_pred[fi] == obj_id,
                                   bound_th=bound_th)
    return out.mean(axis=1) if average_over_objects else out
