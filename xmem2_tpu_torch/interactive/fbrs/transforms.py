"""fBRS prediction-time transforms on NCHW tensors ([1, C, H, W] images,
[B, 1, H, W] probability maps).

Counterpart of xmem2_tpu/interactive/fbrs/transforms.py. Parity targets:
fbrs/inference/transforms/zoom_in.py (ZoomIn, get_object_roi,
get_roi_image_nd, check_object_roi), limit_longest_side.py, flip.py
(AddHorizontalFlip), sigmoid_for_pred.py. All resizes use
align_corners=True as in the reference. The previous probabilities stay on
the device (the JAX package copies them to the host each click); a bounding
box is the one thing copied back. States for undo hold tensors that are
replaced, never written in place.
"""

from typing import Tuple

import torch

from xmem2_tpu_torch.interactive.clicks.dist_maps import Click
from xmem2_tpu_torch.nn.functional import resize_bilinear


def get_bbox_from_mask(mask: torch.Tensor) -> Tuple[int, int, int, int]:
    """(rmin, rmax, cmin, cmax) of a non-empty [H, W] bool mask."""
    rows = torch.nonzero(mask.any(dim=1))[:, 0]
    cols = torch.nonzero(mask.any(dim=0))[:, 0]
    box = torch.stack([rows[0], rows[-1], cols[0], cols[-1]]).tolist()
    return tuple(int(v) for v in box)


def expand_bbox(bbox, expand_ratio, min_crop_size=None):
    rmin, rmax, cmin, cmax = bbox
    rcenter = 0.5 * (rmin + rmax)
    ccenter = 0.5 * (cmin + cmax)
    height = expand_ratio * (rmax - rmin + 1)
    width = expand_ratio * (cmax - cmin + 1)
    if min_crop_size is not None:
        height = max(height, min_crop_size)
        width = max(width, min_crop_size)
    rmin = int(round(rcenter - 0.5 * height))
    rmax = int(round(rcenter + 0.5 * height))
    cmin = int(round(ccenter - 0.5 * width))
    cmax = int(round(ccenter + 0.5 * width))
    return rmin, rmax, cmin, cmax


def clamp_bbox(bbox, rmin, rmax, cmin, cmax):
    return (max(rmin, bbox[0]), min(rmax, bbox[1]),
            max(cmin, bbox[2]), min(cmax, bbox[3]))


def get_bbox_iou(b1, b2):
    h_iou = _interval_iou(b1[0], b1[1], b2[0], b2[1])
    w_iou = _interval_iou(b1[2], b1[3], b2[2], b2[3])
    return h_iou * w_iou


def _interval_iou(x1, x2, y1, y2):
    inter = max(0, min(x2, y2) - max(x1, y1))
    union = max(x2, y2) - min(x1, y1)
    return inter / union if union > 0 else 0.0


class BaseTransform:
    def __init__(self):
        self.image_changed = False

    def transform(self, image, clicks_lists):
        raise NotImplementedError

    def inv_transform(self, prob_map):
        raise NotImplementedError

    def reset(self):
        pass

    def get_state(self):
        return None

    def set_state(self, state):
        pass


class SigmoidForPred(BaseTransform):
    def transform(self, image, clicks_lists):
        return image, clicks_lists

    def inv_transform(self, prob_map):
        return torch.sigmoid(prob_map)


class AddHorizontalFlip(BaseTransform):
    """Batch the image with its mirror; merge flipped predictions
    (fbrs/inference/transforms/flip.py)."""

    def transform(self, image, clicks_lists):
        image = torch.cat([image, image.flip(-1)], dim=0)
        width = image.shape[-1]
        flipped = [[Click(c.is_positive, (c.coords[0], width - c.coords[1] - 1))
                    for c in cl] for cl in clicks_lists]
        return image, clicks_lists + flipped

    def inv_transform(self, prob_map):
        n = prob_map.shape[0] // 2
        return 0.5 * (prob_map[:n] + prob_map[n:].flip(-1))


def get_roi_image(image, object_roi, target_size):
    rmin, rmax, cmin, cmax = object_roi
    height = rmax - rmin + 1
    width = cmax - cmin + 1
    if isinstance(target_size, tuple):
        nh, nw = target_size
    else:
        scale = target_size / max(height, width)
        nh, nw = int(round(height * scale)), int(round(width * scale))
    roi = image[:, :, rmin:rmax + 1, cmin:cmax + 1]
    return resize_bilinear(roi, (nh, nw), align_corners=True)


def get_object_roi(pred_mask: torch.Tensor, clicks_list, expansion_ratio,
                   min_crop_size):
    """pred_mask [H, W] bool (on the device)."""
    pred_mask = pred_mask.clone()
    for click in clicks_list:
        if click.is_positive:
            pred_mask[int(click.coords[0]), int(click.coords[1])] = True
    bbox = get_bbox_from_mask(pred_mask)
    bbox = expand_bbox(bbox, expansion_ratio, min_crop_size)
    h, w = pred_mask.shape
    return clamp_bbox(bbox, 0, h - 1, 0, w - 1)


def check_object_roi(object_roi, clicks_list) -> bool:
    for click in clicks_list:
        if click.is_positive:
            if not (object_roi[0] <= click.coords[0] < object_roi[1]):
                return False
            if not (object_roi[2] <= click.coords[1] < object_roi[3]):
                return False
    return True


class ZoomIn(BaseTransform):
    def __init__(self, target_size=400, skip_clicks=1, expansion_ratio=1.4,
                 min_crop_size=200, recompute_thresh_iou=0.5, prob_thresh=0.50):
        super().__init__()
        self.target_size = target_size
        self.min_crop_size = min_crop_size
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.recompute_thresh_iou = recompute_thresh_iou
        self.prob_thresh = prob_thresh
        self.reset()

    def reset(self):
        self._input_image_shape = None
        self._object_roi = None
        self._prev_probs = None
        self._roi_image = None
        self.image_changed = False

    def _pred_mask(self):
        return self._prev_probs[0, 0] > self.prob_thresh

    def transform(self, image, clicks_lists):
        assert image.shape[0] == 1 and len(clicks_lists) == 1
        self.image_changed = False
        clicks_list = clicks_lists[0]
        if len(clicks_list) <= self.skip_clicks:
            return image, clicks_lists

        self._input_image_shape = tuple(image.shape)
        current_object_roi = None
        if self._prev_probs is not None:
            current_pred_mask = self._pred_mask()
            if bool(current_pred_mask.any()):
                current_object_roi = get_object_roi(
                    current_pred_mask, clicks_list, self.expansion_ratio,
                    self.min_crop_size)
        if current_object_roi is None:
            return image, clicks_lists

        update = (self._object_roi is None
                  or not check_object_roi(self._object_roi, clicks_list)
                  or get_bbox_iou(current_object_roi, self._object_roi)
                  < self.recompute_thresh_iou)
        if update:
            self._object_roi = current_object_roi
            self._roi_image = get_roi_image(image, self._object_roi,
                                            self.target_size)
            self.image_changed = True

        return self._roi_image, [self._transform_clicks(clicks_list)]

    def inv_transform(self, prob_map):
        if self._object_roi is None:
            self._prev_probs = prob_map
            return prob_map
        rmin, rmax, cmin, cmax = self._object_roi
        prob_map = resize_bilinear(prob_map, (rmax - rmin + 1, cmax - cmin + 1),
                                   align_corners=True)
        if self._prev_probs is not None:
            new_prob = torch.zeros(self._prev_probs.shape, dtype=prob_map.dtype,
                                   device=prob_map.device)
            new_prob[:, :, rmin:rmax + 1, cmin:cmax + 1] = prob_map
        else:
            new_prob = prob_map
        self._prev_probs = new_prob
        return new_prob

    def check_possible_recalculation(self) -> bool:
        if (self._prev_probs is None or self._object_roi is not None
                or self.skip_clicks > 0):
            return False
        pred_mask = self._pred_mask()
        if bool(pred_mask.any()):
            roi = get_object_roi(pred_mask, [], self.expansion_ratio,
                                 self.min_crop_size)
            image_roi = (0, self._input_image_shape[2] - 1,
                         0, self._input_image_shape[3] - 1)
            if get_bbox_iou(roi, image_roi) < 0.50:
                return True
        return False

    def get_state(self):
        return (self._input_image_shape, self._object_roi, self._prev_probs,
                self._roi_image, self.image_changed)

    def set_state(self, state):
        (self._input_image_shape, self._object_roi, self._prev_probs,
         self._roi_image, self.image_changed) = state

    def _transform_clicks(self, clicks_list):
        if self._object_roi is None:
            return clicks_list
        rmin, rmax, cmin, cmax = self._object_roi
        crop_h, crop_w = self._roi_image.shape[-2:]
        out = []
        for c in clicks_list:
            nr = crop_h * (c.coords[0] - rmin) / (rmax - rmin + 1)
            nc = crop_w * (c.coords[1] - cmin) / (cmax - cmin + 1)
            out.append(Click(c.is_positive, (nr, nc)))
        return out


class LimitLongestSide(ZoomIn):
    def __init__(self, max_size=800):
        super().__init__(target_size=max_size, skip_clicks=0)

    def transform(self, image, clicks_lists):
        assert image.shape[0] == 1 and len(clicks_lists) == 1
        self.image_changed = False
        if max(image.shape[-2:]) <= self.target_size:
            return image, clicks_lists
        self._input_image_shape = tuple(image.shape)
        self._object_roi = (0, image.shape[-2] - 1, 0, image.shape[-1] - 1)
        self._roi_image = get_roi_image(image, self._object_roi,
                                        self.target_size)
        self.image_changed = True
        return self._roi_image, [self._transform_clicks(clicks_lists[0])]
