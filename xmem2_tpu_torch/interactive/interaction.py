"""GUI interaction types: free brush, scribble->S2M, click->fBRS.

Counterpart of xmem2_tpu/interactive/interaction.py (reference
inference/interact/interaction.py: aggregate_sbg :18, aggregate_wbg :36,
FreeInteraction :69, ScribbleInteraction :136, ClickInteraction :199).
Probability maps are tensors [K(+1), H, W] on the controllers' device;
strokes are drawn by the numpy rasterizers of raster.py (the JAX package
draws them with cv2, which is not installed beside the port).
"""

import time

import numpy as np
import torch

from xmem2_tpu_torch.interactive.interactive_utils import (
    color_map, index_numpy_to_one_hot)
from xmem2_tpu_torch.interactive.raster import draw_disc, draw_line


def aggregate_sbg(prob, keep_bg=False, hard=False):
    """Soft-background aggregation: fixed 0.5 background channel
    (reference interaction.py:18-33)."""
    prob = torch.as_tensor(prob)
    bg = torch.full((1,) + tuple(prob.shape[1:]), 0.5, dtype=prob.dtype,
                    device=prob.device)
    return _aggregate(torch.cat([bg, prob], dim=0), keep_bg, hard)


def aggregate_wbg(prob, keep_bg=False, hard=False):
    """Product-of-complements background aggregation
    (reference interaction.py:36-50)."""
    prob = torch.as_tensor(prob)
    bg = torch.prod(1 - prob, dim=0, keepdim=True)
    return _aggregate(torch.cat([bg, prob], dim=0), keep_bg, hard)


def _aggregate(ex_prob, keep_bg, hard):
    ex_prob = ex_prob.clamp(1e-7, 1 - 1e-7)
    logits = torch.log(ex_prob / (1 - ex_prob))
    if hard:
        logits = logits * 1000
    out = torch.softmax(logits, dim=0)
    return out if keep_bg else out[1:]


class Interaction:
    def __init__(self, image, prev_mask, true_size, controller):
        self.image = image
        self.prev_mask = prev_mask
        self.controller = controller
        self.start_time = time.time()
        self.h, self.w = true_size
        self.out_prob = None
        self.out_mask = None

    def predict(self):
        pass


class _StrokeInteraction(Interaction):
    """Strokes drawn into an index map, one path per label."""

    def __init__(self, image, prev_mask, true_size, controller, num_objects,
                 drawn_map, size):
        super().__init__(image, prev_mask, true_size, controller)
        self.K = num_objects
        self.drawn_map = drawn_map
        self.curr_path = [[] for _ in range(self.K + 1)]
        self.size = size

    def push_point(self, x, y, k, vis=None):
        if vis is not None:
            vis_map, vis_alpha = vis
        selected = self.curr_path[k]
        selected.append((x, y))
        if len(selected) >= 2:
            draw_line(self.drawn_map, selected[-2], selected[-1], k,
                      self.size)
            if vis is not None:
                draw_line(vis_map, selected[-2], selected[-1], color_map[k],
                          self.size)
                draw_line(vis_alpha, selected[-2], selected[-1], 0.75,
                          self.size)
        if vis is not None:
            return vis_map, vis_alpha

    def end_path(self):
        self.curr_path = [[] for _ in range(self.K + 1)]


class FreeInteraction(_StrokeInteraction):
    """Brush drawing directly into the index map (reference :69-134)."""

    def __init__(self, image, prev_mask, true_size, num_objects):
        super().__init__(image, prev_mask, true_size, None, num_objects,
                         np.array(prev_mask), None)

    def set_size(self, size):
        self.size = size

    def predict(self):
        self.out_prob = torch.from_numpy(
            index_numpy_to_one_hot(self.drawn_map, self.K + 1))
        return self.out_prob


class ScribbleInteraction(_StrokeInteraction):
    """Scribbles -> S2M network (reference :136-197)."""

    def __init__(self, image, prev_mask, true_size, controller, num_objects):
        h, w = true_size
        super().__init__(image, prev_mask, true_size, controller, num_objects,
                         np.full((h, w), 255, np.uint8), 3)

    def predict(self):
        self.out_prob = self.controller.interact(self.image, self.prev_mask,
                                                 self.drawn_map)
        self.out_prob = aggregate_wbg(self.out_prob, keep_bg=True, hard=True)
        return self.out_prob


class ClickInteraction(Interaction):
    """Clicks -> fBRS (reference :199-254). prev_mask is in prob form
    [1+K, H, W]."""

    def __init__(self, image, prev_mask, true_size, controller, tar_obj):
        super().__init__(image, prev_mask, true_size, controller)
        self.tar_obj = tar_obj
        self.pos_clicks = []
        self.neg_clicks = []
        self.out_prob = torch.as_tensor(prev_mask)
        self.obj_mask = None

    def push_point(self, x, y, neg, vis=None):
        if neg:
            self.neg_clicks.append((x, y))
        else:
            self.pos_clicks.append((x, y))

        self.obj_mask = self.controller.interact(self.image, x, y, not neg)

        if vis is not None:
            vis_map, vis_alpha = vis
            color = color_map[0] if neg else color_map[self.tar_obj]
            draw_disc(vis_map, (x, y), 2, color)
            draw_disc(vis_alpha, (x, y), 2, 1)
            return vis_map, vis_alpha

    def predict(self):
        out = torch.as_tensor(self.prev_mask).to(self.obj_mask.device)
        # allow the interacting object to overwrite existing masks without
        # remembering all object probabilities (reference :247-252)
        out = out.clamp(max=0.9)
        out[self.tar_obj] = self.obj_mask
        self.out_prob = aggregate_wbg(out[1:], keep_bg=True, hard=True)
        return self.out_prob
