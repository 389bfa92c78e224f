"""fBRS interactive controllers.

Counterpart of xmem2_tpu/interactive/fbrs/controller.py. Parity targets:
fbrs/controller.py (InteractiveController click state machine with per-click
undo snapshots) and inference/interact/fbrs_controller.py (FBRSController
wrapper: f-BRS-B, zoom-in target 480 / expansion 1.4 / skip 1, 8-click
limit, max_size 800, L-BFGS maxfun 20). Probabilities stay on the device.
"""

import numpy as np
import torch

from xmem2_tpu_torch.config import (
    pin_f32_precision, resolve_device, resolve_dtype_name, torch_dtype)
from xmem2_tpu_torch.interactive.clicks.dist_maps import Click, Clicker
from xmem2_tpu_torch.interactive.fbrs.predictor import get_predictor
from xmem2_tpu_torch.interactive.fbrs.utils import build_is_model, \
    load_is_model
from xmem2_tpu_torch.models.resnet import cast_weights


class InteractiveController:
    """model: FBRSModel or HRNetModel on its device (compute dtype set)."""

    def __init__(self, model, predictor_params, prob_thresh=0.5):
        self.model = model
        self.prob_thresh = prob_thresh
        self.clicker = Clicker()
        self.states = []
        self.probs_history = []
        self.object_count = 0
        self._result_mask = None
        self.image = None
        self.predictor = None
        self.predictor_params = predictor_params
        self.reset_predictor()

    def set_image(self, image):
        """image [H, W, 3] float (normalized), tensor or array."""
        self.image = image
        self._result_mask = np.zeros(tuple(image.shape[:2]), np.uint8)
        self.object_count = 0
        self.reset_last_object()

    def add_click(self, x, y, is_positive):
        self.states.append({
            'clicker': self.clicker.get_state(),
            'predictor': self.predictor.get_states(),
        })
        self.clicker.add_click(Click(is_positive=is_positive, coords=(y, x)))
        pred = self.predictor.get_prediction(self.clicker)[0, 0]  # [H, W]
        if self.probs_history:
            self.probs_history.append((self.probs_history[-1][0], pred))
        else:
            self.probs_history.append((torch.zeros_like(pred), pred))

    def undo_click(self):
        if not self.states:
            return
        prev = self.states.pop()
        self.clicker.set_state(prev['clicker'])
        self.predictor.set_states(prev['predictor'])
        self.probs_history.pop()

    def partially_finish_object(self):
        object_prob = self.current_object_prob
        if object_prob is None:
            return
        self.probs_history.append((object_prob, torch.zeros_like(object_prob)))
        self.states.append(self.states[-1])
        self.clicker.reset_clicks()
        self.reset_predictor()

    def finish_object(self):
        object_prob = self.current_object_prob
        if object_prob is None:
            return
        self.object_count += 1
        self._result_mask[(object_prob > self.prob_thresh).cpu().numpy()] = \
            self.object_count
        self.reset_last_object()

    def reset_last_object(self):
        self.states = []
        self.probs_history = []
        self.clicker.reset_clicks()
        self.reset_predictor()

    def reset_predictor(self, predictor_params=None):
        if predictor_params is not None:
            self.predictor_params = predictor_params
        self.predictor = get_predictor(self.model, **self.predictor_params)
        if self.image is not None:
            self.predictor.set_input_image(self.image)

    @property
    def current_object_prob(self):
        if self.probs_history:
            total, additive = self.probs_history[-1]
            return torch.maximum(total, additive)
        return None

    @property
    def is_incomplete_mask(self):
        return len(self.probs_history) > 0

    @property
    def result_mask(self):
        return self._result_mask.copy()


class FBRSController:
    """Click->mask wrapper used by the GUI (reference fbrs_controller.py).
    Runs on CUDA unless device='cpu'; compute_dtype 'auto' is bfloat16 on
    CUDA, float32 on the CPU."""

    def __init__(self, checkpoint_path: str, max_size: int = 800,
                 compute_dtype='auto', device=None):
        self.device = resolve_device(device)
        pin_f32_precision()
        dtype = torch_dtype(resolve_dtype_name(compute_dtype, self.device))
        model = cast_weights(
            build_is_model(load_is_model(checkpoint_path), self.device), dtype)
        predictor_params = {
            'brs_mode': 'f-BRS-B',
            'prob_thresh': 0.5,
            'zoom_in_params': {
                'skip_clicks': 1,
                'target_size': 480,
                'expansion_ratio': 1.4,
            },
            'predictor_params': {
                'net_clicks_limit': 8,
                'max_size': max_size,
            },
            'brs_opt_func_params': {'min_iou_diff': 1e-3},
            'lbfgs_params': {'maxfun': 20},
        }
        self.controller = InteractiveController(model, predictor_params)
        self.anchored = False

    def unanchor(self):
        self.anchored = False

    def interact(self, image, x, y, is_positive):
        """image [H, W, 3] normalized float; returns the binary mask [H, W]
        (float32, on the device)."""
        if not self.anchored:
            self.controller.set_image(image)
            self.controller.reset_predictor()
            self.anchored = True
        self.controller.add_click(x, y, is_positive)
        return (self.controller.probs_history[-1][1] > 0.5).float()

    def undo(self):
        self.controller.undo_click()
        if len(self.controller.probs_history) == 0:
            return None
        return (self.controller.probs_history[-1][1] > 0.5).float()

    @property
    def last_evaluations(self) -> int:
        """L-BFGS function evaluations of the last click."""
        return getattr(self.controller.predictor, 'last_evaluations', 0)
