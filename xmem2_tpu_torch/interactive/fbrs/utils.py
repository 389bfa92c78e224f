"""fBRS checkpoint loading with backbone auto-detection.

Counterpart of xmem2_tpu/interactive/fbrs/utils.py (reference
fbrs/inference/utils.py:21-101): sniff the architecture from state-dict
keys (HRNet via 'stage2.0.branches', the resnet family via the backbone's
stem), then build the matching model: the resnet50 DeepLabV3+
DistMapsModel (the shipped fbrs.pth) or HRNet+OCR.
"""

from typing import Dict, Mapping, Union

import numpy as np
import torch

from xmem2_tpu_torch.config import resolve_device
from xmem2_tpu_torch.interactive.fbrs.hrnet import (
    HRNetModel, hrnet_widths, is_hrnet_state_dict)
from xmem2_tpu_torch.interactive.fbrs.model import FBRSModel, fbrs_widths


def detect_backbone(state_dict_keys) -> str:
    keys = list(state_dict_keys)
    if any('feature_extractor.stage2.0.branches' in k for k in keys):
        return 'hrnet'
    if any('feature_extractor.backbone' in k for k in keys):
        # resnet family; distinguish by stem depth (v1s deep stem = Sequential)
        if any('backbone.conv1.0' in k for k in keys):
            return 'resnet50'
        return 'resnet34'
    raise ValueError('Unrecognized fBRS checkpoint format')


def load_is_model(checkpoint_path: str) -> Dict[str, np.ndarray]:
    """An interactive-segmentation checkpoint (resnet50 DeepLabV3+ or
    HRNet+OCR; reference utils.py:21-37) as a numpy state dict,
    num_batches_tracked dropped."""
    sd = torch.load(checkpoint_path, map_location='cpu', weights_only=True)
    if 'state_dict' in sd:
        sd = sd['state_dict']
    if detect_backbone(sd.keys()) == 'resnet34':
        raise NotImplementedError(
            'fBRS resnet34 checkpoints are not supported — use the resnet50 '
            'f-BRS-B checkpoint (saves/fbrs.pth) or an HRNet+OCR one.')
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if not k.endswith('num_batches_tracked')}


def build_is_model(sd: Mapping[str, np.ndarray], device=None
                   ) -> Union[FBRSModel, HRNetModel]:
    """The model for a state dict (float32, strict names, eval, frozen) on
    `device`: CUDA unless the caller passes another."""
    device = resolve_device(device)
    with torch.device('meta'):
        model = HRNetModel(**hrnet_widths(sd)) if is_hrnet_state_dict(sd) \
            else FBRSModel(**fbrs_widths(sd))
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in sd.items()}, strict=True, assign=True)
    return model.to(device).eval().requires_grad_(False)
