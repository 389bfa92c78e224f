"""XMemNet: the inference-facing wrapper around the XMem module.

Counterpart of xmem2_tpu/inference/net.py. Holds the module on its device in
the compute dtype (batch-norm statistics stay float32) and fills in zero
hidden states where a caller has none yet. Runs on CUDA unless the caller
passes device='cpu'.
"""

from typing import Optional

import torch

from xmem2_tpu_torch.config import pin_f32_precision, resolve_device, \
    resolve_dtype_name, torch_dtype
from xmem2_tpu_torch.models.network import XMem
from xmem2_tpu_torch.models.resnet import cast_weights
from xmem2_tpu_torch.utils.profiling import annotate


class XMemNet:
    """encode_key / encode_value / segment of the reference XMem surface
    (model/network.py:122-132) minus the training-only read_memory.

    Moves `model` to the device and dtype in place."""

    def __init__(self, model: XMem, compute_dtype='auto', device=None):
        self.device = resolve_device(device)
        pin_f32_precision()
        self.dtype = torch_dtype(resolve_dtype_name(compute_dtype,
                                                    self.device))
        model = model.to(self.device).eval().requires_grad_(False)
        self.model = cast_weights(model, self.dtype)   # BN stays f32

    @property
    def key_dim(self) -> int:
        return self.model.key_dim

    @property
    def value_dim(self) -> int:
        return self.model.value_dim

    @property
    def hidden_dim(self) -> int:
        return self.model.hidden_dim

    def _zero_hidden(self, b, o, f16):
        h16, w16 = f16.shape[-2:]
        return torch.zeros((b, o, max(self.hidden_dim, 1), h16, w16),
                           device=self.device)

    @torch.no_grad()
    def encode_key(self, frame: torch.Tensor):
        """frame [B, 3, H, W] -> (key, shrinkage, selection, f16, f8, f4)."""
        with annotate('xmem.net.encode_key'):
            return self.model.encode_key(frame)

    @torch.no_grad()
    def encode_value(self, frame, f16, hidden: Optional[torch.Tensor], masks,
                     is_deep_update: bool = True):
        """masks [B, O, H, W] -> (value [B, O, Cv, h, w], hidden')."""
        with annotate('xmem.net.encode_value'):
            if hidden is None:
                hidden = self._zero_hidden(masks.shape[0], masks.shape[1],
                                           f16)
            return self.model.encode_value(frame, f16, hidden, masks,
                                           is_deep_update)

    @torch.no_grad()
    def segment(self, multi_scale_features, memory_readout, hidden,
                h_out: bool = True, strip_bg: bool = True):
        with annotate('xmem.net.segment'):
            if hidden is None:
                b, o = memory_readout.shape[:2]
                hidden = self._zero_hidden(b, o, multi_scale_features[0])
            return self.model.segment(multi_scale_features, memory_readout,
                                      hidden, h_out=h_out, strip_bg=strip_bg)
