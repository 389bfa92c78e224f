"""XMem, the network: encode_key, encode_value and segment.

Counterpart of xmem2_tpu/models/network.py (reference model/network.py:40-120).
An nn.Module whose state-dict names are the reference's
(key_encoder.*, key_proj.*, value_encoder.*, decoder.*), so a reference
checkpoint loads with load_state_dict (see bridge/torch_params.py).
Layouts are NCHW; object groups are [B, N_obj, C, H, W]. The training-only
read_memory waits for the training slice.
"""

from typing import Optional

import torch
from torch import nn

from xmem2_tpu_torch.models import modules as M
from xmem2_tpu_torch.models.resnet import Conv2d, ResNet18Trunk, ResNet50Trunk
from xmem2_tpu_torch.nn import functional as XF
from xmem2_tpu_torch.ops.tensor import aggregate


class ValueEncoder(ResNet18Trunk):
    """ResNet-18 over [frame, mask, other objects] + fuser + GRU reinforce
    (reference modules.py:102-150)."""

    def __init__(self, value_dim: int, hidden_dim: int):
        super().__init__(3 + 2)
        self.fuser = M.FeatureFusionBlock(1024, 256, value_dim, value_dim)
        self.hidden_reinforce = (M.HiddenReinforcer(value_dim, hidden_dim)
                                 if hidden_dim > 0 else None)


class Decoder(nn.Module):
    """Reference modules.py:214-250."""

    def __init__(self, value_dim: int, hidden_dim: int):
        super().__init__()
        self.fuser = M.FeatureFusionBlock(1024, value_dim + hidden_dim, 512,
                                          512)
        self.hidden_update = (M.HiddenUpdater([512, 256, 256 + 1], 256,
                                              hidden_dim)
                              if hidden_dim > 0 else None)
        self.up_16_8 = M.UpsampleBlock(512, 512, 256)
        self.up_8_4 = M.UpsampleBlock(256, 256, 256)
        self.pred = Conv2d(256, 1, 3, padding=1)


class XMem(nn.Module):
    def __init__(self, key_dim: int = 64, value_dim: int = 512,
                 hidden_dim: int = 64):
        super().__init__()
        self.key_dim, self.value_dim, self.hidden_dim = (key_dim, value_dim,
                                                         hidden_dim)
        self.key_encoder = ResNet50Trunk()
        self.value_encoder = ValueEncoder(value_dim, hidden_dim)
        self.key_proj = M.KeyProjection(1024, key_dim)
        self.decoder = Decoder(value_dim, hidden_dim)

    @property
    def disable_hidden(self) -> bool:
        return self.hidden_dim <= 0

    def encode_key(self, frame: torch.Tensor, need_sk: bool = True,
                   need_ek: bool = True):
        """frame [B, 3, H, W] -> (key, shrinkage, selection, f16, f8, f4).

        key [B, Ck, h, w], shrinkage [B, 1, h, w] and selection [B, Ck, h, w]
        are float32; the features keep the compute dtype."""
        f4, f8, f16 = self.key_encoder(frame)
        key, shrinkage, selection = self.key_proj(f16, need_sk, need_ek)
        return key, shrinkage, selection, f16, f8, f4

    def encode_value(self, frame: torch.Tensor, f16: torch.Tensor,
                     hidden: Optional[torch.Tensor], masks: torch.Tensor,
                     is_deep_update: bool = True):
        """frame [B, 3, H, W]; f16 [B, 1024, h, w]; hidden [B, N, Ch, h, w]
        or None; masks [B, N, H, W] -> (value [B, N, Cv, h, w], hidden')."""
        ve = self.value_encoder
        b, n = masks.shape[:2]
        if n != 1:
            others = masks.sum(dim=1, keepdim=True) - masks
        else:
            others = torch.zeros_like(masks)
        g = torch.stack([masks, others], dim=2)             # [B, N, 2, H, W]
        g = M.distribute(frame.to(g.dtype), g)              # [B, N, 5, H, W]
        g = ve.trunk(g.flatten(0, 1))
        g = g.reshape((b, n) + g.shape[1:])
        g = ve.fuser(f16, g)
        if is_deep_update and ve.hidden_reinforce is not None \
                and hidden is not None:
            hidden = ve.hidden_reinforce(g, hidden)
        return g, hidden

    def segment(self, multi_scale_features, memory_readout: torch.Tensor,
                hidden: Optional[torch.Tensor], h_out: bool = True,
                strip_bg: bool = True):
        """multi_scale_features (f16, f8, f4); memory_readout
        [B, N, Cv, h, w]; hidden [B, N, Ch, h, w] or None.
        Returns (hidden', logits [B, 1+N, H, W], prob [B, {N|1+N}, H, W])."""
        dec = self.decoder
        f16, f8, f4 = multi_scale_features
        b, n = memory_readout.shape[:2]
        if not self.disable_hidden and hidden is not None:
            g16 = dec.fuser(f16, torch.cat(
                [memory_readout, hidden.to(memory_readout.dtype)], dim=2))
        else:
            g16 = dec.fuser(f16, memory_readout)
        g8 = dec.up_16_8(f8, g16)
        g4 = dec.up_8_4(f4, g8)

        logits = dec.pred(torch.relu(g4.flatten(0, 1))).float()
        if h_out and not self.disable_hidden and hidden is not None:
            g4h = torch.cat([g4, logits.reshape((b, n) + logits.shape[1:])
                             .to(g4.dtype)], dim=2)
            hidden = dec.hidden_update(g16, g8, g4h, hidden)
        else:
            hidden = None

        h4, w4 = logits.shape[-2:]
        logits = XF.resize_bilinear(logits, (h4 * 4, w4 * 4))
        prob = torch.sigmoid(logits.reshape((b, n) + logits.shape[-2:]))
        logits_out, prob = aggregate(prob, dim=1, return_logits=True)
        if strip_bg:
            prob = prob[:, 1:]
        return hidden, logits_out, prob
