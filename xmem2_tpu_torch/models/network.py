"""XMem, the network: encode_key, encode_value and segment.

Counterpart of xmem2_tpu/models/network.py (reference model/network.py:40-120).
An nn.Module whose state-dict names are the reference's
(key_encoder.*, key_proj.*, value_encoder.*, decoder.*), so a reference
checkpoint loads with load_state_dict (see bridge/torch_params.py).
Layouts are NCHW; object groups are [B, N_obj, C, H, W]. read_memory is
the training path's dense memory read; inference reads memory through
memory/manager.py and its kernels.
"""

from typing import Optional

import torch
from torch import nn

from xmem2_tpu_torch.models import modules as M
from xmem2_tpu_torch.models.resnet import Conv2d, ResNet18Trunk, ResNet50Trunk
from xmem2_tpu_torch.nn import functional as XF
from xmem2_tpu_torch.ops.similarity import get_similarity, masked_softmax
from xmem2_tpu_torch.ops.tensor import aggregate


class ValueEncoder(ResNet18Trunk):
    """ResNet-18 over [frame, mask, other objects] (or [frame, mask] for a
    single-object network) + fuser + GRU reinforce (reference
    modules.py:102-150)."""

    def __init__(self, value_dim: int, hidden_dim: int,
                 single_object: bool = False):
        super().__init__(3 + (1 if single_object else 2))
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
    """single_object: the stage-0 network, whose value encoder sees the
    frame and one mask (3 + 1 channels) and no "others" channel (reference
    network.py:22, 76-80)."""

    def __init__(self, key_dim: int = 64, value_dim: int = 512,
                 hidden_dim: int = 64, single_object: bool = False):
        super().__init__()
        self.key_dim, self.value_dim, self.hidden_dim = (key_dim, value_dim,
                                                         hidden_dim)
        self.single_object = single_object
        self.key_encoder = ResNet50Trunk()
        self.value_encoder = ValueEncoder(value_dim, hidden_dim, single_object)
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
        if self.single_object:
            g = masks[:, :, None]                            # [B, N, 1, H, W]
        else:
            if n != 1:
                others = masks.sum(dim=1, keepdim=True) - masks
            else:
                others = torch.zeros_like(masks)
            g = torch.stack([masks, others], dim=2)         # [B, N, 2, H, W]
        g = M.distribute(frame.to(g.dtype), g)              # [B, N, 4|5, H, W]
        g = ve.trunk(g.flatten(0, 1))
        g = g.reshape((b, n) + g.shape[1:])
        g = ve.fuser(f16, g)
        if is_deep_update and ve.hidden_reinforce is not None \
                and hidden is not None:
            hidden = ve.hidden_reinforce(g, hidden)
        return g, hidden

    def segment(self, multi_scale_features, memory_readout: torch.Tensor,
                hidden: Optional[torch.Tensor], h_out: bool = True,
                strip_bg: bool = True,
                selector: Optional[torch.Tensor] = None):
        """multi_scale_features (f16, f8, f4); memory_readout
        [B, N, Cv, h, w]; hidden [B, N, Ch, h, w] or None; selector
        [B, N, 1, 1] zeroes the probabilities of empty object slots before
        aggregation (training).
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
        if selector is not None:
            prob = prob * selector
        logits_out, prob = aggregate(prob, dim=1, return_logits=True)
        if strip_bg:
            prob = prob[:, 1:]
        return hidden, logits_out, prob

    @staticmethod
    def read_memory(query_key: torch.Tensor, query_selection: torch.Tensor,
                    memory_key: torch.Tensor, memory_shrinkage: torch.Tensor,
                    memory_value: torch.Tensor) -> torch.Tensor:
        """Training's dense memory read (reference network.py:89-105): the
        full softmax of the similarity over every memory slot, then the
        value readout, in float32 with autocast off (the JAX package runs
        both products at Precision.HIGHEST).

        query_key / query_selection [B, Ck, h, w]; memory_key [B, T, Ck, h, w];
        memory_shrinkage [B, T, 1, h, w]; memory_value [B, O, T, Cv, h, w].
        Returns [B, O, Cv, h, w]."""
        b, o, t, cv, h, w = memory_value.shape
        with torch.autocast(query_key.device.type, enabled=False):
            mk = memory_key.float().permute(0, 1, 3, 4, 2).reshape(
                b, t * h * w, -1)
            ms = memory_shrinkage.float().reshape(b, t * h * w)
            qk = query_key.float().flatten(2).mT               # [B, hw, Ck]
            qe = query_selection.float().flatten(2).mT
            aff = masked_softmax(get_similarity(mk, ms, qk, qe))  # [B, hw, N]
            mv = memory_value.float().permute(0, 1, 2, 4, 5, 3).reshape(
                b, o, t * h * w, cv)
            out = aff[:, None] @ mv                            # [B, O, hw, Cv]
        return out.mT.reshape(b, o, cv, h, w)
