"""InferenceCore: per-frame orchestration of the segmentation loop.

Counterpart of xmem2_tpu/inference/core.py (reference
inference/inference_core.py: step :62, put_to_permanent_memory :154,
clear_memory :28, remove_from_permanent_memory :181). The host decides the
frame kind (memory frame / deep update / mask provided) from integer counters,
exactly as the reference. Images are channels-last [H, W, 3], float
(normalised) or raw uint8; masks are [O, H, W]. Runs on CUDA unless the
caller passes device='cpu'. With memory_shards > 1 the memory is sharded
(memory/manager.py) and every frame takes step()'s general path: as in the
JAX package (core.py:316, :441), neither the steady-state frame step nor
step_chunk runs over a sharded memory.
"""

from typing import List, Optional

import numpy as np
import torch

from xmem2_tpu_torch.config import resolve_device
from xmem2_tpu_torch.inference.net import XMemNet
from xmem2_tpu_torch.inference.postprocess import (
    mask_pack_bits, prob_to_mask_packed)
from xmem2_tpu_torch.inference.preprocess import preprocess_frame
from xmem2_tpu_torch.memory import store as ST
from xmem2_tpu_torch.memory.manager import MemoryManager
from xmem2_tpu_torch.ops.tensor import aggregate, pad_divide_by, unpad
from xmem2_tpu_torch.utils.profiling import annotate, count


class InferenceCore:
    def __init__(self, network: XMemNet, config: dict, device=None,
                 shard_devices=None):
        """shard_devices: the devices of a sharded memory's shards
        (MemoryManager)."""
        self.device = resolve_device(device)
        self.shard_devices = shard_devices
        if network.device != self.device:
            raise ValueError(f'network is on {network.device}, core on '
                             f'{self.device}')
        self.config = config
        self.network = network
        self.size = config.get('size', -1)
        self.mem_every = config['mem_every']
        self.deep_update_every = config['deep_update_every']
        self.enable_long_term = config['enable_long_term']
        # deep_update_every < 0: deep updates ride on memory frames
        self.deep_update_sync = (self.deep_update_every < 0)
        self.memory: Optional[MemoryManager] = None
        self.clear_memory()
        self.all_labels: Optional[List[int]] = None

    def clear_memory(self, keep_permanent: bool = False):
        self.curr_ti = -1
        self.last_mem_ti = 0
        if not self.deep_update_sync:
            self.last_deep_update_ti = -self.deep_update_every
        if keep_permanent:
            self.memory = self.memory.copy_perm_mem_only()
        else:
            self.memory = MemoryManager(config=self.config, device=self.device,
                                        shard_devices=self.shard_devices)

    def update_config(self, config: dict):
        self.mem_every = config['mem_every']
        self.deep_update_every = config['deep_update_every']
        self.enable_long_term = config['enable_long_term']
        self.deep_update_sync = (self.deep_update_every < 0)
        self.memory.update_config(config)

    def set_all_labels(self, all_labels: List[int]):
        self.all_labels = list(all_labels)

    @property
    def pack_bits(self) -> int:
        """Bit width of the packed masks step/step_chunk return (background
        + objects); pass it to unpack_mask."""
        return mask_pack_bits(1 + len(self.all_labels or []))

    # -- frame preparation ----------------------------------------------------
    def _image(self, image) -> torch.Tensor:
        """[H, W, 3] float or [H0, W0, 3] uint8 (tensor or array) ->
        normalised [3, H, W] float32 on the device."""
        if isinstance(image, np.ndarray):
            image = np.array(image)         # decoded frames are read-only
        image = torch.as_tensor(image).to(self.device)
        if image.dtype == torch.uint8:
            image = preprocess_frame(image, self.size)
        return image.float().permute(2, 0, 1)

    def _padded(self, image):
        image, self.pad = pad_divide_by(self._image(image), 16)
        return image[None]

    @torch.no_grad()
    def encode_frame_key(self, image):
        """image [H, W, 3] float or raw uint8 -> (key [1, Ck, h, w],
        shrinkage [1, 1, h, w], selection [1, Ck, h, w]), float32 on the
        device (JAX core.py:261-268)."""
        key, shrinkage, selection, *_ = self.network.encode_key(
            self._padded(image))
        return key, shrinkage, selection

    # -- steps ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, image, mask: Optional[torch.Tensor] = None,
             valid_labels: Optional[List[int]] = None, end: bool = False,
             manually_curated_masks: bool = False,
             disable_memory_updates: bool = False,
             do_not_add_mask_to_memory: bool = False,
             return_key_and_stuff: bool = False, pack_hw=None):
        """One frame. Returns prob [1+O, H, W] (background included, unpadded);
        with pack_hw, (prob, packed index mask at pack_hw)."""
        with annotate('xmem.frame'):
            count('frames')
            self.curr_ti += 1

            if manually_curated_masks:
                is_mem_frame = (mask is not None) and (not end)
            else:
                is_mem_frame = (
                    (self.curr_ti - self.last_mem_ti >= self.mem_every)
                    or (mask is not None)) and (not end)
            is_ignore = do_not_add_mask_to_memory

            need_segment = (valid_labels is None) or (
                len(self.all_labels) != len(valid_labels))
            is_deep_update = (
                (self.deep_update_sync and is_mem_frame) or
                (not self.deep_update_sync and
                 self.curr_ti - self.last_deep_update_ti
                 >= self.deep_update_every)
            ) and (not end)
            is_normal_update = (not self.deep_update_sync
                                or not is_deep_update) and (not end)

            if disable_memory_updates:
                is_normal_update = False
                is_deep_update = False
                is_mem_frame = False

            if (mask is None and need_segment
                    and not (is_mem_frame and is_ignore)
                    and self.memory.work_mem_engaged
                    and self.memory.get_hidden() is not None
                    and not self.memory.sharded):
                res, key, shrinkage, selection, packed = \
                    self._plain_frame_step(
                        image, h_out=is_normal_update, mem_frame=is_mem_frame,
                        deep_update=is_deep_update,
                        disable_usage=disable_memory_updates, pack_hw=pack_hw)
                if is_mem_frame:
                    self.last_mem_ti = self.curr_ti
                    if is_deep_update:
                        self.last_deep_update_ti = self.curr_ti
                if disable_memory_updates:
                    self.curr_ti -= 1
                if return_key_and_stuff:
                    return res, key, shrinkage, selection
                return (res, packed) if pack_hw is not None else res

            image = self._padded(image)
            key, shrinkage, selection, f16, f8, f4 = \
                self.network.encode_key(image)

            if disable_memory_updates:
                self.curr_ti -= 1  # do not advance the iteration

            if need_segment:
                memory_readout = self.memory.match_memory(
                    key, selection,
                    disable_usage_updates=disable_memory_updates)
                hidden, _, pred_prob_with_bg = self.network.segment(
                    (f16, f8, f4), memory_readout, self.memory.get_hidden(),
                    h_out=is_normal_update, strip_bg=False)
                pred_prob_with_bg = pred_prob_with_bg[0]       # [1+O, H, W]
                pred_prob_no_bg = pred_prob_with_bg[1:]
                if is_normal_update:
                    self.memory.set_hidden(hidden)
            else:
                pred_prob_no_bg = pred_prob_with_bg = None

            if mask is not None:
                mask, _ = pad_divide_by(torch.as_tensor(mask).to(self.device)
                                        .float(), 16)
                if pred_prob_no_bg is not None:
                    # make the prediction consistent with the provided mask
                    mask_regions = mask.sum(0) > 0.5
                    pred_prob_no_bg = torch.where(mask_regions[None], 0.0,
                                                  pred_prob_no_bg)
                    if valid_labels is not None:
                        # objects without a label keep their predicted
                        # probability
                        keep_pred = [i for i in range(pred_prob_no_bg.shape[0])
                                     if (i + 1) not in valid_labels]
                        if keep_pred:
                            mask = mask.clone()
                            mask[keep_pred] = pred_prob_no_bg[keep_pred]
                pred_prob_with_bg = aggregate(mask, dim=0)
                if not disable_memory_updates:
                    self.memory.create_hidden_state(len(self.all_labels), key)

            if is_mem_frame:
                value, hidden = self.network.encode_value(
                    image, f16, self.memory.get_hidden(),
                    pred_prob_with_bg[1:][None], is_deep_update=is_deep_update)
                self.memory.add_memory(
                    key, shrinkage, value, self.all_labels,
                    selection=selection if self.enable_long_term else None,
                    ignore=is_ignore)
                self.last_mem_ti = self.curr_ti
                if is_deep_update:
                    self.memory.set_hidden(hidden)
                    self.last_deep_update_ti = self.curr_ti

            with annotate('xmem.output.pack'):
                res = unpad(pred_prob_with_bg, self.pad)
                if return_key_and_stuff:
                    return res, key, shrinkage, selection
                if pack_hw is not None:
                    return res, prob_to_mask_packed(res, pack_hw)
                return res

    def _plain_frame_step(self, image, *, h_out, mem_frame, deep_update,
                          disable_usage, pack_hw):
        """The steady-state frame (no user mask): encode key -> memory match
        -> segment [-> encode value + working-memory append] [-> resize /
        argmax / pack] (the JAX package's _plain_frame_step, core.py:43-126;
        with the same hidden-state rules: the value encoder sees the
        segment's refreshed hidden state when h_out)."""
        mm = self.memory
        net = self.network
        if mem_frame:
            mm._ensure_stores()   # room for the append
        x = self._padded(image)
        key, shrinkage, selection, f16, f8, f4 = net.encode_key(x)
        h16, w16 = key.shape[-2:]
        qk = key[0].flatten(1).T
        qe = selection[0].flatten(1).T
        out = mm.match_query(qk, qe, disable_usage)
        n_obj = out.shape[0]
        readout = out.reshape(n_obj, h16, w16, -1).permute(0, 3, 1, 2)[None]

        hidden = mm.get_hidden()
        hidden_new, _, prob = net.segment((f16, f8, f4), readout, hidden,
                                          h_out=h_out, strip_bg=False)
        if mem_frame:
            value, hidden_deep = net.encode_value(
                x, f16, hidden_new if h_out else hidden, prob[:, 1:],
                is_deep_update=deep_update)
            if deep_update:
                hidden_new = hidden_deep
            count('memory.appends')
            with annotate('xmem.memory.append'):
                ST.append(mm.temp, qk, shrinkage.reshape(-1),
                          qe if self.enable_long_term else None,
                          value[0].reshape(n_obj, value.shape[2], -1)
                          .transpose(1, 2), mm._group_presence())
        if (h_out or deep_update) and hidden_new is not None:
            mm.set_hidden(hidden_new)
        if mem_frame:
            mm.note_temp_append()
        with annotate('xmem.output.pack'):
            res = unpad(prob[0], self.pad)
            packed = prob_to_mask_packed(res, pack_hw) \
                if pack_hw is not None else None
        return res, key, shrinkage, selection, packed

    def plain_run_length(self) -> int:
        """How many upcoming frames are steady-state (no memory append, no
        deep update, no mask): the longest run step_chunk may take. 0 while
        memory is not engaged. The caller still stops short of the video's
        last frame and of any frame it has a mask for."""
        if (self.all_labels is None or not self.memory.work_mem_engaged
                or self.memory.get_hidden() is None or self.memory.sharded):
            return 0
        nxt = self.curr_ti + 1
        run_end = self.last_mem_ti + self.mem_every
        if not self.deep_update_sync:
            run_end = min(run_end,
                          self.last_deep_update_ti + self.deep_update_every)
        return max(run_end - nxt, 0)

    @torch.no_grad()
    def step_chunk(self, images, pack_hw) -> List[torch.Tensor]:
        """k consecutive steady-state frames (k <= plain_run_length()):
        one batched key encoding and ONE memory match over the k*HW query
        rows with usage_frames=k (usage totals are additive over queries),
        then the per-frame decode loop, which carries the hidden state.
        Equivalent to k step() calls on plain frames (core.py:134-214,
        :452-479). images: [k, H, W, 3] float or uint8. Returns the k packed
        masks."""
        with annotate('xmem.chunk'):
            k = len(images)
            avail = self.plain_run_length()
            if not 0 < k <= avail:
                raise ValueError(
                    f'step_chunk of {k} frames, but only {avail} plain frames '
                    f'are available before the next memory/deep-update event')
            count('chunks')
            count('chunk_frames', k)
            count('frames', k)
            net = self.network
            x = torch.stack([self._image(im) for im in images])
            x, self.pad = pad_divide_by(x, 16)
            keys, _, selections, f16s, f8s, f4s = net.encode_key(x)
            ck = keys.shape[1]
            h16, w16 = keys.shape[-2:]
            qk = keys.permute(0, 2, 3, 1).reshape(-1, ck)
            qe = selections.permute(0, 2, 3, 1).reshape(-1, ck)
            out = self.memory.match_query(qk, qe, usage_frames=k)
            n_obj = out.shape[0]
            readouts = out.reshape(n_obj, k, h16, w16, -1) \
                .permute(1, 0, 4, 2, 3)

            hidden = self.memory.get_hidden()
            packs = []
            for j in range(k):
                hidden, _, prob = net.segment(
                    (f16s[j:j + 1], f8s[j:j + 1], f4s[j:j + 1]),
                    readouts[j:j + 1], hidden, h_out=True, strip_bg=False)
                with annotate('xmem.output.pack'):
                    packs.append(prob_to_mask_packed(
                        unpad(prob[0], self.pad), pack_hw))
            self.memory.set_hidden(hidden)
            self.curr_ti += k
            return packs

    @torch.no_grad()
    def put_to_permanent_memory(self, image, mask, ti: Optional[int] = None
                                ) -> bool:
        """image [H, W, 3]; mask [O, H, W]. Returns True when the frame was
        already in permanent memory and was updated in place."""
        image = self._padded(image)
        key, shrinkage, selection, f16, *_ = self.network.encode_key(image)
        mask, _ = pad_divide_by(torch.as_tensor(mask).to(self.device)
                                .float(), 16)
        pred_prob_with_bg = aggregate(mask, dim=0)
        self.memory.create_hidden_state(len(self.all_labels), key)
        value, _ = self.network.encode_value(
            image, f16, self.memory.get_hidden(),
            pred_prob_with_bg[1:][None], is_deep_update=False)

        is_update = self.memory.frame_already_saved(ti)
        if is_update:
            self.memory.update_permanent_memory(
                ti, key, shrinkage, value,
                selection=selection if self.enable_long_term else None)
        else:
            self.memory.add_memory(
                key, shrinkage, value, self.all_labels,
                selection=selection if self.enable_long_term else None,
                permanent=True, ti=ti)
        return is_update

    def remove_from_permanent_memory(self, frame_idx: int):
        self.memory.remove_from_permanent_memory(frame_idx)

    @property
    def permanent_memory_frames(self):
        return list(self.memory.frame_id_to_permanent_mem_idx.keys())
