"""SessionController — the GUI App's brain, with no Qt dependency.

Counterpart of xmem2_tpu/interactive/session.py (behavioral parity:
reference inference/interact/gui.py — propagation loops :714-816, reference
save/remove :851-877, candidate computation :818-850, live config mutation
:1120-1128, memory gauges :1073-1088, imports :1193-1230). The Qt App
(interactive/gui.py) delegates to this class; headless callers and tests
drive it directly. Frames, probabilities and the key cache stay on the
processor's device; each propagated frame copies back its index mask and
its 1/16-scale probabilities.
"""

import re
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from xmem2_tpu_torch.inference.frame_selection.frame_selection import (
    select_next_candidates)
from xmem2_tpu_torch.interactive.interaction import (
    ClickInteraction, FreeInteraction, ScribbleInteraction)
from xmem2_tpu_torch.interactive.interactive_utils import (
    get_visualization, image_to_torch, index_numpy_to_one_hot,
    prob_to_numpy_mask)


class SessionController:
    """processor: an InferenceCore; its device is the session's."""

    def __init__(self, processor, resource_manager, s2m_ctrl=None,
                 fbrs_ctrl=None, config: Optional[dict] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.processor = processor
        self.device = processor.device
        self.res_man = resource_manager
        self.s2m_controller = s2m_ctrl
        self.fbrs_controller = fbrs_ctrl
        self.config = dict(config or {})
        self.log = log or (lambda msg: None)

        self.num_objects = resource_manager.num_objects
        self.processor.set_all_labels(list(range(1, self.num_objects + 1)))
        self.num_frames = len(resource_manager)
        self.height, self.width = resource_manager.h, resource_manager.w

        self.cursur = 0
        self.current_object = 1
        self.viz_mode = 'davis'
        self.interaction = None
        self.propagating = False
        self.brush_size = 3
        self.layer = None

    # ------------------------------------------------------------- frames
    def image(self, fi: int) -> torch.Tensor:
        """Frame fi normalized, [H, W, 3] on the device."""
        norm, _ = image_to_torch(self.res_man.get_image(fi), self.device)
        return norm

    def current_image(self) -> torch.Tensor:
        return self.image(self.cursur)

    def current_mask(self) -> np.ndarray:
        m = self.res_man.get_mask(self.cursur)
        if m is None:
            return np.zeros((self.height, self.width), np.uint8)
        return m.copy()

    def set_cursor(self, fi: int):
        self.cursur = int(np.clip(fi, 0, self.num_frames - 1))
        self.interaction = None
        if self.fbrs_controller is not None:
            self.fbrs_controller.unanchor()

    def visualization(self, save: bool = True) -> np.ndarray:
        image = self.res_man.get_image(self.cursur)
        viz = get_visualization(self.viz_mode, image, self.current_mask(),
                                self.layer, self.current_object)
        if save:
            self.res_man.save_visualization(self.cursur, viz)
        return viz

    # -------------------------------------------------------- interactions
    def push_point(self, x: float, y: float, is_neg: bool, mode: str):
        """mode: 'free' | 'scribble' | 'click'. Creates/extends the current
        interaction (reference gui.py:1012-1060)."""
        if mode == 'click':
            if not isinstance(self.interaction, ClickInteraction):
                prev = index_numpy_to_one_hot(self.current_mask(),
                                              self.num_objects + 1)
                self.interaction = ClickInteraction(
                    self.current_image(), prev, (self.height, self.width),
                    self.fbrs_controller, self.current_object)
            self.interaction.push_point(x, y, is_neg)
            return self.commit_interaction()
        if mode == 'scribble':
            if not isinstance(self.interaction, ScribbleInteraction):
                self.interaction = ScribbleInteraction(
                    self.current_image(), self.current_mask(),
                    (self.height, self.width), self.s2m_controller,
                    self.num_objects)
        else:
            if not isinstance(self.interaction, FreeInteraction):
                self.interaction = FreeInteraction(
                    None, self.current_mask(), (self.height, self.width),
                    self.num_objects)
                self.interaction.set_size(self.brush_size)
        self.interaction.push_point(x, y, 0 if is_neg else self.current_object)
        return None

    def set_brush_size(self, size: int):
        """Live brush-size update (reference gui.py:682-689 brush_slide)."""
        self.brush_size = int(size)
        if isinstance(self.interaction, FreeInteraction):
            self.interaction.set_size(self.brush_size)

    def end_path(self):
        if self.interaction is None:
            return None
        self.interaction.end_path()
        return self.commit_interaction()

    def commit_interaction(self) -> np.ndarray:
        mask = prob_to_numpy_mask(self.interaction.predict())
        self.res_man.save_mask(self.cursur, mask)
        return mask

    def commit(self) -> Optional[np.ndarray]:
        """Explicit Commit (reference gui.py:804-806 on_commit =
        complete_interaction + update_interacted_mask): finalize the current
        interaction into the saved mask and END it, so the next stroke starts
        a fresh interaction from the committed result instead of extending
        this one. No-op (returns None) when nothing is in flight."""
        if self.interaction is None:
            return None
        mask = self.commit_interaction()
        self.interaction = None
        return mask

    def reset_mask(self) -> np.ndarray:
        """Reset/Delete the current frame's mask (reference gui.py:910-917
        on_reset_mask): zero it, save, and abandon any in-flight interaction
        — the documented workaround for the negative-masks limitation
        (docs/LIMITATIONS.md)."""
        mask = np.zeros((self.height, self.width), np.uint8)
        self.res_man.save_mask(self.cursur, mask)
        self.interaction = None
        if self.fbrs_controller is not None:
            self.fbrs_controller.unanchor()
        return mask

    # -------------------------------------------------------- propagation
    def propagate(self, direction: str = 'forward',
                  on_frame: Optional[Callable[[int], None]] = None) -> int:
        """Forward/backward propagation from the current frame's mask
        (reference gui.py:751-816). on_frame(ti) is the UI refresh hook
        (QApplication.processEvents in the reference). Returns the number of
        frames propagated."""
        mask = self.res_man.get_mask(self.cursur)
        if mask is None or mask.max() == 0:
            self.log('No mask on the current frame to propagate from.')
            return 0
        self.propagating = True

        onehot = index_numpy_to_one_hot(mask, self.num_objects + 1)[1:]
        image = self.current_image()
        self.processor.clear_memory(keep_permanent=True)
        prob = self.processor.step(image, torch.from_numpy(onehot),
                                   list(range(1, self.num_objects + 1)))
        self._store_step(self.cursur, prob, image)

        rng = (range(self.cursur + 1, self.num_frames)
               if direction == 'forward'
               else range(self.cursur - 1, -1, -1))
        count = 0
        for ti in rng:
            if not self.propagating:
                break
            self.cursur = ti
            norm = self.image(ti)
            prob, key, shrinkage, selection = self.processor.step(
                norm, return_key_and_stuff=True)
            self._store_step(ti, prob, norm, key, shrinkage, selection)
            count += 1
            if on_frame is not None:
                on_frame(ti)
        self.propagating = False
        return count

    def full_propagate(self, on_frame=None) -> int:
        """FULL: clear to permanent only, start from the first reference
        (reference gui.py:714-750)."""
        self.clear_memory()
        ref_frames = sorted(self.res_man.references)
        self.cursur = ref_frames[0] if ref_frames else 0
        return self.propagate('forward', on_frame=on_frame)

    def stop(self):
        self.propagating = False

    def clear_memory(self):
        self.processor.clear_memory(keep_permanent=True)
        self.log('Working/long-term memory cleared (permanent kept).')

    def _store_step(self, ti, prob, image, key=None, shrinkage=None,
                    selection=None):
        """Saves the frame's mask and caches its key, shrinkage and
        selection channels-last on the device ([1, C, h, w] from the
        processor -> [1, h, w, C]) with its 1/16-scale probabilities."""
        self.res_man.save_mask(ti, prob_to_numpy_mask(prob))
        if key is None:
            key, shrinkage, selection = self.processor.encode_frame_key(image)
        small = prob[1:, ::16, ::16].float().cpu().numpy()

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        self.res_man.add_key_and_stuff_with_mask(
            ti, nhwc(key), nhwc(shrinkage), nhwc(selection), small)

    # --------------------------------------------------------- references
    def save_reference(self) -> bool:
        mask = self.res_man.get_mask(self.cursur)
        if mask is None or mask.max() == 0:
            self.log('No mask to save as reference.')
            return False
        self.put_reference(self.cursur, mask)
        self.res_man.add_reference(self.cursur)
        self.log(f'Frame {self.cursur} saved to permanent memory.')
        return True

    def put_reference(self, fi: int, mask: np.ndarray):
        onehot = index_numpy_to_one_hot(mask, self.num_objects + 1)[1:]
        self.processor.put_to_permanent_memory(
            self.image(fi), torch.from_numpy(onehot), ti=fi)

    def remove_reference(self) -> bool:
        if self.cursur not in self.res_man.references:
            self.log('Current frame is not a reference.')
            return False
        self.processor.remove_from_permanent_memory(self.cursur)
        self.res_man.remove_reference(self.cursur)
        self.log(f'Frame {self.cursur} removed from permanent memory.')
        return True

    def replay_references(self) -> List[int]:
        """Re-insert saved references on startup (reference gui.py:599-603)."""
        replayed = []
        for fi in sorted(self.res_man.references):
            mask = self.res_man.get_mask(fi)
            if mask is None:
                continue
            self.put_reference(fi, mask)
            replayed.append(fi)
        return replayed

    # --------------------------------------------------------- candidates
    def compute_candidates(self, k: int = 5,
                           min_mask_presence_percent: float = 0.25
                           ) -> Optional[List[int]]:
        """Diversity-driven next-annotation candidates from the cached keys
        (reference gui.py:818-850); a frame whose masks cover less than
        min_mask_presence_percent of it scores 0 (select_next_candidates).
        Synchronous — callers needing a thread wrap it (the Qt App uses a
        QThreadPool Worker)."""
        if not self.res_man.all_masks_present():
            self.log('Some frames lack cached keys/masks — run FULL '
                     'propagation first.')
            return None
        return [int(c) for c in select_next_candidates(
            self.res_man.keys, self.res_man.shrinkages,
            self.res_man.selections, list(self.res_man.small_masks), k,
            previously_chosen_candidates=sorted(self.res_man.references)
            or [0],
            alpha=0.5, only_new_candidates=True,
            min_mask_presence_percent=min_mask_presence_percent,
            device=self.res_man.keys.device)]

    # ------------------------------------------------------------- import
    def import_mask(self, file_name: str, save_ref: bool = True) -> bool:
        """Import one mask onto the current frame (reference
        gui.py:1193-1240 on_import_mask): validate shape and object count,
        save, and — unless save_ref=False (the bulk-import path, where
        references for 1000+ masks would explode memory) — also save the
        frame to permanent memory as a reference."""
        mask = self.res_man.read_external_image(
            file_name, size=(self.height, self.width), force_mask=True)
        if mask.ndim != 2 or mask.shape != (self.height, self.width):
            self.log(f'Expected ({self.height}, {self.width}). '
                     f'Got {mask.shape} instead.')
            return False
        if mask.max() > self.num_objects:
            self.log(f'Expected {self.num_objects} objects. '
                     f'Got {mask.max()} objects instead.')
            return False
        self.res_man.save_mask(self.cursur, mask)
        if save_ref:
            self.interaction = None
            self.save_reference()
        return True

    def import_all_masks(self, dir_path: str,
                         on_progress: Optional[Callable[[int], None]] = None,
                         bulk_threshold: int = 10) -> dict:
        """Bulk mask import from a directory (reference gui.py:1143-1191
        on_import_all_masks). Frame ids are the first digit run in each
        filename; any file without digits, or ids out of sorted order, abort
        the import. Batches larger than `bulk_threshold` import WITHOUT
        saving references (the reference suppresses per-mask reference saving
        so permanent memory doesn't explode) and park the cursor at frame 0;
        small batches import each mask AND save it as a reference, like
        individual imports. Returns {'imported': n, 'errors': [...]}."""
        pattern = re.compile(r'([0-9]+)')
        files = sorted(p for p in Path(dir_path).iterdir() if p.is_file())
        frame_ids, incorrect = [], []
        for p in files:
            m = pattern.search(p.name)
            if m:
                frame_ids.append(int(m.group(1)))
            else:
                incorrect.append(p.name)
        if incorrect:
            self.log('Files with incorrect names: ' + '\n'.join(incorrect))
            return {'imported': 0, 'errors': incorrect}
        if frame_ids != sorted(frame_ids):
            self.log('Mask frame ids are not in sorted order.')
            return {'imported': 0, 'errors': ['unsorted frame ids']}
        bad = [fi for fi in frame_ids if fi >= self.num_frames]
        if bad:
            self.log(f'Mask frame ids out of range: {bad}')
            return {'imported': 0, 'errors': [f'frame id {fi} >= '
                                              f'{self.num_frames}'
                                              for fi in bad]}
        bulk = len(frame_ids) > bulk_threshold
        imported, errors = 0, []
        for i, (fi, p) in enumerate(zip(frame_ids, files)):
            self.set_cursor(fi)
            if self.import_mask(str(p), save_ref=not bulk):
                imported += 1
            else:
                errors.append(p.name)
            if on_progress is not None:
                on_progress(i + 1)
        if bulk:
            self.set_cursor(0)
        return {'imported': imported, 'errors': errors}

    def import_layer(self, file_name: str) -> bool:
        layer = self.res_man.read_external_image(
            file_name, size=(self.height, self.width))
        if layer.ndim == 3 and layer.shape[-1] == 4:
            self.layer = layer
            self.viz_mode = 'layered'
            return True
        self.log('Layer must be RGBA.')
        return False

    # -------------------------------------------------------------- misc
    def update_config(self, overrides: dict):
        """Live memory-parameter mutation (reference gui.py:1120-1128)."""
        cfg = dict(self.config)
        cfg.update(overrides)
        self.config = cfg
        self.processor.update_config(cfg)

    def memory_stats(self) -> dict:
        """Memory sizes in slots; on CUDA also the bytes the caching
        allocator holds for tensors (torch.cuda.memory_allocated). The JAX
        package reads its device's stats and swallows any error; here a CPU
        session simply has no device entry."""
        mm = self.processor.memory
        stats = {'temp': mm.temp_size, 'perm': mm.perm_size,
                 'long': mm.long_size}
        if self.device.type == 'cuda':
            stats['device_bytes_in_use'] = int(
                torch.cuda.memory_allocated(self.device))
        return stats
