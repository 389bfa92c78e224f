"""Frame annotation candidate selection: diversity-driven greedy picking.

Counterpart of xmem2_tpu/inference/frame_selection/frame_selection.py
(reference inference/frame_selection/frame_selection.py: select_next_candidates
:99, baselines :18-26). The criterion is the pairwise cycle dissimilarity
relu(sim(A->B) - sim(B->A)).mean() over composite keys
(key * (alpha * mask + (1 - alpha))), greedily maximising the minimum
dissimilarity to the frames already chosen. As in the JAX package, each
round computes one candidate against all frames (batched matrix products on
the device) and keeps a running minimum: O(k * N) pairs.

Precision: float32 without TF32 (config.pin_f32_precision); the choice is an
argmax over the dissimilarities, which TF32 rounding could flip.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch

from xmem2_tpu_torch.config import pin_f32_precision, resolve_device
from xmem2_tpu_torch.ops.similarity import get_similarity
from xmem2_tpu_torch.utils.resize_np import resize_nearest_np

# bytes of [HW, HW] float32 intermediates one frame pair holds at once
# (fwd, rev and the similarity's partial products); a batch of pairs is cut
# to stay within _BATCH_BYTES (HW = 1,620 at 480p: 63 MB a pair)
_PAIR_MATRICES = 6
_BATCH_BYTES = 1 << 30


def first_frame_only(*args, **kwargs):
    return [0]


def uniformly_selected_frames(num_total_frames: int, how_many_frames=10,
                              **kwargs) -> List[int]:
    return np.linspace(0, num_total_frames - 1,
                       how_many_frames).astype(int).tolist()


def cycle_dissimilarity(comp_c, sh_c, se_c, comp, sh, se) -> torch.Tensor:
    """d(c, j) of one frame c against a batch of frames j (reference
    frame_selection.py:215-224). comp_c/se_c [HW, Ck], sh_c [HW]; comp/se
    [B, HW, Ck], sh [B, HW]. Returns [B].

    fwd = sim(mem=c, query=j) and rev = sim(mem=j, query=c) are both
    query-major [B, HW, HW] and are subtracted elementwise as they are,
    fwd - rev and not fwd - rev.mT: the reference subtracts its two matrices
    in their own, mutually transposed, layouts (frame_selection.py:220),
    which in the query-major layout is exactly fwd - rev."""
    fwd = get_similarity(comp_c, sh_c, comp, se)
    rev = get_similarity(comp, sh, comp_c, se_c)
    cycle = fwd - rev
    return torch.relu(cycle).sum(dim=(1, 2)) / cycle[0].numel()


def _composite(keys: torch.Tensor, masks: Sequence, hw: tuple,
               previously_chosen: Sequence[int], alpha: float,
               min_mask_presence_percent: float, epsilon: float,
               print_progress: bool):
    """keys [N, HW, Ck] -> (composite keys [N, HW, Ck], validity [N] bool).
    A frame whose mask union covers less than min_mask_presence_percent of
    its pixels is invalid (and its composite zero) unless already chosen."""
    n = keys.shape[0]
    h, w = hw
    validity = np.ones(n, bool)
    m_small = np.zeros((n, h * w, 1), np.float32)
    for i, mask in enumerate(masks):
        mask = np.asarray(mask)
        if mask.ndim == 2:
            mask = mask[None]
        mask_bin = mask.max(axis=0)                       # union of objects
        ratio = (mask_bin > epsilon).sum() / mask_bin.size * 100
        if ratio < min_mask_presence_percent and i not in previously_chosen:
            validity[i] = False
            continue
        m_small[i] = resize_nearest_np(mask.max(axis=0, keepdims=True),
                                       (h, w))[0].reshape(h * w, 1)
    if print_progress:
        print(f'Frames with invalid (empty or too small) masks: '
              f'{int((~validity).sum())} / {n}')
    dev = keys.device
    m = torch.from_numpy(m_small).to(dev)
    valid = torch.from_numpy(validity).to(dev)
    comp = keys * m
    comp = comp * alpha + keys * (1 - alpha)
    comp = torch.where(valid[:, None, None], comp, 0.0)
    return comp, valid


@torch.no_grad()
def select_candidates_from_rows(keys: torch.Tensor, shrinkages: torch.Tensor,
                                selections: torch.Tensor, hw: tuple,
                                masks: Sequence, num_next_candidates: int,
                                previously_chosen_candidates=(0,),
                                print_progress=False, alpha=0.5,
                                min_mask_presence_percent=0.25,
                                progress_callback=None,
                                only_new_candidates=True, epsilon=0.5,
                                batch_size: int = 64) -> List[int]:
    """select_next_candidates on device tensors in row layout: keys and
    selections [N, HW, Ck], shrinkages [N, HW] (any strides), hw = (h, w)
    of the key grid. Runs where the tensors are."""
    n = keys.shape[0]
    assert n == len(masks) and n > 0
    assert num_next_candidates > 0
    assert 0 < len(previously_chosen_candidates) < n
    assert 0.0 <= alpha <= 1.0
    assert min_mask_presence_percent >= 0
    pin_f32_precision()

    comp, valid = _composite(keys.float(), masks, hw,
                             list(previously_chosen_candidates), alpha,
                             min_mask_presence_percent, epsilon,
                             print_progress)
    shr, sel = shrinkages.float(), selections.float()
    pixels = hw[0] * hw[1]
    batch = max(1, min(batch_size,
                       _BATCH_BYTES // (_PAIR_MATRICES * 4 * pixels ** 2)))

    def min_against(c: int, dmin: torch.Tensor) -> torch.Tensor:
        d = torch.cat([cycle_dissimilarity(comp[c], shr[c], sel[c],
                                           comp[s:s + batch],
                                           shr[s:s + batch],
                                           sel[s:s + batch])
                       for s in range(0, n, batch)])
        return torch.minimum(dmin, d)

    chosen = list(previously_chosen_candidates)
    # running min over the chosen candidates of d(c, j) for each frame j
    dmin = torch.full((n,), torch.inf, device=keys.device)
    for c in chosen:
        dmin = min_against(c, dmin)
    for i in range(num_next_candidates):
        scores = torch.where(valid, dmin, 0.0)
        new_c = int(torch.argmax(scores))     # the first maximum, as jnp
        chosen.append(new_c)
        dmin = min_against(new_c, dmin)
        if print_progress:
            print(f'candidate {i + 1}/{num_next_candidates}: frame {new_c}')
        if progress_callback is not None:
            progress_callback.emit(i + 1)

    if only_new_candidates:
        return chosen[len(previously_chosen_candidates):]
    return chosen


def select_next_candidates(keys, shrinkages, selections,
                           masks: Sequence, num_next_candidates: int,
                           previously_chosen_candidates=(0,),
                           print_progress=False, alpha=0.5,
                           min_mask_presence_percent=0.25,
                           progress_callback=None, only_new_candidates=True,
                           epsilon=0.5, batch_size: int = 64,
                           device: Optional[str] = None) -> List[int]:
    """Greedy max-min cycle-dissimilarity frame selection, with the JAX
    package's signature and layouts (plus `device`: CUDA unless 'cpu' is
    passed):

    keys:       [N, h, w, Ck]  channels-last, numpy array or tensor
    shrinkages: [N, h, w, 1]
    selections: [N, h, w, Ck]
    masks:      list of [O, H, W] (or [H, W]) float arrays
    Returns the chosen frame indices (only the new ones when
    only_new_candidates)."""
    dev = resolve_device(device)
    n, h, w, ck = keys.shape

    def rows(x, *tail):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x.to(dev).reshape((n, h * w) + tail)

    return select_candidates_from_rows(
        rows(keys, ck), rows(shrinkages), rows(selections, ck),
        (h, w), masks, num_next_candidates,
        previously_chosen_candidates=previously_chosen_candidates,
        print_progress=print_progress, alpha=alpha,
        min_mask_presence_percent=min_mask_presence_percent,
        progress_callback=progress_callback,
        only_new_candidates=only_new_candidates, epsilon=epsilon,
        batch_size=batch_size)
