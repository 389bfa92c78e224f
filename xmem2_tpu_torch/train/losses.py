"""Training losses: bootstrapped cross-entropy + dice.

Counterpart of xmem2_tpu/train/losses.py (reference model/losses.py:
dice_loss :8, BootstrappedCE :23, LossComputer :46). The warm-up's kept
fraction p depends only on the host's step counter, so the hard-pixel mining
is torch.topk with a host-computed k where the JAX package sorts and masks a
prefix inside its compiled step; p and k are computed in float32 as there, so
both keep the same pixels.
"""

from typing import Dict, List

import numpy as np
import torch

NEG_INF = -1e30


def dice_loss(input_mask: torch.Tensor, cls_gt: torch.Tensor) -> torch.Tensor:
    """input_mask [B, O, H, W] probabilities (bg stripped); cls_gt [B, H, W]
    int. Averaged over every (batch, object slot) pair, the empty slots too:
    their selector-zeroed masks give a loss of ~0 through the (num + 1) /
    (den + 1) smoothing."""
    b, o = input_mask.shape[:2]
    mask = input_mask.reshape(b, o, -1)
    labels = torch.arange(1, o + 1, device=cls_gt.device)
    gt = (cls_gt[:, None] == labels[None, :, None, None]).float().reshape(
        b, o, -1)
    numerator = 2 * torch.sum(mask * gt, -1)
    denominator = torch.sum(mask, -1) + torch.sum(gt, -1)
    return torch.mean(1 - (numerator + 1) / (denominator + 1))


def warm_fraction(it: int, start_warm: int, end_warm: int,
                  top_p: float = 0.15) -> float:
    """The kept fraction p at step `it`: 1 before start_warm, annealed
    linearly to top_p at end_warm (reference BootstrappedCE.forward :31-43),
    in float32 like the JAX package's traced schedule."""
    if it < start_warm:
        return 1.0
    if it > end_warm:
        return float(np.float32(top_p))
    frac = np.float32(end_warm - it) / np.float32(end_warm - start_warm)
    return float(np.float32(top_p) + np.float32(1 - top_p) * frac)


def bootstrapped_ce(logits: torch.Tensor, cls_gt: torch.Tensor,
                    class_valid: torch.Tensor, it: int, start_warm: int,
                    end_warm: int, top_p: float = 0.15):
    """logits [B, C, H, W] (C = 1 + objects); cls_gt [B, H, W] int;
    class_valid [B, C] bool. Per batch item: the plain CE over valid classes
    before start_warm, afterwards the mean of the top-p fraction of hardest
    pixels. Returns (loss, p)."""
    b = logits.shape[0]
    masked = torch.where(class_valid[:, :, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    lp = masked - torch.logsumexp(masked, dim=1, keepdim=True)
    raw = -lp.gather(1, cls_gt[:, None].long())[:, 0].reshape(b, -1)
    if it < start_warm:
        return raw.mean(-1).mean(), 1.0
    p = warm_fraction(it, start_warm, end_warm, top_p)
    k = int(np.floor(np.float32(raw.shape[-1]) * np.float32(p)))
    hard = torch.topk(raw, k, dim=-1, sorted=False).values
    return (hard.sum(-1) / max(k, 1)).mean(), p


def compute_losses(logits_seq: List[torch.Tensor],
                   masks_seq: List[torch.Tensor], cls_gt: torch.Tensor,
                   class_valid: torch.Tensor, it: int, start_warm: int,
                   end_warm: int) -> Dict[str, torch.Tensor]:
    """Sequence loss (reference LossComputer.compute :52-68). logits_seq /
    masks_seq are indexed by ti - 1, [B, 1+O, H, W] / [B, O, H, W]; cls_gt
    [B, T, H, W]; class_valid [B, 1+O]."""
    t = len(logits_seq) + 1
    losses = {}
    total, p_sum = 0.0, 0.0
    for ti in range(1, t):
        ce, p = bootstrapped_ce(logits_seq[ti - 1], cls_gt[:, ti],
                                class_valid, it, start_warm, end_warm)
        d = dice_loss(masks_seq[ti - 1], cls_gt[:, ti])
        losses[f'ce_loss_{ti}'] = ce
        losses[f'dice_loss_{ti}'] = d
        p_sum += p / (t - 1)
        total = total + ce + d
    losses['p'] = torch.tensor(p_sum)
    losses['total_loss'] = total
    return losses
