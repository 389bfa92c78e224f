"""XMemTrainer: multi-frame unrolled training, on one card or under DDP.

Counterpart of xmem2_tpu/train/trainer.py (reference model/trainer.py:
XMemTrainer :20, do_pass :56, save/load :160-214):
  * train_forward keys every frame of the clip at once, then unrolls the
    frames: memory read, segment, value encoding of the predicted masks;
  * the reference-frame draws and the deep-update coin come from a
    torch.Generator seeded with the step (the JAX package draws from
    jax.random inside its compiled step); the deep update is computed every
    time and selected with torch.where, as there, so every parameter is in
    the graph of every step (DDP needs no find_unused_parameters);
  * AdamW with MultiStepLR (optax.adamw with a piecewise-constant schedule
    there: the rate changes when the count reaches a boundary, here after
    that many scheduler steps);
  * bf16 through torch.autocast with float32 master weights by default,
    float32 without TF32 with amp off;
  * batch-norm weights and biases train, the running statistics are frozen
    buffers, as in the reference (the JAX trainer also moves the statistics,
    ROADMAP.md Queue 3);
  * under torch.distributed (torchrun) the network is wrapped in DDP, NCCL
    on the card, gloo on the CPU; each rank takes its share of the batch.
    On a step whose losses are logged or recorded they are averaged over
    the ranks first, so they are the whole batch's, as the JAX step's are
    (xmem2_tpu/train/trainer.py:196-199): every rank has an equal share,
    the bootstrapped cross-entropy is a mean of per-item means and the dice
    loss a mean over (item, object) pairs.
"""

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from xmem2_tpu_torch.bridge.torch_params import Dims, build_train_model, \
    convert_state_dict, save_network, state_dict_numpy
from xmem2_tpu_torch.config import pin_f32_precision, resolve_device
from xmem2_tpu_torch.models.network import XMem
from xmem2_tpu_torch.train.losses import compute_losses


def sample_draws(gen: torch.Generator, b: int, num_frames: int,
                 num_ref_frames: int, deep_update_prob: float):
    """The step's random draws, on the host: for each query frame ti >= 1,
    the memory frames [B, R] (None: every earlier frame, while ti <=
    num_ref_frames; else frame 0 and R - 1 distinct random frames of
    [1, ti), reference trainer.py:87-101) and, for every frame but the last,
    whether its value encoding also updates the hidden state."""
    ref_idx, deep = [], []
    for ti in range(1, num_frames):
        if ti <= num_ref_frames:
            ref_idx.append(None)
        else:
            ref_idx.append(torch.stack([torch.cat([
                torch.zeros(1, dtype=torch.long),
                torch.randperm(ti - 1, generator=gen)[:num_ref_frames - 1]
                + 1]) for _ in range(b)]))
        if ti < num_frames - 1:
            deep.append(bool(torch.rand((), generator=gen)
                             < deep_update_prob))
    return ref_idx, deep


def train_forward(net: XMem, frames, first_frame_gt, selector, cls_gt,
                  ref_idx: List[Optional[torch.Tensor]], deep: List[bool],
                  it: int, start_warm: int, end_warm: int
                  ) -> Dict[str, torch.Tensor]:
    """One unrolled multi-frame pass (reference do_pass, trainer.py:56-117).

    frames [B, T, 3, H, W]; first_frame_gt [B, 1, O, H, W] (frame 0's
    objects, one-hot); selector [B, O] (1 for filled object slots); cls_gt
    [B, T, H, W] class indices. Returns the loss dict of compute_losses."""
    b, t = frames.shape[:2]
    num_objects = first_frame_gt.shape[2]
    # contiguous: frames may be a channels-last view of [B, T, H, W, 3]
    # data, and the trunk's batch norms take NCHW activations
    key, shrinkage, selection, f16, f8, f4 = net.encode_key(
        frames.flatten(0, 1).contiguous())

    def unflat(x):
        return x.reshape((b, t) + x.shape[1:])

    key, shrinkage, selection = unflat(key), unflat(shrinkage), \
        unflat(selection)
    f16, f8, f4 = unflat(f16), unflat(f8), unflat(f4)

    h16, w16 = key.shape[-2:]
    hidden = torch.zeros((b, num_objects, net.hidden_dim, h16, w16),
                         device=frames.device)
    v16, hidden = net.encode_value(frames[:, 0], f16[:, 0], hidden,
                                   first_frame_gt[:, 0])
    values = [v16]                          # per frame, [B, O, Cv, h, w]
    sel4 = selector[:, :, None, None]
    rows = torch.arange(b, device=frames.device)[:, None]
    logits_seq, masks_seq = [], []
    for ti in range(1, t):
        vals = torch.stack(values, dim=2)   # [B, O, ti, Cv, h, w]
        idx = ref_idx[ti - 1]
        if idx is None:
            ref_key, ref_shrinkage = key[:, :ti], shrinkage[:, :ti]
        else:
            idx = idx.to(frames.device)
            ref_key, ref_shrinkage = key[rows, idx], shrinkage[rows, idx]
            vals = vals.transpose(1, 2)[rows, idx].transpose(1, 2)
        readout = net.read_memory(key[:, ti], selection[:, ti], ref_key,
                                  ref_shrinkage, vals)
        h_out = ti < t - 1
        hidden_new, logits, masks = net.segment(
            (f16[:, ti], f8[:, ti], f4[:, ti]), readout, hidden, h_out=h_out,
            strip_bg=True, selector=sel4)
        if h_out:
            hidden = hidden_new
            v16, hidden_deep = net.encode_value(frames[:, ti], f16[:, ti],
                                                hidden, masks)
            # the deep update changes only the hidden state
            # (reference trainer.py:111-113)
            hidden = torch.where(torch.tensor(deep[ti - 1],
                                              device=frames.device),
                                 hidden_deep, hidden)
            values.append(v16)
        logits_seq.append(logits)
        masks_seq.append(masks)

    class_valid = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                        device=frames.device),
                             selector.bool()], dim=1)
    return compute_losses(logits_seq, masks_seq, cls_gt, class_valid, it,
                          start_warm, end_warm)


class TrainNet(nn.Module):
    """train_forward as a module's forward, so that DDP, which hooks
    forward, can wrap it. The XMem module is its `net`."""

    def __init__(self, net: XMem, start_warm: int, end_warm: int):
        super().__init__()
        self.net = net
        self.start_warm, self.end_warm = start_warm, end_warm

    def forward(self, frames, first_frame_gt, selector, cls_gt, ref_idx,
                deep, it):
        return train_forward(self.net, frames, first_frame_gt, selector,
                             cls_gt, ref_idx, deep, it, self.start_warm,
                             self.end_warm)


class XMemTrainer:
    """The reference XMemTrainer surface: do_pass, save_network,
    save_checkpoint, load_checkpoint, load_network_in_memory.

    sd, dims: a reference-layout state dict (numpy) and its dims, as
    models.init.init_params or bridge.torch_params.load_state_dict_file give
    them. config: the stage config (lr, weight_decay, steps, gamma,
    num_frames, num_ref_frames, deep_update_prob, start_warm, end_warm; amp,
    default on). Runs on CUDA unless `device` says otherwise; under an
    initialised process group on the card, on cuda:LOCAL_RANK.
    record_events: time every step's phases with CUDA events (step_events).
    """

    def __init__(self, config: dict, sd: Mapping[str, np.ndarray], dims: Dims,
                 logger=None, save_path: Optional[str] = None, device=None,
                 record_events: bool = False):
        self.config = config
        self.logger = logger
        self.save_path = save_path
        self.device = resolve_device(device)
        if self.device == torch.device('cuda') and 'LOCAL_RANK' in os.environ:
            self.device = torch.device('cuda', int(os.environ['LOCAL_RANK']))
        if self.device.index is not None:
            torch.cuda.set_device(self.device)
        pin_f32_precision()
        self.amp = bool(config.get('amp', True))
        self.model = build_train_model(sd, dims, self.device)
        self.net = TrainNet(self.model, config['start_warm'],
                            config['end_warm'])
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            self.net = nn.parallel.DistributedDataParallel(
                self.net, device_ids=[self.device.index]
                if self.device.type == 'cuda' else None,
                broadcast_buffers=False, gradient_as_bucket_view=True)
        self.optimizer = torch.optim.AdamW(
            [p for p in self.model.parameters() if p.requires_grad],
            lr=config['lr'], weight_decay=config['weight_decay'])
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, [int(s) for s in config.get('steps', [])],
            config.get('gamma', 0.1))
        self.it = 0                      # the loss schedule's step count
        self.log_text_interval = config.get('log_text_interval', 100)
        self.save_network_interval = config.get('save_network_interval',
                                                25000)
        self.save_checkpoint_interval = config.get('save_checkpoint_interval',
                                                   50000)
        self.record_events = record_events and self.device.type == 'cuda'
        self.step_events: List[Dict[str, torch.cuda.Event]] = []

    def _event(self, events: dict, name: str):
        if self.record_events:
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

    def _global_losses(self, losses: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The losses averaged over the ranks: one all_reduce(SUM) of them
        stacked, divided by the world size (gloo has no AVG)."""
        names = sorted(losses)
        stacked = torch.stack([losses[k].float().to(self.device)
                               for k in names])
        torch.distributed.all_reduce(stacked)
        stacked /= torch.distributed.get_world_size()
        return dict(zip(names, stacked))

    def do_pass(self, data: Dict[str, np.ndarray], it: int = 0,
                record: bool = False) -> Dict[str, torch.Tensor]:
        """One step on a batch of the datasets' channels-last arrays: 'rgb'
        [B, T, H, W, 3], 'first_frame_gt' [B, 1, O, H, W], 'selector'
        [B, O], 'cls_gt' [B, T, H, W]; pinned host tensors are copied
        without blocking. `it` seeds the step's draws and drives logging and
        saving; the loss schedule runs on the trainer's own count. Returns
        the losses (detached device tensors). Under DDP, on a log step or
        when the caller records the losses (`record`, the same on every
        rank), they are the ranks' average; else this rank's."""
        events: Dict[str, torch.cuda.Event] = {}
        self._event(events, 'start')
        dev = self.device

        def on_device(a):
            return torch.as_tensor(a).to(dev, non_blocking=True)

        frames = on_device(data['rgb']).permute(0, 1, 4, 2, 3)
        first_frame_gt = on_device(data['first_frame_gt'])
        selector = on_device(data['selector'])
        cls_gt = on_device(data['cls_gt']).long()
        gen = torch.Generator().manual_seed(int(it))
        ref_idx, deep = sample_draws(gen, frames.shape[0],
                                     self.config['num_frames'],
                                     self.config['num_ref_frames'],
                                     self.config['deep_update_prob'])
        self._event(events, 'data')
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            losses = self.net(frames, first_frame_gt, selector, cls_gt,
                              ref_idx, deep, self.it)
        self._event(events, 'forward')
        self.optimizer.zero_grad(set_to_none=True)
        losses['total_loss'].backward()
        self._event(events, 'backward')
        self.optimizer.step()
        self.scheduler.step()
        self._event(events, 'optimizer')
        self.it += 1
        if self.record_events:
            self.step_events.append(events)

        losses = {k: v.detach() for k, v in losses.items()}
        log_step = it % self.log_text_interval == 0
        if (log_step or record) and isinstance(
                self.net, nn.parallel.DistributedDataParallel):
            losses = self._global_losses(losses)
        if self.logger is not None and log_step:
            for k, v in losses.items():
                self.logger.log_scalar(f'train/{k}', float(v), it)
        if self.save_path is not None:
            if it % self.save_network_interval == 0 and it != 0:
                self.save_network(it)
            if it % self.save_checkpoint_interval == 0 and it != 0:
                self.save_checkpoint(it)
        return losses

    def network_state(self) -> Dict[str, np.ndarray]:
        """The weights as a reference-layout state dict on the host (the
        in-memory handoff to the next stage)."""
        return state_dict_numpy(self.model)

    # -- checkpointing (reference trainer.py:160-214) ----------------------
    def save_network(self, it: int):
        os.makedirs(os.path.dirname(self.save_path), exist_ok=True)
        path = f'{self.save_path}_{it}.pth'
        save_network(self.model, path)
        print(f'Network saved to {path}.')

    def save_checkpoint(self, it: int):
        os.makedirs(os.path.dirname(self.save_path), exist_ok=True)
        path = f'{self.save_path}_checkpoint_{it}.pth'
        torch.save({'it': it, 'network': self.model.state_dict(),
                    'optimizer': self.optimizer.state_dict(),
                    'scheduler': self.scheduler.state_dict()}, path)
        print(f'Checkpoint saved to {path}.')

    def load_checkpoint(self, path: str) -> int:
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt['network'])
        self.optimizer.load_state_dict(ckpt['optimizer'])
        self.scheduler.load_state_dict(ckpt['scheduler'])
        self.it = ckpt['it']
        print('Network weights, optimizer states, and iteration loaded.')
        return ckpt['it']

    def load_network_in_memory(self, sd: Mapping[str, np.ndarray]):
        """Weights of another stage, copied into this trainer's network; a
        single-object network's value conv1 gets a zero fifth channel when
        this network is multi-object (reference load_network_in_memory)."""
        if not self.model.single_object:
            sd, _ = convert_state_dict(sd)
        self.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                    for k, v in sd.items()})
        print('Network weight loaded from memory.')
