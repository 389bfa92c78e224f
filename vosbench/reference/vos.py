"""XMem++ semi-supervised video propagation in plain PyTorch, frame by
frame, float32: the benchmark's reference for the inference cells.

Written from the published algorithm (XMem, ECCV 2022; XMem++, ICCV 2023
workshops: github.com/mbzuai-metaverse/XMem2 inference/inference_core.py,
memory_manager.py, kv_memory_store.py, run_on_video.py) and its documented
defaults. It reads the same files as the program (JPEG frames, palette
annotations, the seeded checkpoint) and works out everything else again:
the frame schedule, every memory store, the hidden state, consolidation
and the written masks. Imports nothing of the program.

Departures from the published code, which the program shares: multi-group
long-term slots keep per-group validity, and permanent frames sit at their
true slots (the published code assumes aligned suffixes and computes one
slot short). Ties at the k-th similarity value, which the kernels resolve
by taking the whole tied set, do not occur with continuous keys; this file
takes torch.topk's k.
"""

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from vosbench.reference.net import (FlopCounter, Precision, XMemRef,
                                    aggregate, similarity)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LIFE_EPS = 1e-7


@dataclass
class ReadoutWork:
    """One readout: query rows, memory slots by store, objects, groups."""
    p: int
    n: int
    objects: int
    groups: int


@dataclass
class VideoRecord:
    """What the reference computed and counted for one video."""
    labels: List[np.ndarray] = field(default_factory=list)  # [H, W] uint8
    # the lead of the most probable class over the runner-up, [H, W] f16
    margins: List[np.ndarray] = field(default_factory=list)
    network_flops: float = 0.0
    readouts: List[ReadoutWork] = field(default_factory=list)
    consolidations: int = 0
    # the spread of the last readout's similarities, and the network (its
    # last_* features): what weights.calibrate reads
    sim_std: float = 0.0
    net: Optional[object] = None


# -- input preparation ----------------------------------------------------------

def shorter_side(h: int, w: int, size: int):
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size


def pad16(x: torch.Tensor):
    """Zero-pad [..., H, W] to multiples of 16, centred, the smaller half
    first. Returns (padded, (top, bottom, left, right))."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % 16, (-w) % 16
    pad = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    return F.pad(x, (pad[2], pad[3], pad[0], pad[1])), pad


def unpad(x: torch.Tensor, pad):
    h, w = x.shape[-2:]
    return x[..., pad[0]:h - pad[1], pad[2]:w - pad[3]]


def load_frame(path: str, size: int, device) -> torch.Tensor:
    """JPEG -> ImageNet-normalised [3, H, W], shorter side bilinearly
    resized to `size` (no antialiasing) when size > 0."""
    rgb = np.asarray(Image.open(path).convert('RGB'), np.uint8)
    x = torch.from_numpy(rgb.copy()).to(device).float() / 255.0
    x = ((x - torch.tensor(MEAN, device=device))
         / torch.tensor(STD, device=device)).permute(2, 0, 1)
    if size > 0:
        hw = shorter_side(x.shape[1], x.shape[2], size)
        if hw != tuple(x.shape[1:]):
            x = F.interpolate(x[None], size=hw, mode='bilinear',
                              align_corners=False)[0]
    return x


def resize_nearest(mask: np.ndarray, hw) -> np.ndarray:
    """F.interpolate(mode='nearest') over the last two axes."""
    h, w = mask.shape[-2:]
    if (h, w) == tuple(hw):
        return mask
    rows = np.floor(np.arange(hw[0]) * (h / hw[0])).astype(np.int64)
    cols = np.floor(np.arange(hw[1]) * (w / hw[1])).astype(np.int64)
    return mask[..., rows, :][..., cols]


class Labels:
    """Annotation label values -> consecutive object indices (exhaustive
    masks: every object present on a frame is drawn on it)."""

    def __init__(self):
        self.labels: List[int] = []
        self.index: Dict[int, int] = {}

    def onehot(self, mask: np.ndarray) -> np.ndarray:
        present = np.unique(mask)
        for l in sorted(int(v) for v in present if v != 0):
            if l not in self.index:
                self.labels.append(l)
                self.index[l] = len(self.labels)
        return np.stack([(mask == l) for l in self.labels]).astype(np.float32)

    def back(self, idx: np.ndarray) -> np.ndarray:
        out = np.zeros_like(idx)
        for l, i in self.index.items():
            out[idx == i] = l
        return out


# -- memory -------------------------------------------------------------------

class Store:
    """Slots of one memory store: keys [N, Ck], shrinkage [N], selection
    [N, Ck], values [O, N, Cv], validity [G, N], use and life counts [N]."""

    def __init__(self, ck, cv, device):
        z = dict(device=device)
        self.key = torch.zeros((0, ck), **z)
        self.shrink = torch.zeros((0,), **z)
        self.sel = torch.zeros((0, ck), **z)
        self.value = torch.zeros((0, 0, cv), **z)
        self.valid = torch.zeros((0, 0), dtype=torch.bool, **z)
        self.use = torch.zeros((0,), **z)
        self.life = torch.zeros((0,), **z)

    @property
    def n(self) -> int:
        return self.key.shape[0]

    def widen(self, objects: int, groups: int):
        """New objects and groups have no data in the existing slots."""
        o, n, cv = self.value.shape
        if objects > o:
            self.value = torch.cat([self.value, self.value.new_zeros(
                (objects - o, n, cv))])
        g = self.valid.shape[0]
        if groups > g:
            self.valid = torch.cat([self.valid, self.valid.new_zeros(
                (groups - g, n))])

    def append(self, key, shrink, sel, value, valid):
        self.key = torch.cat([self.key, key])
        self.shrink = torch.cat([self.shrink, shrink])
        self.sel = torch.cat([self.sel, sel if sel is not None
                              else torch.zeros_like(key)])
        self.value = torch.cat([self.value, value], dim=1)
        self.valid = torch.cat([self.valid, valid], dim=1)
        self.use = torch.cat([self.use, torch.zeros_like(shrink)])
        self.life = torch.cat([self.life, torch.full_like(shrink, LIFE_EPS)])

    def keep(self, mask: torch.Tensor):
        for name in ('key', 'shrink', 'sel', 'use', 'life'):
            setattr(self, name, getattr(self, name)[mask])
        self.value = self.value[:, mask]
        self.valid = self.valid[:, mask]


class Memory:
    def __init__(self, cfg: dict, ck: int, cv: int, hw: int, video_len: int,
                 device, prec: Precision):
        self.prec = prec
        self.top_k = cfg['top_k']
        self.long_term = cfg['enable_long_term']
        self.min_work = cfg['min_mid_term_frames'] * hw
        self.max_work = cfg['max_mid_term_frames'] * hw
        self.protos = cfg['num_prototypes']
        self.max_long = cfg['max_long_term_elements']
        # long-term usage is counted only on videos long enough to fill the
        # long-term memory (XMem2 run_on_video.py:190-196)
        self.count_long_usage = self.long_term and (
            video_len / (cfg['max_mid_term_frames']
                         - cfg['min_mid_term_frames'])
            * self.protos >= self.max_long)
        self.perm, self.work, self.long = (Store(ck, cv, device)
                                           for _ in range(3))
        self.groups: List[List[int]] = []
        self.objects = 0
        self.hidden: Optional[torch.Tensor] = None
        self.consolidations = 0

    def register(self, n_objects: int):
        """Objects beyond the known ones form a new group."""
        if n_objects > self.objects:
            self.groups.append(list(range(self.objects, n_objects)))
            self.objects = n_objects
        for s in (self.perm, self.work, self.long):
            s.widen(self.objects, len(self.groups))

    def group_of(self) -> List[int]:
        gid = [0] * self.objects
        for g, objs in enumerate(self.groups):
            for o in objs:
                gid[o] = g
        return gid

    def add(self, store: Store, key, shrink, sel, value):
        """key [hw, Ck]; value [O, hw, Cv]; every known group has data."""
        valid = torch.ones((len(self.groups), key.shape[0]), dtype=torch.bool,
                           device=key.device)
        store.append(key, shrink, sel if self.long_term else None,
                     self.prec.round(value), valid)
        if store is self.work and self.long_term \
                and self.work.n >= self.max_work:
            if self.long.n >= self.max_long - self.protos:
                self.evict(self.max_long - self.protos)
            self.consolidate()

    def evict(self, max_keep: int):
        """Drop the least used long-term slots beyond max_keep."""
        drop = self.long.n - max_keep
        if drop <= 0:
            return
        u = self.long.use / self.long.life
        self.long.keep(u > torch.sort(u).values[drop - 1])

    def consolidate(self):
        """The oldest working frames (all but min_mid_term_frames) become
        num_prototypes long-term prototypes: the most used slots, their
        values potentiated by a full softmax per group over the candidates."""
        w = self.work
        end = w.n - self.min_work
        u = (w.use / w.life).clone()
        u[end:] = -math.inf
        if u.numel() < self.protos:
            u = F.pad(u, (0, self.protos - u.numel()), value=-math.inf)
        top = torch.sort(u, descending=True, stable=True)
        idx = top.indices[:self.protos]
        ok = top.values[:self.protos] > -math.inf
        pk, ps = w.key[idx], w.sel[idx]
        sim = similarity(w.key[:end], w.shrink[:end], pk, ps)
        aff = [torch.softmax(torch.where(w.valid[g, :end][None], sim,
                                         torch.tensor(-math.inf,
                                                      device=sim.device)), -1)
               for g in range(len(self.groups))]
        gid = self.group_of()
        value = torch.stack([aff[gid[o]] @ w.value[o, :end]
                             for o in range(self.objects)])
        shrink = aff[0] @ w.shrink[:end]
        valid = w.valid[:, idx] & ok[None]
        self.long.append(pk, shrink, None, value, valid)
        w.keep(torch.arange(w.n, device=u.device) >= end)
        self.consolidations += 1

    def read(self, qk, qe, record: VideoRecord):
        """qk / qe [P, Ck] -> readout [O, P, Cv]: per group the softmax of
        the top_k similarities over every valid slot of [long | work |
        perm]; group 0's weights count as usage of the working (and, on long
        videos, long-term) slots."""
        stores = [s for s in (self.long, self.work, self.perm) if s.n > 0]
        key = torch.cat([s.key for s in stores])
        shrink = torch.cat([s.shrink for s in stores])
        value = torch.cat([s.value for s in stores], dim=1)
        valid = torch.cat([s.valid for s in stores], dim=1)
        with self.prec.similarity():
            sim = similarity(key, shrink, qk, qe)
        record.sim_std = float(sim.std())
        k = min(self.top_k, key.shape[0])
        out = torch.zeros((self.objects, qk.shape[0], value.shape[2]),
                          device=qk.device)
        usage = None
        for g, objs in enumerate(self.groups):
            s = torch.where(valid[g][None], sim,
                            torch.tensor(-math.inf, device=sim.device))
            vals, idx = torch.topk(s, k, dim=-1)
            wts = torch.softmax(vals, dim=-1)
            for o in objs:
                out[o] = (wts[..., None] * value[o][idx]).sum(1)
            if g == 0:
                usage = torch.zeros(key.shape[0], device=qk.device) \
                    .index_add_(0, idx.flatten(), wts.flatten())
        at = 0
        for s in stores:
            if s is self.work or (s is self.long and self.count_long_usage):
                s.use += usage[at:at + s.n]
                s.life += 1
            at += s.n
        record.readouts.append(ReadoutWork(qk.shape[0], key.shape[0],
                                           self.objects, len(self.groups)))
        return out


# -- the propagation loop ------------------------------------------------------

def run_video(frames_dir: str, ann_dir: str, ckpt, cfg: dict, device,
              precision: str = 'f32', frames: Optional[int] = None
              ) -> VideoRecord:
    """Masks of every frame, as label values [H, W] uint8, with the work
    counts. ckpt: a .pth path or a state dict. cfg: the inference keys
    (top_k, mem_every, the memory sizes, size) of the configuration.
    frames: stop after this many frames (the video keeps its length for
    the schedule)."""
    if cfg['deep_update_every'] >= 0:
        raise ValueError('the reference runs deep updates on memory frames '
                         '(deep_update_every < 0) only')
    record = VideoRecord()
    counter = FlopCounter()
    sd = ckpt if isinstance(ckpt, dict) else torch.load(
        ckpt, map_location='cpu', weights_only=True)
    net = XMemRef(sd, device, Precision(precision, counter))
    names = sorted(os.listdir(frames_dir))
    anns = {f[:-4] for f in os.listdir(ann_dir) if f.endswith('.png')}
    annotated = [t for t, f in enumerate(names) if f[:-4] in anns]
    size = cfg['size']
    labels = Labels()
    mem: Optional[Memory] = None
    mem_every = cfg['mem_every']

    def mask_of(t):
        m = np.asarray(Image.open(os.path.join(
            ann_dir, names[t][:-4] + '.png')).convert('P'), np.uint8)
        onehot = labels.onehot(m)
        if size > 0:
            onehot = resize_nearest(onehot, shorter_side(*m.shape, size))
        return torch.from_numpy(np.ascontiguousarray(onehot)).to(device)

    def frame(t):
        return pad16(load_frame(os.path.join(frames_dir, names[t]), size,
                                device))

    def new_memory(key):
        h, w = key.shape[-2:]
        return Memory(cfg, key.shape[1], net.sd[
            'value_encoder.fuser.block2.conv2.weight'].shape[0], h * w,
            len(names), device, net.p)

    def ensure_hidden(m: Memory, n, key):
        h, w = key.shape[-2:]
        shape = (1, n, net.hidden_dim, h, w)
        if m.hidden is None:
            m.hidden = torch.zeros(shape, device=device)
        elif m.hidden.shape[1] < n:
            m.hidden = torch.cat([m.hidden, torch.zeros(
                (1, n - m.hidden.shape[1]) + shape[2:], device=device)], 1)

    def flat(key, shrink, sel, value):
        return (key[0].flatten(1).T, shrink.reshape(-1),
                sel[0].flatten(1).T, value[0].flatten(2).transpose(1, 2))

    with torch.no_grad():
        # annotated frames into permanent memory, in order
        for t in annotated:
            x, pad = frame(t)
            onehot = mask_of(t)
            key, shrink, sel, f16, _, _ = net.encode_key(x[None])
            if mem is None:
                mem = new_memory(key)
            mask, _ = pad16(onehot)
            prob = aggregate(mask, dim=0)
            n = len(labels.labels)
            ensure_hidden(mem, n, key)
            value, _ = net.encode_value(x[None], f16, mem.hidden,
                                        prob[1:][None], deep_update=False)
            mem.register(n)
            k, s, e, v = flat(key, shrink, sel, value)
            mem.add(mem.perm, k, s, e, v)
        if mem is None:
            raise ValueError('no annotated frame')

        last_mem = 0
        for t in range(len(names) if frames is None else frames):
            end = t == len(names) - 1
            given = t in annotated
            x, pad = frame(t)
            key, shrink, sel, f16, f8, f4 = net.encode_key(x[None])
            is_mem = (t - last_mem >= mem_every or given) and not end
            deep = is_mem
            normal = not deep and not end
            if given:
                # exhaustive annotations name every object known so far:
                # nothing to segment
                onehot = mask_of(t)
                mask, _ = pad16(onehot)
                prob = aggregate(mask, dim=0)
                ensure_hidden(mem, len(labels.labels), key)
            else:
                qk, qe = key[0].flatten(1).T, sel[0].flatten(1).T
                h, w = key.shape[-2:]
                out = mem.read(qk, qe, record)
                readout = out.reshape(mem.objects, h, w, -1) \
                    .permute(0, 3, 1, 2)[None]
                hidden, prob = net.segment((f16, f8, f4), readout, mem.hidden,
                                           h_out=normal)
                prob = prob[0]
                if normal:
                    mem.hidden = hidden
            if is_mem:
                value, hidden = net.encode_value(x[None], f16, mem.hidden,
                                                 prob[1:][None],
                                                 deep_update=deep)
                mem.register(len(labels.labels))
                if not given:
                    k, s, e, v = flat(key, shrink, sel, value)
                    mem.add(mem.work, k, s, e, v)
                last_mem = t
                mem.hidden = hidden
            prob = unpad(prob, pad)
            out_hw = _source_hw(os.path.join(frames_dir, names[t]))
            if tuple(prob.shape[-2:]) != out_hw:
                prob = F.interpolate(prob[None], size=out_hw, mode='bilinear',
                                     align_corners=False)[0]
            top2 = torch.topk(prob, 2, dim=0).values
            idx = torch.argmax(prob, dim=0).to(torch.uint8).cpu().numpy()
            record.labels.append(labels.back(idx))
            record.margins.append((top2[0] - top2[1]).half().cpu().numpy())
    record.network_flops = counter.flops
    record.consolidations = mem.consolidations
    record.net = net
    return record


def _source_hw(path: str):
    with Image.open(path) as im:
        return im.height, im.width
