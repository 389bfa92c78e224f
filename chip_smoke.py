"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this repository's
`xmem2_tpu_torch` package; imports nothing of JAX. Phases, each of which
fails the run when it fails:

  1. card:    the card's name and power limit, torch and CUDA versions;
  2. build:   nvcc builds every kernel of xmem2_tpu_torch/ops/csrc/ (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card, at
              the main path's shapes (P = 1620 and 9 * 1620 query rows, three
              memory segments of ~34k slots with ragged tails, Cv = 512,
              k = 30, two objects in two groups, duplicated keys for ties),
              and at P = 1620 with the 38,880-slot permanent segment of
              augmented preloading: K2's values, k-th-value counts, merge
              and the softmax stats bit-equal, K1 within tolerance, also in
              the overflow cases (a segment smaller than k, top_k = 300, a
              key repeated 3,000 times); each timed with CUDA events beside
              its plain version, a PyTorch yardstick where one call computes
              the same function, and its bound on this card; the same at
              two many-object shapes (P = 1620, the three segments, 12
              objects in 10 groups and 70 objects in 3 groups: past the 8
              groups and 64 objects a CTA handles), with the whole readout
              call against the plain orchestration and the sharded readout
              (2 shards) against the unsharded one; 136 objects each in
              a group of its own (two K1 launches: past one launch's chunk
              table); then `match ms`, one
              whole fused_topk_readout_multi call (three segments, usage
              on); and the batch-norm epilogue (BN, + residual, + ReLU) at
              the trunks' shapes for a chunk of nine 480x864 frames, bf16
              and f32: torch.equal to its plain version, ms, plain ms,
              F.batch_norm's ms where the case is a batch norm alone, and
              its bound;
  4. main:    `run_on_video` of the port on the card, at the published XMem
              widths with seeded synthetic weights, on a synthetic 854x480
              video of 120 frames with two objects annotated on frames 0 and
              60: once in the default mode (bf16, chunked) and once with
              --exact (f32). Every mask must be written, no probability NaN,
              and every kernel's launch count (the batch-norm epilogue's
              too) must rise during the run; then a profiler window over a
              default run;
  5. augment: the default run with augment_images_with_masks (24 frames in
              permanent memory), launch counts, and a profiler window;
  6. select:  select_k_next_best_annotation_candidates (k = 5) from the
              default run's masks: five distinct frames, none of them 0,
              finite dissimilarities;
  7. spill:   a run with spill_long_term whose long-term memory evicts
              (beside the same settings without spill), then the cap raised
              through InferenceCore.update_config: rows archived and
              revived, the next step finite;
  8. eval:    python -m xmem2_tpu_torch.eval on two 854x480 videos of 30
              frames, with --benchmark and with --save_scores;
  9. merge:   python -m xmem2_tpu_torch.merge_multi_scale over the eval
              phase's --save_scores tree and an --exact --save_scores run
              of the same videos: a palette PNG per frame, the zip;
 10. shard:   memory sharding: the merge K2 at the gathered shape
              [G, P, D*S*k] bit-equal to its plain version and the sharded
              readout against the unsharded one (D = 4 shards of three
              segments); then run_on_video on 60 frames at 854x480 with two
              objects, unsharded (chunked, and frame by frame: the path a
              sharded memory takes) and with memory_shards 2 and 4 placed on
              this card (shard_devices), in bf16 and f32: masks against the
              frame-by-frame unsharded run (0.01% of pixels in f32, 0.1% in
              bf16), K1, K2 and usage launched, K2 launches growing with D,
              frames/s and peak memory; over real cards when more than one
              is visible;
 11. many:    run_on_video on synthetic 854x480 video with many objects,
              each annotated frame bringing new ones (a new object group):
              12 objects in 10 groups over 60 frames, default and --exact,
              and 70 objects in 3 groups over 20 frames, default. Every
              mask written, nothing non-finite, the group count, K1, K2 and
              usage launched; frames/s, peak memory and launches per
              readout call;
 12. check:   the port on the card against the port on the CPU (plain
              versions of every kernel) on a small f32 video: masks equal,
              also with augmentation; the same candidates chosen; spill
              archives of the same size; and a 24-frame 96x160 video with
              12 objects in 10 groups: masks equal on >= 99.99% of pixels;
 13. train:   the stage-2 loader timed alone (worker processes, 1 and 8,
              beside as many threads reading the same samples; two runs of
              one seed byte-equal), then
              python -m xmem2_tpu_torch.train on synthetic 854x480 data in
              the reference layouts: stage 0 (batch 8, 3 frames, single
              object) in a plain process, then stage 2 (batch 8, 8 frames,
              3 reference frames, 384 crops, bf16 autocast) for 16 steps
              under torchrun with one process (DDP over NCCL); every loss
              finite; steps/s, samples/s and the step's phases by CUDA
              events over the steady steps, the data wait of every step,
              peak memory, a profiler window of 3 steps by kernel group and
              the device's busy share;
 14. train-check: one float32 training step (TF32 off) on the card and on
              the CPU, same weights and batch: loss within 1e-5 relative,
              every gradient leaf within 1e-3 of its largest entry;
 15. syncbn:  batch_norm_train over a one-process NCCL group on the card
              against the CPU without a group, forward and backward within
              1e-5 of each output's scale;
 16. interactive: a user's session through SessionController (bf16, the
              demo's default) on a workspace that python -m
              xmem2_tpu_torch.import_existing and ResourceManager build from
              60 synthetic 854x480 frames with two objects, with seeded S2M
              and f-BRS checkpoints at the published widths: a scribble per
              object (S2M), three f-BRS-B clicks and an undo, a brush
              stroke, a reference, propagation forward, full propagation,
              candidates (every frame admitted: min_mask_presence_percent
              0), a live config change and the memory gauges; ms per
              scribble and click, L-BFGS evaluations a click, frames/s,
              launch counts, peak memory and a profile of one click;
 17. interactive-check: the same session in float32 on a 24-frame 96x160
              workspace on the card and on the CPU: S2M probabilities within
              1e-3, one f-BRS forward within 1e-4 of its largest logit,
              f-BRS masks after L-BFGS equal on >= 99% of pixels,
              propagated masks on >= 99.9%, the same candidates; then two
              clicks with each of the six predictor modes on both f-BRS
              backbones (ResNet-50 DeepLabV3+ and HRNet-18+OCR at its
              default widths; at most 4 L-BFGS evaluations a click): masks
              within 1% of pixels, the same L-BFGS evaluation counts.

The second-to-last line of output is the kernels JSON line (each kernel at
the main path's shape, then at the many-object shapes, named with them);
the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --match-from DIR

times only `match ms` of the port checked out under DIR (for instance a
parent commit unpacked with `git archive`), on the same inputs.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12              # HBM3, H100 SXM data sheet
H100_FLOPS = {'float32': 67e12,         # f32 outside the tensor cores
              'bfloat16': 989e12}       # dense bf16 tensor cores
KERNEL_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2: card and build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f'nvidia-smi failed: {out.stderr}')
    return out.stdout.strip().splitlines()[0]


def build_phase():
    from xmem2_tpu_torch.ops import cuda_build
    names = sorted(p.stem for p in cuda_build.CSRC.glob('*.cu'))
    t0 = time.perf_counter()
    seconds = cuda_build.build(names)
    log(f'[build] {names} in {time.perf_counter() - t0:.2f} s '
        f'(per file: {seconds})')
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                log(f'[build] {name}: {line.strip()}')
    for name in names:
        cuda_build.library(name)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int) -> float:
    """Milliseconds a call: CUDA events around `reps` calls issued back to
    back, after a warm-up call. The host's cost of a call hides behind the
    device's work unless it is larger (then it is what is measured)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device milliseconds a call: `reps` calls captured in one CUDA graph
    and replayed between CUDA events, so the host's cost of a call (which
    _time_ms measures where it exceeds the device's work) is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _segments(dev, p, seg_ns=(10128, 17820, 6480), ck=64, cv=512, o=2, g=2,
              seed=0):
    """[long | temp | perm] segments at the main path's widths. perm repeats
    the first slots of temp bit for bit (all of them when it is the larger),
    so the k-th value ties across segments (the duplicated-memory
    regime). Group gi > 0 lacks the oldest gi / (3 (g - 1)) of each
    segment's slots."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    qk = randn(p, ck)
    qe = torch.sigmoid(randn(p, ck))
    segs = []
    for i, n in enumerate(seg_ns):
        mk = randn(n, ck)
        ms = randn(n) ** 2 + 1
        values = randn(o, n, cv)
        valid = torch.ones((g, n), dtype=torch.bool, device=dev)
        for gi in range(1, g):             # later groups lack old slots
            valid[gi, :n * gi // (3 * (g - 1))] = False
        segs.append([mk, ms, values, valid])
    long_, temp, perm = segs
    temp[3][:, -37:] = False               # invalid ragged tail
    m = min(perm[0].shape[0], temp[0].shape[0])
    perm[0][:m] = temp[0][:m]
    perm[1][:m] = temp[1][:m]
    perm[2][:, :m] = temp[2][:, :m]
    return qk, qe, [tuple(s) for s in segs]


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def _same(a, b) -> bool:
    """Equal values, NaN where NaN (a group with no valid slot has NaN 1/Z
    in both versions; its weights are all gated to 0)."""
    import torch
    return a.shape == b.shape and bool(
        torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def _check_k2(RK, sims, valids, k, tag):
    """K2 per segment and its cross-segment merge, and the stats they give,
    bit-equal to the plain versions. Returns the stats."""
    import torch
    seg_vals = []
    for sim, valid in zip(sims, valids):
        got = RK.block_topk_candidates(sim, valid, k)
        want = RK.block_topk_candidates_plain(sim, valid, k)
        for name, a, b in zip(('values', 'k-th counts'), got, want):
            if not torch.equal(a, b):
                raise AssertionError(
                    f'K2 {name} differ in {(a != b).sum().item()} entries '
                    f'({tag}, N={sim.shape[1]})')
        seg_vals.append(got[0])
    if len(seg_vals) > 1:
        merged = torch.cat(seg_vals, dim=-1)
        got = RK.block_topk_candidates(merged, None, k)
        want = RK.block_topk_candidates_plain(merged, None, k)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f'K2 merge differs from plain ({tag})')
    stats = RK._topk_stats_fused(sims, valids, k)
    stats_plain = RK._topk_stats_fused(
        sims, valids, k, candidates=RK.block_topk_candidates_plain)
    for name, a, b in zip(('tau', 'rmax', 'invz'), stats, stats_plain):
        if not _same(a, b):
            raise AssertionError(f'K2 stats {name} differ ({tag})')
    return stats


def _check_k1(RK, sims, segs, stats, gids, err):
    """K1 readout (f32 and bf16 values) against its plain version per
    segment; max abs errors into err."""
    import torch
    tau, rmax, invz = stats
    for sim, (_, _, values, valid) in zip(sims, segs):
        for vdt in (torch.float32, torch.bfloat16):
            v = values.to(vdt)
            got = RK.topk_readout(sim, v, valid, tau, rmax, invz, gids)
            want = RK.topk_readout_plain(sim, v, valid, tau, rmax, invz,
                                         gids)
            key = f'topk_readout_{str(vdt)[6:]}'
            err[key] = max(err[key], (got - want).abs().max().item())


def _overflow_cases(RK, qk, qe, sims, segs, gids, err):
    """K1's flush path and under-full groups, which no CPU test reaches:
    a segment smaller than k (tau = -inf, every valid slot counts), the
    sort path (top_k = 300), K2 at k = 64 (its path for k > 32), and a
    segment whose first 3,000 keys are one key repeated, so every row of
    group 0 has 3,000 slots tied at its k-th value (more than a list holds:
    the kernel flushes and scans on)."""
    import torch
    from xmem2_tpu_torch.ops.similarity import get_similarity_padded
    p = qk.shape[0]
    mk, ms, values, valid = segs[1]
    sim20 = sims[1][:, :20].contiguous()
    seg20 = (None, None, values[:, :20].contiguous(),
             valid[:, :20].contiguous())
    st = _check_k2(RK, [sim20], [seg20[3]], 30, f'P={p} N=20')
    if not bool(torch.isinf(st[0]).all()):
        raise AssertionError('N=20 < k: tau should be -inf')
    _check_k1(RK, [sim20], [seg20], st, gids, err)

    st = RK._topk_stats_fused([sims[1]], [valid], 300)
    _check_k1(RK, [sims[1]], [segs[1]], st, gids, err)
    # 32 < k <= 256: K2's shared-buffer path (the main path's k uses the
    # register path)
    _check_k2(RK, sims, [s[3] for s in segs], 64, f'P={p} k=64')

    # sim <= 0 (a scaled negative distance), so a tiny shrinkage puts the
    # repeated key on top of every row
    mk_rep = mk.clone()
    mk_rep[:3000] = mk[0]
    ms_rep = ms.clone()
    ms_rep[:3000] = 1e-6
    sim_rep = get_similarity_padded(mk_rep, ms_rep, qk, qe, p, mk.shape[0])
    st = _check_k2(RK, [sim_rep], [valid], 30, f'P={p} repeated keys')
    hits = int(((sim_rep >= st[0][:, :1]) & valid[0]).sum(1).min())
    if hits < 3000:
        raise AssertionError(f'repeated keys: only {hits} hits in a row')
    _check_k1(RK, [sim_rep], [(mk_rep, ms_rep, values, valid)], st, gids,
              err)
    log(f'[kernels] P={p}: overflow cases (N=20, top_k=300, repeated keys '
        f'with >= {hits} hits a row) and K2 at k=64 agree with plain')


def match_phase(ps=(1620, 9 * 1620)):
    """match ms: the whole readout of one match call, in bf16 (default mode)
    and f32 (--exact) values. Works on any commit of the port that has
    fused_topk_readout_multi, so the same inputs time a parent commit."""
    import torch
    from xmem2_tpu_torch.ops import readout_kernel as RK
    dev = torch.device('cuda')
    out = {}
    for p in ps:
        qk, qe, segs = _segments(dev, p)
        for vdt in (torch.bfloat16, torch.float32):
            sv = [(mk, ms, v.to(vdt), va) for mk, ms, v, va in segs]
            out[(p, str(vdt)[6:])] = _time_ms(
                lambda: RK.fused_topk_readout_multi(sv, qk, qe, (0, 1), 30),
                10 if p == 1620 else 4)
        log(f'[match] P={p}, three segments (10128 / 17820 / 6480 slots), '
            f'usage on: match ms bf16 {out[(p, "bfloat16")]:.4f}, f32 '
            f'{out[(p, "float32")]:.4f}')
        del segs
        torch.cuda.empty_cache()
    return out


def many_group_ids(sizes) -> tuple:
    """Group ids of objects that annotated frames bring in blocks of these
    sizes, each block a new group."""
    return tuple(gi for gi, n in enumerate(sizes) for _ in range(n))


# 12 objects in 10 groups (objects 1-3 on the first annotated frame, one
# more on each of nine later ones) and 70 objects in 3 groups: past the 8
# groups and the 64 objects one CTA of a readout kernel handles
MANY_12_10 = (3,) + (1,) * 9
MANY_70_3 = (30, 25, 15)

# (label, query rows, [long, temp, perm] slots, the segment timed, group id
# of each object): the default config's store capacities at the per-frame
# and the chunk shape, the permanent segment of augmented preloading (two
# annotated frames, each with 11 augmentations: 24 frames of 1,620 slots),
# and the per-frame shape with many objects
KERNEL_CASES = (
    ('P=1620', 1620, (10128, 17820, 6480), 1, (0, 1)),
    ('P=14580', 9 * 1620, (10128, 17820, 6480), 1, (0, 1)),
    ('P=1620 augmented', 1620, (10128, 17820, 38880), 2, (0, 1)),
    ('P=1620 O=12 G=10', 1620, (10128, 17820, 6480), 1,
     many_group_ids(MANY_12_10)),
    ('P=1620 O=70 G=3', 1620, (10128, 17820, 6480), 1,
     many_group_ids(MANY_70_3)))


def _many_calls(RK, qk, qe, segs, gids, label):
    """At a many-object shape: the whole readout call (three segments, usage
    on) against the same orchestration over the plain versions, and the
    sharded readout (the segments in 2 shards on this card) against the
    unsharded one, both f32 values within KERNEL_TOL; the whole call timed
    in bf16 and f32 (match ms), with K1, K2 and usage launches a call."""
    import torch
    from xmem2_tpu_torch.ops.similarity import get_similarity_padded
    from xmem2_tpu_torch.parallel import sharded_readout as SR
    from xmem2_tpu_torch.utils.profiling import reset_counters

    k, p = 30, qk.shape[0]
    out, usages = RK.fused_topk_readout_multi(segs, qk, qe, gids, k)
    sims = [get_similarity_padded(mk, ms, qk, qe, p, mk.shape[0])
            for mk, ms, _, _ in segs]
    valids = [s[3] for s in segs]
    stats = RK._topk_stats_fused(
        sims, valids, k, candidates=RK.block_topk_candidates_plain)
    ref = sum(RK.topk_readout_plain(sim, v, va, *stats, gids)
              for sim, (_, _, v, va) in zip(sims, segs))
    err = (out - ref).abs().max().item()
    use_err = max(((u - RK.topk_usage_plain(sim, va, *stats)).abs()
                   / RK.topk_usage_plain(sim, va, *stats).abs().clamp_min(
                       1e-3)).max().item()
                  for u, sim, va in zip(usages, sims, valids))
    del ref, sims
    sharded = [list(zip(*SR.shard_memory_bank(*seg, [qk.device] * 2)))
               for seg in segs]
    out_sh, _ = SR.sharded_topk_readout_multi(sharded, qk, qe, gids, k)
    err_sh = (out_sh - out).abs().max().item()
    del sharded, out_sh
    reset_counters()
    RK.fused_topk_readout_multi(segs, qk, qe, gids, k)
    per_call = _kernel_launches()
    times = {}
    for vdt in (torch.bfloat16, torch.float32):
        sv = [(mk, ms, v.to(vdt), va) for mk, ms, v, va in segs]
        times[str(vdt)[6:]] = _time_ms(
            lambda: RK.fused_topk_readout_multi(sv, qk, qe, gids, k), 5)
        del sv
    log(f'[kernels] {label}: whole readout call vs the plain orchestration '
        f'max abs err {err:.3e}, usage max rel err {use_err:.3e}; sharded '
        f'(2 shards on this card) vs unsharded {err_sh:.3e} (tol '
        f'{KERNEL_TOL["float32"]}); match ms bf16 {times["bfloat16"]:.4f}, '
        f'f32 {times["float32"]:.4f}; launches a call {per_call}')
    if max(err, err_sh) > KERNEL_TOL['float32'] or use_err > 1e-4:
        raise AssertionError(f'{label}: the whole readout call disagrees')


def _wide_case(RK):
    """Past one K1 launch's chunk table: 136 objects, each in a group of its
    own (17 chunks of 8 groups: two K1 launches, K2 in 17 group chunks of
    8), P = 1620, N = 2000, Cv = 64. K2 bit-equal, K1 within KERNEL_TOL of
    the plain versions."""
    import torch
    from xmem2_tpu_torch.ops.similarity import get_similarity_padded
    from xmem2_tpu_torch.utils.profiling import reset_counters

    p, n, o, k = 1620, 2000, 136, 30
    gen = torch.Generator(device='cuda').manual_seed(7)
    mk, qk = (torch.randn(m, 64, generator=gen, device='cuda')
              for m in (n, p))
    ms = torch.randn(n, generator=gen, device='cuda') ** 2 + 1
    values = torch.randn(o, n, 64, generator=gen, device='cuda')
    valid = torch.rand(o, n, generator=gen, device='cuda') > 0.2
    sim = get_similarity_padded(mk, ms, qk, None, p, n)
    got = RK.block_topk_candidates(sim, valid, k)
    want = RK.block_topk_candidates_plain(sim, valid, k)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError('K2 at 136 groups differs from plain')
    stats = RK._topk_stats_fused([sim], [valid], k)
    gids = tuple(range(o))
    reset_counters()
    out = RK.topk_readout(sim, values, valid, *stats, gids)
    launches = _kernel_launches()['topk_readout']
    err = (out - RK.topk_readout_plain(sim, values, valid, *stats, gids)
           ).abs().max().item()
    log(f'[kernels] 136 objects in 136 groups (P={p}, N={n}, Cv=64): K2 '
        f'bit-equal to plain; K1 in {launches} launches, max abs err '
        f'{err:.3e} (tol {KERNEL_TOL["float32"]})')
    if launches != 2 or err > KERNEL_TOL['float32']:
        raise AssertionError('K1 past one chunk table disagrees')


# the trunks' batch norms at 480p (480x864 after padding), a chunk of nine
# frames: (label, channels, plane, residual, relu)
BN_CASES = (
    ('stem', 64, (240, 432), False, True),
    ('res2 bn1', 64, (120, 216), False, True),
    ('res2 downsample', 256, (120, 216), False, False),
    ('res2 bn3 + residual', 256, (120, 216), True, True),
    ('layer2 bn2', 128, (60, 108), False, True),
    ('layer2 bn3 + residual', 512, (60, 108), True, True),
    ('layer3 bn2', 256, (30, 54), False, True),
    ('layer3 bn3 + residual', 1024, (30, 54), True, True))


def bn_epilogue_phase(batch: int = 9):
    """The batch-norm epilogue (ops/csrc/bn_epilogue.cu) at the trunks'
    shapes in bf16 and f32: torch.equal to its plain version, then the
    device ms a call (_graph_ms) beside the plain version's, F.batch_norm's
    (training=False) where the case is a batch norm alone, and the bound
    (input, residual and output bytes over 3.35 TB/s), and the wrapper's
    ms a call with its host work (_time_ms). Returns the bf16 row of the
    res2 downsample, a batch norm alone, for the kernels line."""
    import torch
    import torch.nn.functional as F
    from xmem2_tpu_torch.ops.bn_epilogue import bn_epilogue, bn_epilogue_plain

    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, c, hw, residual, relu in BN_CASES:
            shape = (batch, c) + hw
            x = (3 * torch.randn(shape, generator=gen, device='cuda')
                 ).to(dtype)
            res = torch.randn(shape, generator=gen, device='cuda').to(dtype) \
                if residual else None
            vecs = (1 + 0.5 * torch.randn(c, generator=gen, device='cuda'),
                    0.3 * torch.randn(c, generator=gen, device='cuda'),
                    0.3 * torch.randn(c, generator=gen, device='cuda'),
                    0.01 + torch.randn(c, generator=gen, device='cuda').abs())
            same = torch.equal(bn_epilogue(x, *vecs, res, relu),
                               bn_epilogue_plain(x, *vecs, res, relu))
            nbytes = x.numel() * x.element_size() * (3 if residual else 2)
            flops = x.numel() * (3.0 if residual else 2.0)
            w, b, m, v = vecs
            library_ms = None if residual or relu else _graph_ms(
                lambda: F.batch_norm(x, m, v, w, b, training=False,
                                     eps=1e-5), 10)
            r = dict(ms=_graph_ms(lambda: bn_epilogue(x, *vecs, res, relu),
                                  10),
                     plain_ms=_graph_ms(
                         lambda: bn_epilogue_plain(x, *vecs, res, relu), 10),
                     bound=_bound_ms(nbytes, flops, 'float32'),
                     library_ms=library_ms, max_abs_err=0.0,
                     shape=f'{label} {list(shape)} {str(dtype)[6:]}',
                     timing='CUDA-graph replay')
            call_ms = _time_ms(lambda: bn_epilogue(x, *vecs, res, relu), 20)
            plain_call_ms = _time_ms(
                lambda: bn_epilogue_plain(x, *vecs, res, relu), 20)
            rows[label, str(dtype)[6:]] = r
            log(f'[bn] {label} {list(shape)} {str(dtype)[6:]}: '
                f'{r["ms"]:.4f} ms, bound {r["bound"][0]:.4f} ms '
                f'({r["bound"][1]}), plain {r["plain_ms"]:.4f} ms, '
                f'F.batch_norm {library_ms}, '
                f'torch.equal {same}; a call with its host work '
                f'{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms')
            if not same:
                raise AssertionError(f'bn_epilogue {label} {dtype} differs '
                                     f'from its plain version')
            del x, res
    return rows['res2 downsample', 'bfloat16']


def kernel_phase():
    import torch
    from xmem2_tpu_torch.ops import readout_kernel as RK
    from xmem2_tpu_torch.ops.similarity import get_similarity_padded

    dev = torch.device('cuda')
    k = 30
    rows = {}
    for label, p, seg_ns, timed, gids in KERNEL_CASES:
        qk, qe, segs = _segments(dev, p, seg_ns, o=len(gids), g=max(gids) + 1)
        sims = [get_similarity_padded(mk, ms, qk, qe, p, mk.shape[0])
                for mk, ms, _, _ in segs]
        valids = [s[3] for s in segs]

        # K2: values, k-th counts, merge and stats bit-equal to plain
        stats = _check_k2(RK, sims, valids, k, label)
        tau, rmax, invz = stats
        n_ties = sum(int(((s == tau[:, :1]) & v[0]).sum()) for s, v in
                     zip(sims, valids)) - p
        log(f'[kernels] {label}, segments {seg_ns}: K2 values, k-th counts, '
            f'merge and stats bit-equal to plain; {n_ties} slots beyond one '
            f'per row sit on the k-th value')

        # K1: readout (f32 and bf16 values) and usage, per segment
        err = {'topk_readout_float32': 0.0, 'topk_readout_bfloat16': 0.0,
               'topk_usage': 0.0}
        _check_k1(RK, sims, segs, stats, gids, err)
        for sim, (_, _, _, valid) in zip(sims, segs):
            got = RK.topk_usage(sim, valid, tau, rmax, invz)
            want = RK.topk_usage_plain(sim, valid, tau, rmax, invz)
            rel = ((got - want).abs() / want.abs().clamp_min(1e-3)).max()
            err['topk_usage'] = max(err['topk_usage'], rel.item())
        # the overflow cases need no second run of the two-object shape, nor
        # a third of the 70 objects' values
        if seg_ns[2] < seg_ns[1] and len(gids) <= 12:
            _overflow_cases(RK, qk, qe, sims, segs, gids, err)
        log(f'[kernels] {label}: max abs err readout f32 '
            f'{err["topk_readout_float32"]:.3e} (tol {KERNEL_TOL["float32"]}), '
            f'bf16 {err["topk_readout_bfloat16"]:.3e} '
            f'(tol {KERNEL_TOL["bfloat16"]}); usage max rel err '
            f'{err["topk_usage"]:.3e} (tol 1e-4)')
        if err['topk_readout_float32'] > KERNEL_TOL['float32']:
            raise AssertionError('K1 f32 readout outside tolerance')
        if err['topk_readout_bfloat16'] > KERNEL_TOL['bfloat16']:
            raise AssertionError('K1 bf16 readout outside tolerance')
        if err['topk_usage'] > 1e-4:
            raise AssertionError('K1 usage outside tolerance')

        # timings at one segment, one wrapper call
        sim, (_, _, values, valid) = sims[timed], segs[timed]
        n = sim.shape[1]
        reps = 10 if p == 1620 else 3
        g = valid.shape[0]
        # K2 reads the similarity and validity once and writes k values and
        # one count per (group, row); its yardstick is torch.topk over each
        # group's masked row
        k2_bytes = sim.numel() * 4 + valid.numel() + g * p * (k + 1) * 4
        masked = torch.where(valid[:, None, :], sim[None], -math.inf)
        rows[('block_topk_candidates', label)] = dict(
            ms=_time_ms(lambda: RK.block_topk_candidates(sim, valid, k), reps),
            plain_ms=_time_ms(
                lambda: RK.block_topk_candidates_plain(sim, valid, k), reps),
            library_ms=_time_ms(lambda: torch.topk(masked, k, dim=-1), reps),
            bound=_bound_ms(k2_bytes, 0.0, 'float32'),
            max_abs_err=0.0)
        del masked
        keep = [((sim >= tau[:, gg:gg + 1]) & valid[gg][None]).sum().item()
                for gg in range(g)]
        for vdt in (torch.float32, torch.bfloat16):
            v = values.to(vdt)
            name = f'topk_readout_{str(vdt)[6:]}'
            nbytes = (sim.numel() * 4 + v.numel() * v.element_size()
                      + valid.numel() + 3 * tau.numel() * 4
                      + len(gids) * p * v.shape[-1] * 4)
            flops = sum(2.0 * keep[gg] * v.shape[-1] for gg in gids)
            rows[(name, label)] = dict(
                ms=_time_ms(lambda: RK.topk_readout(
                    sim, v, valid, tau, rmax, invz, gids), reps),
                plain_ms=_time_ms(lambda: RK.topk_readout_plain(
                    sim, v, valid, tau, rmax, invz, gids), reps),
                library_ms=None,
                bound=_bound_ms(nbytes, flops, str(vdt)[6:]),
                max_abs_err=err[name])
        rows[('topk_usage', label)] = dict(
            ms=_time_ms(lambda: RK.topk_usage(sim, valid, tau, rmax, invz),
                        reps),
            plain_ms=_time_ms(lambda: RK.topk_usage_plain(
                sim, valid, tau, rmax, invz), reps),
            library_ms=None,
            bound=_bound_ms(sim.numel() * 4 + valid.numel() + 3 * tau.numel()
                            * 4 + n * 4, 2.0 * keep[0], 'float32'),
            max_abs_err=err['topk_usage'])
        for (name, lb), r in sorted(rows.items()):
            if lb == label:
                log(f'[kernels] {label} N={n} {name}: {r["ms"]:.4f} ms, plain '
                    f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]}, '
                    f'bound {r["bound"][0]:.4f} ms ({r["bound"][1]})')
        if len(gids) > 2:
            _many_calls(RK, qk, qe, segs, gids, label)
        del sims, segs, stats
        torch.cuda.empty_cache()
    _wide_case(RK)
    return rows


# ---------------------------------------------------------------------------
# phase 4-5: the main path
# ---------------------------------------------------------------------------

def _synth_weights(module, seed: int) -> dict:
    """Seeded weights for `module`'s state-dict names and shapes, conditioned
    as tests/golden_utils.py (BN near identity, He-scaled convs), as
    tensors."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        a = rng.standard_normal(shape).astype(np.float32)
        if name.endswith('running_var'):
            a = np.abs(1.0 + 0.2 * a) + 0.1
        elif name.endswith('running_mean') or name.endswith('bias'):
            a = 0.2 * a
        elif name.endswith('weight') and a.ndim == 1:
            a = 1.0 + 0.2 * a
        elif name.endswith('weight') and a.ndim == 4:
            a = a * np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
        elif name.endswith('weight') and a.ndim == 2:
            a = a / np.float32(np.sqrt(shape[1]))
        sd[name] = torch.from_numpy(a)
    return sd


def synth_checkpoint(path: Path, seed: int = 0):
    """Seeded synthetic weights at the published XMem widths (key 64, value
    512, hidden 64; ResNet-50 / ResNet-18 encoders), names and shapes from
    the port's own module, with the key/shrinkage projections tamed as
    tests/test_e2e_parity.py:46-47. Saved as a reference-format .pth."""
    import torch
    from xmem2_tpu_torch.models.network import XMem

    sd = _synth_weights(XMem(), seed)
    sd['key_proj.key_proj.weight'] *= 0.001
    sd['key_proj.d_proj.weight'] *= 0.01
    torch.save(sd, path)


def synth_video(root: Path, h: int, w: int, n: int, second_at: int):
    """Textured frames with two moving ellipses; object 1 annotated on frame
    0, objects 1 and 2 on frame `second_at` (a second object group)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(1)
    imgs, anns = root / 'JPEGImages', root / 'Annotations'
    imgs.mkdir(parents=True)
    anns.mkdir(parents=True)
    yy, xx = np.mgrid[0:h, 0:w]
    bg = rng.integers(0, 255, (h // 16, w // 16, 3)).astype(np.uint8)
    bg = np.asarray(Image.fromarray(bg).resize((w, h), Image.BILINEAR))
    palette = [0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * (256 * 3 - 9)
    for t in range(n):
        label = np.zeros((h, w), np.uint8)
        cx = w * (0.2 + 0.5 * t / n)
        label[((yy - h * 0.5) / (h * 0.2)) ** 2
              + ((xx - cx) / (w * 0.15)) ** 2 < 1] = 1
        if t >= second_at:
            cx2 = w * (0.8 - 0.3 * t / n)
            label[((yy - h * 0.3) / (h * 0.12)) ** 2
                  + ((xx - cx2) / (w * 0.1)) ** 2 < 1] = 2
        frame = bg.copy()
        frame[label == 1] = (220, 60, 40)
        frame[label == 2] = (40, 200, 90)
        frame = np.clip(frame.astype(int) + rng.integers(-12, 12, frame.shape),
                        0, 255).astype(np.uint8)
        Image.fromarray(frame).save(imgs / f'frame_{t:06d}.jpg', quality=92)
        if t in (0, second_at):
            m = Image.fromarray(label, mode='P')
            m.putpalette(palette)
            m.save(anns / f'frame_{t:06d}.png')
    return imgs, anns


@contextlib.contextmanager
def _patched(module, name, wrap):
    """module.name replaced by wrap(original) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def _cores():
    """The InferenceCores run_on_video builds inside the block, in a list."""
    from xmem2_tpu_torch.inference import run_on_video as R
    made = []

    def wrap(load):
        def loaded(*a, **k):
            out = load(*a, **k)
            made.append(out[1])
            return out
        return loaded

    with _patched(R, '_load_main_objects', wrap):
        yield made


def _timed(seconds: dict, key: str):
    """A wrapper factory for _patched: adds the call's seconds, the device
    synchronised at both ends, to seconds[key]."""
    import torch

    def wrap(fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return timed
    return wrap


def _kernel_launches():
    """Each readout kernel's launches since the counters were last reset
    (utils/profiling.py: reset_counters(), and every run_on_video call as
    it starts)."""
    from xmem2_tpu_torch.utils.profiling import counters
    c = counters()
    return {k: c.get(f'kernel.{k}', 0)
            for k in ('block_topk_candidates', 'topk_readout', 'topk_usage')}


def _launched(tag, counts):
    """Fails unless every kernel launched during the run of `tag`."""
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f'{tag}: kernel {name} never launched')


def _run(imgs, anns, out, ckpt, device, overwrite, frames=(0, 60), **kw):
    """run_on_video with every probability map checked for NaN on its way
    to the mask packer; kw go to run_on_video. Returns (seconds, frames
    written, non-finite)."""
    import torch
    from xmem2_tpu_torch.inference import core
    from xmem2_tpu_torch.inference.run_on_video import run_on_video

    bad = torch.zeros((), dtype=torch.int64, device=device)
    pack = core.prob_to_mask_packed

    def checked(prob, out_hw=None):
        bad.add_((~torch.isfinite(prob)).sum())
        return pack(prob, out_hw)

    core.prob_to_mask_packed = checked
    try:
        t0 = time.perf_counter()
        run_on_video(str(imgs), str(anns), str(out), frames_with_masks=frames,
                     print_progress=False, save_overlay=False, device=device,
                     overwrite_config=dict(overwrite, model=str(ckpt)), **kw)
        if device == 'cuda':
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        core.prob_to_mask_packed = pack
    return seconds, len(list((Path(out) / 'masks').glob('*.png'))), \
        int(bad.item())


def main_path_phase(work: Path, card: str):
    from xmem2_tpu_torch.utils.profiling import counters, reset_counters

    ckpt = work / 'synth_xmem.pth'
    synth_checkpoint(ckpt)
    n = 120
    imgs, anns = synth_video(work / 'video480', 480, 854, n, 60)
    exact = {'compute_dtype': 'float32', 'value_store_dtype': 'float32'}
    # warm-up: cuDNN picks its algorithms, kernels load
    _run(imgs, anns, work / 'warm', ckpt, 'cuda', {})
    counts = {}
    for tag, over in (('default (bf16, chunked)', {}), ('exact (f32)', exact)):
        reset_counters()
        seconds, written, bad = _run(imgs, anns, work / tag.split()[0], ckpt,
                                     'cuda', over)
        counts[tag] = _kernel_launches()
        counts[tag]['bn_epilogue'] = counters().get('kernel.bn_epilogue', 0)
        log(f'[main] {tag}: {n} frames at 854x480 in {seconds:.3f} s = '
            f'{n / seconds:.2f} frames/s on {card}; launches {counts[tag]}')
        if written != n:
            raise AssertionError(f'{tag}: {written} of {n} masks written')
        if bad:
            raise AssertionError(f'{tag}: {bad} non-finite probabilities')
        _launched(tag, counts[tag])
    return counts


def _kernel_groups(prof):
    """A profile's CUDA kernels: ([(device us, name, count)] largest first,
    {group: device us}, total device us). Raises if no device time."""
    from torch.autograd import DeviceType

    dev = []            # kernels only: an op's kernels are not counted twice
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, 'device_time_total', None)
        if us is None:
            us = getattr(e, 'cuda_time_total', 0)
        if us > 0:
            dev.append((us, e.key, e.count))
    dev.sort(reverse=True)
    total = sum(us for us, _, _ in dev)
    if total == 0:
        raise AssertionError('the profiler recorded no device time')
    groups = {}
    for us, key, _ in dev:
        k = key.lower()
        if 'block_topk' in k:
            grp = 'K2 block_topk_candidates'
        elif 'topk_readout' in k:
            grp = 'K1 topk_readout'
        elif 'topk_usage' in k:
            grp = 'K1 topk_usage'
        elif any(w in k for w in ('fprop', 'dgrad', 'wgrad', 'conv', 'cudnn',
                                  'nchwtonhwc', 'nhwctonchw')):
            grp = 'convolutions (cuDNN, with its layout transposes)'
        elif any(w in k for w in ('gemm', 'cublas', 'cutlass')):
            grp = 'matrix products (cuBLAS)'
        else:
            grp = 'elementwise, reductions, copies'
        groups[grp] = groups.get(grp, 0) + us
    return dev, groups, total


def profile_phase(work: Path, card: str, label='default mode', **run_kw):
    """One default-mode run under torch.profiler (run_kw go to
    run_on_video): device time by kernel, grouped, and the device's busy
    share of the run's wall time (the profiler's own cost is inside that
    wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    imgs, anns = work / 'video480' / 'JPEGImages', work / 'video480' / \
        'Annotations'
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seconds, _, _ = _run(imgs, anns, work / 'prof', work /
                             'synth_xmem.pth', 'cuda', {}, **run_kw)
    dev, groups, total = _kernel_groups(prof)
    log(f'[profile] {label}, 120 frames at 854x480 on {card}: wall '
        f'{seconds:.3f} s under the profiler, device busy {total / 1e6:.3f} '
        f's ({100 * total / 1e6 / seconds:.1f}% of wall)')
    for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f'[profile]   {grp}: {us / 1e3:.1f} ms ({100 * us / total:.1f}%)'
            f', {us / 1e3 / 120:.3f} ms/frame')
    for us, key, count in dev[:12 if label == 'default mode' else 6]:
        log(f'[profile]   top: {us / 1e3:9.1f} ms  x{count:<6d} {key[:90]}')
    host = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    for us, key, count in host[:8 if label == 'default mode' else 4]:
        log(f'[profile]   host: {us / 1e3:9.1f} ms  x{count:<6d} {key[:80]}')


def augment_phase(work: Path, card: str):
    """The default run with augment_images_with_masks: both annotated frames
    and 11 augmentations of each in permanent memory (24 frames)."""
    from xmem2_tpu_torch.inference import run_on_video as R
    from xmem2_tpu_torch.utils.profiling import reset_counters

    n = 120
    imgs, anns = work / 'video480' / 'JPEGImages', work / 'video480' / \
        'Annotations'
    seconds = {}
    reset_counters()
    with _cores() as cores, _patched(R, '_preload_permanent_memory',
                                     _timed(seconds, 'preload')):
        run_s, written, bad = _run(imgs, anns, work / 'augment', work /
                                   'synth_xmem.pth', 'cuda', {},
                                   augment_images_with_masks=True)
    counts = _kernel_launches()
    mm = cores[0].memory
    log(f'[augment] {n} frames at 854x480, permanent memory {mm.perm_size} '
        f'slots ({mm.perm_size // mm.HW} frames) in a store of '
        f'{mm.perm.capacity}: {run_s:.3f} s = {n / run_s:.2f} frames/s, '
        f'preload (host augmentation and encoding) {seconds["preload"]:.3f} '
        f's on {card}; launches {counts}')
    if written != n or bad:
        raise AssertionError(f'augment: {written} of {n} masks, {bad} '
                             f'non-finite probabilities')
    if mm.perm_size != 24 * mm.HW or \
            sorted(mm.frame_id_to_permanent_mem_idx) != [0, 60]:
        raise AssertionError(f'augment: permanent memory holds '
                             f'{mm.perm_size} slots, frames '
                             f'{mm.frame_id_to_permanent_mem_idx}')
    _launched('augment', counts)
    return counts


def select_phase(work: Path, card: str):
    """select_k_next_best_annotation_candidates on the 480p video, reading
    the masks of the default run."""
    import numpy as np
    import torch
    from xmem2_tpu_torch.inference import run_on_video as R
    from xmem2_tpu_torch.inference.frame_selection import frame_selection \
        as FS

    imgs, anns = work / 'video480' / 'JPEGImages', work / 'video480' / \
        'Annotations'
    seconds, dissims = {}, []

    def record(fn):
        def recorded(*a, **k):
            out = fn(*a, **k)
            dissims.append(out)
            return out
        return recorded

    # the random weights may predict little foreground at 480p; a frame
    # whose masks cover under min_mask_presence_percent (0.25%) scores 0,
    # and once no frame scores more the greedy pick repeats frame 0, so the
    # check admits every frame (the rule itself is held to JAX by
    # tests/test_torch_frame_selection.py)
    fg = np.array([m.mean() for m in R.read_foreground_masks(
        work / 'default' / 'masks')])
    log(f'[select] foreground share of the default run\'s masks: median '
        f'{np.median(fg):.4%}, {int((fg < 0.0025).sum())} of {len(fg)} '
        f'frames under 0.25%')
    with _patched(R, 'extract_keys', _timed(seconds, 'extract_keys')), \
            _patched(R, 'select_candidates_from_rows',
                     _timed(seconds, 'select')), \
            _patched(FS, 'cycle_dissimilarity', record):
        chosen = R.select_k_next_best_annotation_candidates(
            str(imgs), str(anns), masks_out_path=str(work / 'default'), k=5,
            print_progress=False, previously_chosen_candidates=[0],
            use_previously_predicted_masks=True, device='cuda',
            min_mask_presence_percent=0.0,
            overwrite_config={'model': str(work / 'synth_xmem.pth')})
    d = torch.cat(dissims)
    log(f'[select] k=5 of 120 frames at 854x480: chose {chosen}; '
        f'extract_keys {seconds["extract_keys"]:.3f} s, selection '
        f'{seconds["select"]:.3f} s ({d.numel()} frame pairs, dissimilarity '
        f'{d.min().item():.4g}..{d.max().item():.4g}) on {card}')
    if len(set(chosen)) != 5 or not all(0 < c < 120 for c in chosen):
        raise AssertionError(f'select: chose {chosen}')
    if not bool(torch.isfinite(d).all()):
        raise AssertionError('select: non-finite dissimilarity (dmin)')


def spill_phase(work: Path, card: str):
    """A default-mode run with spill_long_term and memory settings under
    which long-term memory evicts several times (a memory frame every 2
    frames, long-term memory capped at 1,000 slots: 872 survive an eviction,
    a consolidation adds 128 prototypes); then the cap raised to 2,000
    through InferenceCore.update_config, which revives archived rows, and
    one more step."""
    import numpy as np
    import torch
    from PIL import Image
    from xmem2_tpu_torch.memory import manager as MM
    from xmem2_tpu_torch.utils.profiling import reset_counters

    n = 120
    imgs, anns = work / 'video480' / 'JPEGImages', work / 'video480' / \
        'Annotations'
    evictions = []

    def count(evict):
        def counted(store, max_size):
            before = store.size
            out = evict(store, max_size)
            if store.size < before:
                evictions.append(before - store.size)
            return out
        return counted

    over = {'mem_every': 2, 'max_long_term_elements': 1000}
    # the same settings without spill: what spilling itself costs
    off_s, written, bad = _run(imgs, anns, work / 'spill_off', work /
                               'synth_xmem.pth', 'cuda', over)
    if written != n or bad:
        raise AssertionError(f'spill off: {written} of {n} masks, {bad} '
                             f'non-finite probabilities')
    over['spill_long_term'] = True
    reset_counters()
    with _cores() as cores, _patched(MM.ST, 'evict_by_usage', count):
        run_s, written, bad = _run(imgs, anns, work / 'spill', work /
                                   'synth_xmem.pth', 'cuda', over)
    counts = _kernel_launches()
    core = cores[0]
    mm = core.memory
    archived, long_before = len(mm.archive), mm.long_size
    core.update_config(dict(core.config, max_long_term_elements=2000))
    revived = mm.long_size - long_before
    reset_counters()
    frame = np.asarray(Image.open(imgs / 'frame_000000.jpg').convert('RGB'))
    prob = core.step(frame)
    torch.cuda.synchronize()
    step_counts = _kernel_launches()
    log(f'[spill] {n} frames at 854x480, {len(evictions)} evictions of '
        f'{evictions} rows: {run_s:.3f} s = {n / run_s:.2f} frames/s on '
        f'{card} (the same settings without spill: {off_s:.3f} s = '
        f'{n / off_s:.2f} frames/s); archive {archived} rows, {revived} revived by raising '
        f'max_long_term_elements to 2000 (long-term memory {long_before} -> '
        f'{mm.long_size} slots); launches {counts}, then {step_counts} in '
        f'one step')
    if written != n or bad:
        raise AssertionError(f'spill: {written} of {n} masks, {bad} '
                             f'non-finite probabilities')
    if len(evictions) < 2 or archived == 0 or revived <= 0:
        raise AssertionError(f'spill: {len(evictions)} evictions, '
                             f'{archived} archived, {revived} revived')
    if not bool(torch.isfinite(prob).all()):
        raise AssertionError('spill: the step after revival is not finite')
    _launched('spill', counts)
    _launched('spill step', step_counts)
    return counts


def eval_phase(work: Path, card: str):
    """python -m xmem2_tpu_torch.eval on a generic dataset of two 854x480
    videos of 30 frames, once with --benchmark and once with
    --save_scores."""
    from xmem2_tpu_torch import eval as port_eval
    from xmem2_tpu_torch.utils.profiling import reset_counters

    root = work / 'generic'
    for vid, second_at in (('a', 15), ('b', 30)):   # 'b': frame 0 only
        imgs, anns = synth_video(work / f'src_{vid}', 480, 854, 30,
                                 second_at)
        (root / 'JPEGImages').mkdir(parents=True, exist_ok=True)
        (root / 'Annotations').mkdir(parents=True, exist_ok=True)
        imgs.rename(root / 'JPEGImages' / vid)
        anns.rename(root / 'Annotations' / vid)
    base = ['--dataset', 'G', '--generic_path', str(root), '--model',
            str(work / 'synth_xmem.pth')]
    out = {}
    for tag, extra in (('benchmark', ['--benchmark']),
                       ('save_scores', ['--save_scores'])):
        reset_counters()
        stats = port_eval.main(base + ['--output', str(work / f'eval_{tag}')]
                               + extra)
        counts = _kernel_launches()
        masks = list((work / f'eval_{tag}').rglob('*.png'))
        scores = list((work / f'eval_{tag}').rglob('*.npz'))
        log(f'[eval] --{tag}: {stats["frames"]} frames of two 854x480 videos '
            f'in {stats["seconds"]:.3f} s = {stats["fps"]:.2f} frames/s, peak '
            f'memory {stats["peak_memory_mb"]:.0f} MB on {card}; '
            f'{len(masks)} masks, {len(scores)} score files; launches '
            f'{counts}')
        want_scores = 60 if tag == 'save_scores' else 0
        if stats['frames'] != 60 or len(masks) != 60 or \
                len(scores) != want_scores:
            raise AssertionError(f'eval --{tag}: {stats["frames"]} frames, '
                                 f'{len(masks)} masks, {len(scores)} scores')
        _launched(f'eval --{tag}', counts)
        out[tag] = stats
    return out


def merge_phase(work: Path, card: str):
    """python -m xmem2_tpu_torch.merge_multi_scale over the eval phase's
    --save_scores tree and an --exact --save_scores run of the same two
    videos (DAVIS layout): one palette PNG per frame, the zip."""
    import numpy as np
    from PIL import Image
    from xmem2_tpu_torch import eval as port_eval

    base = ['--dataset', 'G', '--generic_path', str(work / 'generic'),
            '--model', str(work / 'synth_xmem.pth')]
    port_eval.main(base + ['--output', str(work / 'eval_exact_scores'),
                           '--save_scores', '--exact'])
    runs = [work / 'eval_save_scores', work / 'eval_exact_scores']
    out = work / 'merged'
    cmd = [sys.executable, '-m', 'xmem2_tpu_torch.merge_multi_scale',
           '--dataset', 'D', '--list'] + [str(r) for r in runs] + [
           '--output', str(out), '--num_proc', '4']
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=work, capture_output=True, text=True,
                          timeout=300, env=dict(
                              os.environ,
                              PYTHONPATH=str(Path(__file__).resolve().parent)))
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f'merge_multi_scale failed:\n'
                             f'{done.stderr[-3000:]}')
    changed, total = 0, 0
    for vid in ('a', 'b'):
        scores = sorted((runs[0] / 'Scores' / vid).glob('*.npz'))
        pngs = sorted((out / vid).glob('*.png'))
        if [p.stem for p in pngs] != [p.stem for p in scores] or \
                len(pngs) != 30:
            raise AssertionError(f'merge: {len(pngs)} PNGs for {len(scores)} '
                                 f'score files of video {vid}')
        for png in pngs:
            im = Image.open(png)
            if im.mode != 'P':
                raise AssertionError(f'merge: {png} is not a palette PNG')
            one = np.asarray(Image.open(runs[0] / 'Annotations' / vid /
                                        png.name))
            changed += int((np.asarray(im) != one).sum())
            total += one.size
    if not Path(str(out) + '.zip').exists():
        raise AssertionError('merge: no zip written')
    log(f'[merge] two --save_scores runs (bf16 and --exact) of two 854x480 '
        f'videos merged in {seconds:.2f} s (a process, 4 workers) on {card}: '
        f'60 palette PNGs, the zip; {changed / total:.4%} of pixels differ '
        f'from the bf16 run alone')


def _mask_diff(dir_a: Path, dir_b: Path):
    """(share of all pixels, largest share in one frame) that differ between
    two runs' masks."""
    import numpy as np
    from PIL import Image
    worst, diff, total = 0.0, 0, 0
    files = sorted((dir_a / 'masks').glob('*.png'))
    for f in files:
        a = np.asarray(Image.open(f).convert('RGB'))
        b = np.asarray(Image.open(dir_b / 'masks' / f.name).convert('RGB'))
        d = np.any(a != b, axis=-1)
        worst = max(worst, float(d.mean()))
        diff, total = diff + int(d.sum()), total + d.size
    return (diff / total, worst) if files else (1.0, 1.0)


def _worst_mask_diff(dir_a: Path, dir_b: Path) -> float:
    """The largest share of pixels that differ in one frame between two
    runs' masks."""
    return _mask_diff(dir_a, dir_b)[1]


SHARD_TOL = {'f32': 1e-4, 'bf16': 1e-3}


def shard_kernel_check(card: str):
    """The three segments of the kernel phase split into D = 4 shards (12
    pieces): every piece's K2 lists, their merge at the gathered shape
    [G, P, D*S*k] and the stats bit-equal to the plain versions; the
    sharded readout against the unsharded one (f32 values); the whole
    sharded call timed beside the unsharded call."""
    import torch
    from xmem2_tpu_torch.ops import readout_kernel as RK
    from xmem2_tpu_torch.ops.similarity import get_similarity_padded
    from xmem2_tpu_torch.parallel import sharded_readout as SR

    dev, d, k, p = torch.device('cuda'), 4, 30, 1620
    qk, qe, segs = _segments(dev, p)
    sharded = [list(zip(*SR.shard_memory_bank(*seg, [dev] * d)))
               for seg in segs]
    pieces = [piece for shards in sharded for piece in shards]
    sims = [get_similarity_padded(mk, ms, qk, qe, p, mk.shape[0])
            for mk, ms, _, _ in pieces]
    valids = [piece[3] for piece in pieces]
    # each piece's lists, their merge at the gathered shape and the stats
    _check_k2(RK, sims, valids, k, f'{d} shards')
    gathered = (valids[0].shape[0], p, len(pieces) * k)
    out, _ = SR.sharded_topk_readout_multi(sharded, qk, qe, (0, 1), k)
    ref, _ = RK.fused_topk_readout_multi(segs, qk, qe, (0, 1), k)
    err = (out - ref).abs().max().item()
    ms = _time_ms(lambda: SR.sharded_topk_readout_multi(
        sharded, qk, qe, (0, 1), k), 10)
    ms_one = _time_ms(lambda: RK.fused_topk_readout_multi(
        segs, qk, qe, (0, 1), k), 10)
    log(f'[shard] P={p}, three segments in {d} shards on one card: merge K2 '
        f'at [{", ".join(map(str, gathered))}] and the stats '
        f'bit-equal to plain; sharded readout vs unsharded max abs err '
        f'{err:.3e} (tol {KERNEL_TOL["float32"]}); match ms sharded '
        f'{ms:.4f}, unsharded {ms_one:.4f} (f32 values) on {card}')
    if err > KERNEL_TOL['float32']:
        raise AssertionError('the sharded readout disagrees')


def shard_phase(work: Path, card: str):
    """run_on_video over the first 60 frames of a 854x480 video with two
    objects (annotated on frames 0 and 30): unsharded (chunked, the default,
    and frame by frame, the path a sharded memory takes) and with
    memory_shards 2 and 4 on this card, in bf16 and f32. Returns the
    launches of the runs with 4 shards, by dtype."""
    import torch
    from xmem2_tpu_torch.utils.profiling import reset_counters

    shard_kernel_check(card)
    n = 60
    imgs, anns = synth_video(work / 'video_shard', 480, 854, n, 30)
    ckpt = work / 'synth_xmem.pth'
    exact = {'compute_dtype': 'float32', 'value_store_dtype': 'float32'}
    runs = (('unsharded', {}, None), ('frame by frame', {'chunk_frames':
                                                          False}, None),
            ('2 shards', {'memory_shards': 2}, 2),
            ('4 shards', {'memory_shards': 4}, 4))
    if torch.cuda.device_count() > 1:
        d = min(torch.cuda.device_count(), 4)
        runs += ((f'{d} shards on {d} cards', {'memory_shards': d}, 0),)
    else:
        log('[shard] one card is visible: every shard is on cuda:0 '
            '(shard_devices); no run over several cards')
    counts = {}
    for dtype, over in (('bf16', {}), ('f32', exact)):
        for tag, extra, shards in runs:
            out = work / f'shard_{dtype}_{tag.replace(" ", "_")}'
            reset_counters()
            torch.cuda.reset_peak_memory_stats()
            seconds, written, bad = _run(
                imgs, anns, out, ckpt, 'cuda', dict(over, **extra),
                frames=(0, 30), shard_devices=['cuda:0'] * shards
                if shards else None)
            counts[dtype, tag] = _kernel_launches()
            peak = torch.cuda.max_memory_allocated() / 1e9
            share, worst = _mask_diff(
                work / f'shard_{dtype}_frame_by_frame', out) \
                if tag != 'unsharded' else (0.0, 0.0)
            log(f'[shard] {dtype}, {tag}: {n} frames at 854x480 in '
                f'{seconds:.3f} s = {n / seconds:.2f} frames/s, peak '
                f'{peak:.3f} GB allocated on {card}; masks vs frame by frame '
                f'{share:.5%} of pixels (worst frame {worst:.4%}); launches '
                f'{counts[dtype, tag]}')
            if written != n or bad:
                raise AssertionError(f'shard {dtype} {tag}: {written} of {n} '
                                     f'masks, {bad} non-finite')
            if 'memory_shards' in extra:
                _launched(f'shard {dtype} {tag}', counts[dtype, tag])
                if share > SHARD_TOL[dtype]:
                    raise AssertionError(f'shard {dtype} {tag}: masks differ '
                                         f'on {share:.5%} of pixels')
        k2 = [counts[dtype, t]['block_topk_candidates'] for t in
              ('frame by frame', '2 shards', '4 shards')]
        if not k2[0] < k2[1] < k2[2]:
            raise AssertionError(f'shard {dtype}: K2 launches {k2} do not '
                                 f'grow with the shard count')
    return {dtype: counts[dtype, '4 shards'] for dtype in ('bf16', 'f32')}


def synth_many_video(root: Path, h: int, w: int, n: int, blocks):
    """Textured frames with many moving ellipses on a grid. blocks: (frame,
    count) pairs: `count` new objects first appear, and are annotated, on
    `frame`; every annotated frame's palette mask carries every object
    present (exhaustive), so each block forms a new object group."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(3)
    imgs, anns = root / 'JPEGImages', root / 'Annotations'
    imgs.mkdir(parents=True)
    anns.mkdir(parents=True)
    first = [f for f, c in blocks for _ in range(c)]
    total = len(first)
    cols = min(total, 10 if total > 12 else 4)
    rows = -(-total // cols)
    yy, xx = np.mgrid[0:h, 0:w]
    colours = rng.integers(30, 230, (total + 1, 3)).astype(np.uint8)
    palette = [0, 0, 0] + colours[1:].reshape(-1).tolist()
    palette += [0] * (256 * 3 - len(palette))
    bg = rng.integers(0, 255, (h // 16, w // 16, 3)).astype(np.uint8)
    bg = np.asarray(Image.fromarray(bg).resize((w, h), Image.BILINEAR))
    for t in range(n):
        label = np.zeros((h, w), np.uint8)
        for o in range(1, total + 1):
            if t < first[o - 1]:
                continue
            r, c = divmod(o - 1, cols)
            cy = (r + 0.5) * h / rows
            cx = (c + 0.5) * w / cols + 0.1 * w / cols * t / n
            label[((yy - cy) / (0.38 * h / rows)) ** 2
                  + ((xx - cx) / (0.38 * w / cols)) ** 2 < 1] = o
        frame = bg.copy()
        for o in range(1, total + 1):
            frame[label == o] = colours[o]
        frame = np.clip(frame.astype(int) + rng.integers(-12, 12, frame.shape),
                        0, 255).astype(np.uint8)
        Image.fromarray(frame).save(imgs / f'frame_{t:06d}.jpg', quality=92)
        if t in {f for f, _ in blocks}:
            m = Image.fromarray(label, mode='P')
            m.putpalette(palette)
            m.save(anns / f'frame_{t:06d}.png')
    return imgs, anns, tuple(sorted({f for f, _ in blocks}))


def many_phase(work: Path, card: str) -> dict:
    """run_on_video on synthetic 854x480 video with many objects: (a) 12
    objects in 10 groups over 60 frames (objects 1-3 annotated on frame 0,
    objects 4-12 first on frames 5, 10, ..., 45), default (bf16, chunked)
    and --exact (f32); (b) 70 objects in 3 groups over 20 frames (30, 25
    and 15 objects first on frames 0, 2 and 4), default mode. Every mask
    written, nothing non-finite, the configuration's group count, K1, K2
    and usage launched; frames/s, peak memory, launches per readout call.
    Returns the launches of each run."""
    import torch
    from xmem2_tpu_torch.memory import manager as MM
    from xmem2_tpu_torch.utils.profiling import reset_counters

    ckpt = work / 'synth_xmem.pth'
    exact = {'compute_dtype': 'float32', 'value_store_dtype': 'float32'}
    videos = {
        '12 in 10': (60, [(0, 3)] + [(5 * i, 1) for i in range(1, 10)]),
        # annotated frames go to permanent memory; from frame 14 on (a
        # memory frame every 10) working memory holds a frame, whose usage
        # the readout then counts
        '70 in 3': (20, [(0, 30), (2, 25), (4, 15)]),
    }
    runs = (('12 in 10', 'default', {}), ('12 in 10', 'exact', exact),
            ('70 in 3', 'default', {}))
    matches = []

    def count(fn):
        def counted(*a, **k):
            matches.append(1)
            return fn(*a, **k)
        return counted

    made = {}
    for name, (n, blocks) in videos.items():
        made[name] = synth_many_video(work / f'many_{name.replace(" ", "_")}',
                                      480, 854, n, blocks)
    counts = {}
    for name, mode, over in runs:
        n, blocks = videos[name]
        imgs, anns, frames = made[name]
        tag = f'{name} {mode}'
        reset_counters()
        matches.clear()
        torch.cuda.reset_peak_memory_stats()
        with _cores() as cores, _patched(MM, 'fused_topk_readout_multi',
                                         count):
            seconds, written, bad = _run(
                imgs, anns, work / f'many_{tag.replace(" ", "_")}', ckpt,
                'cuda', over, frames=frames)
        counts[tag] = _kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        mm = cores[0].memory
        per = {k: round(v / max(len(matches), 1), 3)
               for k, v in counts[tag].items()}
        log(f'[many] {tag}: {mm.num_objects} objects in '
            f'{len(mm.obj_groups)} groups, {n} frames at 854x480 in '
            f'{seconds:.3f} s = {n / seconds:.2f} frames/s, peak '
            f'{peak:.3f} GB allocated on {card}; {len(matches)} readout '
            f'calls, launches {counts[tag]} = {per} a call')
        if written != n or bad:
            raise AssertionError(f'many {tag}: {written} of {n} masks, {bad} '
                                 f'non-finite probabilities')
        if len(mm.obj_groups) != len(blocks) or \
                mm.num_objects != sum(c for _, c in blocks):
            raise AssertionError(f'many {tag}: {mm.num_objects} objects in '
                                 f'{len(mm.obj_groups)} groups')
        _launched(f'many {tag}', counts[tag])
    return counts


def small_check_phase(work: Path):
    """The port on the card against the port on the CPU (plain version of
    every kernel), f32, on a small video: masks equal up to 0.1% of pixels
    (argmax near-ties under another float32 summation order), plain and
    with augment_images_with_masks; the same annotation candidates chosen;
    with spill_long_term (a memory frame every frame, so long-term memory
    evicts), the same number of archived rows. Then a 96x160 video of 24
    frames with 12 objects in 10 groups (objects 1-3 on frame 0, objects
    4-12 first on frames 2, 4, ..., 18): masks equal on >= 99.99% of all
    pixels, ten groups on both devices (the chunked kernels against the
    plain versions in the loop)."""
    from xmem2_tpu_torch.inference.run_on_video import \
        select_k_next_best_annotation_candidates

    imgs, anns = synth_video(work / 'video_small', 64, 96, 12, 6)
    over = {'size': -1, 'mem_every': 2, 'max_mid_term_frames': 4,
            'min_mid_term_frames': 2, 'num_prototypes': 16,
            'max_long_term_elements': 24, 'compute_dtype': 'float32',
            'value_store_dtype': 'float32'}
    spill = dict(over, spill_long_term=True, mem_every=1)
    ckpt = work / 'synth_xmem.pth'
    chosen, archived = {}, {}
    for dev in ('cuda', 'cpu'):
        for tag, o, kw in (('plain', over, {}),
                           ('augment', over,
                            {'augment_images_with_masks': True})):
            _, written, bad = _run(imgs, anns, work / f'small_{tag}_{dev}',
                                   ckpt, dev, o, frames=(0, 6), **kw)
            if written != 12 or bad:
                raise AssertionError(f'small video, {tag}, on {dev}: '
                                     f'{written} masks, {bad} non-finite')
        with _cores() as cores:
            _run(imgs, anns, work / f'small_spill_{dev}', ckpt, dev, spill,
                 frames=(0, 6))
        archived[dev] = len(cores[0].memory.archive)
    for dev in ('cuda', 'cpu'):     # both from the CPU run's masks
        chosen[dev] = select_k_next_best_annotation_candidates(
            str(imgs), str(anns), masks_out_path=str(work / 'small_plain_cpu'),
            k=3, print_progress=False, previously_chosen_candidates=[0],
            device=dev, overwrite_config=dict(over, model=str(ckpt)))
    worst = {tag: _worst_mask_diff(work / f'small_{tag}_cpu',
                                   work / f'small_{tag}_cuda')
             for tag in ('plain', 'augment')}
    log(f'[check] card vs CPU on the small video: worst frame '
        f'{worst["plain"]:.4%} of pixels differ, augmented '
        f'{worst["augment"]:.4%} (limit 0.1%); candidates {chosen}; spill '
        f'archive rows {archived}')
    if max(worst.values()) > 1e-3:
        raise AssertionError('card and CPU masks disagree')
    if chosen['cuda'] != chosen['cpu']:
        raise AssertionError('card and CPU choose other candidates')
    if archived['cuda'] != archived['cpu'] or archived['cpu'] == 0:
        raise AssertionError(f'spill archives differ or are empty: '
                             f'{archived}')

    imgs, anns, frames = synth_many_video(
        work / 'video_many_small', 96, 160, 24,
        [(0, 3)] + [(2 * i, 1) for i in range(1, 10)])
    groups = {}
    for dev in ('cuda', 'cpu'):
        with _cores() as cores:
            _, written, bad = _run(imgs, anns, work / f'small_many_{dev}',
                                   ckpt, dev, over, frames=frames)
        groups[dev] = len(cores[0].memory.obj_groups)
        if written != 24 or bad:
            raise AssertionError(f'small 12-object video on {dev}: '
                                 f'{written} masks, {bad} non-finite')
    share, worst = _mask_diff(work / 'small_many_cpu',
                              work / 'small_many_cuda')
    log(f'[check] card vs CPU, 12 objects in {groups} groups, 24 frames of '
        f'96x160: {share:.5%} of pixels differ (limit 0.01%), worst frame '
        f'{worst:.4%}')
    if share > 1e-4 or groups != {'cuda': 10, 'cpu': 10}:
        raise AssertionError('card and CPU disagree on the 12-object video')


# ---------------------------------------------------------------------------
# phase 13-15: training
# ---------------------------------------------------------------------------

def synth_training_data(root: Path, h: int = 480, w: int = 854):
    """Training data in the reference layouts at 854x480: static images
    (static/fss/<class>/<i>.jpg|png and the flat DUTS-TR folder, plus the
    other flat folders stage 0 lists, empty), DAVIS
    (DAVIS/2017/trainval/{JPEGImages,Annotations}/480p/<video>) and
    YouTubeVOS (YouTube/train_480p/{JPEGImages,Annotations}/<video>). The
    videos carry names of the stage-2 whitelists; each has three moving
    objects."""
    import io

    import numpy as np
    from PIL import Image
    from xmem2_tpu_torch.utils.load_subset import load_sub_davis, \
        load_sub_yv

    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w]
    palette = [0, 0, 0, 128, 0, 0, 0, 128, 0, 0, 0, 128] + [0] * 756

    def encoded(t):
        """Frame t's JPEG and its label map's palette PNG, as bytes."""
        bg = rng.integers(0, 255, (h // 16, w // 16, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(bg).resize((w, h), Image.BILINEAR))
        label = np.zeros((h, w), np.uint8)
        for o in range(3):
            cx = w * (0.2 + 0.25 * o + 0.01 * t)
            cy = h * (0.3 + 0.2 * o)
            label[((yy - cy) / (h * 0.15)) ** 2
                  + ((xx - cx) / (w * 0.1)) ** 2 < 1] = o + 1
        img = img.copy()
        for o, c in enumerate(((220, 60, 40), (40, 200, 90), (60, 60, 220))):
            img[label == o + 1] = c
        jpg, png, fg = io.BytesIO(), io.BytesIO(), io.BytesIO()
        Image.fromarray(img).save(jpg, 'JPEG', quality=92)
        m = Image.fromarray(label, mode='P')
        m.putpalette(palette)
        m.save(png, 'PNG')
        Image.fromarray((label == 1).astype(np.uint8) * 255).save(fg, 'PNG')
        return jpg.getvalue(), png.getvalue(), fg.getvalue()

    # 16 distinct frames, written under every name (the loaders read files;
    # their content repeating across videos and images does not matter)
    frames = [encoded(t) for t in range(16)]
    st = root / 'static'
    for name in ('DUTS-TE', 'ecssd', 'BIG_small', 'HRSOD_small'):
        (st / name).mkdir(parents=True)
    for i in range(48):
        d = st / 'fss' / f'class{i % 4}' if i < 32 else st / 'DUTS-TR'
        d.mkdir(parents=True, exist_ok=True)
        (d / f'{i}.jpg').write_bytes(frames[i % 16][0])
        (d / f'{i}.png').write_bytes(frames[i % 16][2])
    davis = root / 'DAVIS' / '2017' / 'trainval'
    yv = root / 'YouTube' / 'train_480p'
    videos = [(davis, v, '480p') for v in sorted(load_sub_davis())[:16]] + \
        [(yv, v, '') for v in sorted(load_sub_yv())[:4]]
    for base, vid, sub in videos:
        ims, anns = base / 'JPEGImages' / sub / vid, \
            base / 'Annotations' / sub / vid
        ims.mkdir(parents=True)
        anns.mkdir(parents=True)
        for t, (jpg, png, _) in enumerate(frames):
            (ims / f'{t:05d}.jpg').write_bytes(jpg)
            (anns / f'{t:05d}.png').write_bytes(png)


def _train_cli(args, work: Path, torchrun: bool, timeout: int = 600):
    """python -m xmem2_tpu_torch.train (under torchrun with one process when
    asked) from the work directory; fails with the end of its output."""
    import os
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, '-m', 'xmem2_tpu_torch.train'] + args
    if torchrun:
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node=1', '-m', 'xmem2_tpu_torch.train'] + args
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                         text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f'train CLI failed ({out.returncode}):\n'
                             f'{out.stdout[-3000:]}\n{out.stderr[-5000:]}')
    return seconds, out.stdout


TRAIN_GROUPS = (
    ('NCCL', ('nccl',)),
    ('optimizer (AdamW foreach)', ('multi_tensor_apply',)),
    ('cuDNN convolution backward (dgrad, wgrad)', ('dgrad', 'wgrad')),
    ('cuDNN layout transposes', ('nchwtonhwc', 'nhwctonchw')),
    ('cuDNN convolution forward', ('fprop', 'conv', 'cudnn', 'implicit')),
    ('matrix products (cuBLAS)', ('gemm', 'cublas', 'nvjet', 'cutlass')),
)


def _report_stage(s: dict, card: str, warmup: int = 2) -> dict:
    """Logs one stage of --stats: rates over the steady steps (after the
    warm-up, not the first batch of a fresh loader, neither profiled nor
    right after the profiled window), the phase split, the data wait of
    every step, peak memory, the profile by group and the device's busy
    share of the window. Fails on a non-finite loss."""
    import numpy as np
    losses = np.asarray(s['losses'])
    if not np.isfinite(losses).all():
        raise AssertionError(f'stage {s["stage"]}: non-finite loss {losses}')
    # the step after the profiled window waits for the profiler's own
    # processing of the window, not for data
    skip = set(s['fresh_loader_steps']) | set(s['profiled_steps']) | \
        {max(s['profiled_steps'], default=-2) + 1}
    steady = [i for i in range(warmup, len(losses)) if i not in skip]
    phases = s['phases_ms']
    split = {k: float(np.mean([phases[i][k] for i in steady]))
             for k in ('data', 'forward', 'backward', 'optimizer')}
    step_ms = sum(split.values())
    out = dict(stage=s['stage'], steady=len(steady), step_ms=step_ms,
               steps_per_s=1e3 / step_ms,
               samples_per_s=1e3 / step_ms * s['batch_size'],
               split=split, peak_gb=s['peak_memory_bytes'] / 1e9,
               first_ms=sum(phases[0].values()))
    log(f'[train] stage {s["stage"]} (batch {s["batch_size"]} over '
        f'{s["world_size"]} process, {s["num_frames"]} frames, crop '
        f'{s["crop_size"]}, {"bf16 autocast" if s["amp"] else "f32"}) on '
        f'{card}: {len(losses)} steps, losses {losses[0]:.4f} -> '
        f'{losses[-1]:.4f}, all finite')
    log(f'[train]   over {len(steady)} steady steps: {out["steps_per_s"]:.3f}'
        f' steps/s = {out["samples_per_s"]:.2f} samples/s; ms a step: data '
        f'wait {split["data"]:.1f}, forward {split["forward"]:.1f}, backward '
        f'{split["backward"]:.1f}, optimizer {split["optimizer"]:.1f} (first '
        f'step {out["first_ms"]:.0f} ms); peak memory allocated '
        f'{out["peak_gb"]:.2f} GB')
    log(f'[train]   data wait a step (ms): '
        f'{[round(p["data"]) for p in phases]}; fresh loaders at steps '
        f'{s["fresh_loader_steps"]}, profiled steps {s["profiled_steps"]}')
    prof = s['profile']
    if prof is None:
        return out
    groups = {}
    for key, us, _ in prof['kernels']:
        k = key.lower()
        grp = next((g for g, words in TRAIN_GROUPS
                    if any(w in k for w in words)),
                   'elementwise, reductions, copies')
        groups[grp] = groups.get(grp, 0.0) + us
    total = sum(groups.values())
    if total == 0 or prof['busy_s'] == 0:
        raise AssertionError('the profiler recorded no device time')
    n = len(s['profiled_steps'])
    out['busy'] = prof['busy_s'] / prof['wall_s']
    out['groups_ms'] = {g: us / 1e3 / n for g, us in groups.items()}
    log(f'[train]   profile over steps {s["profiled_steps"]}: wall '
        f'{prof["wall_s"]:.3f} s, device busy {prof["busy_s"]:.3f} s '
        f'({100 * out["busy"]:.1f}% of wall; kernel times summed over '
        f'streams {total / 1e6:.3f} s)')
    for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f'[train]     {grp}: {us / 1e3 / n:.1f} ms a step '
            f'({100 * us / total:.1f}%)')
    top = sorted(prof['kernels'], key=lambda r: -r[1])[:8]
    for key, us, count in top:
        log(f'[train]     top: {us / 1e3 / n:8.1f} ms/step x{count:<5d} '
            f'{key[:90]}')
    return out


def loader_alone(data: Path):
    """The stage-2 loader's rate with nothing else running: seconds a batch
    (8 clips of 8 frames at 384 crops) with one worker process over one
    batch and with the training runs' 8 processes over 8 batches, beside a
    pool of as many threads reading the same samples (the loader's design
    before worker processes); and two runs of the process loader with one
    seed give byte-equal batches."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from xmem2_tpu_torch.train.loader import DataLoader, _stack
    from xmem2_tpu_torch.train.vos_dataset import VOSDataset
    from xmem2_tpu_torch.utils.load_subset import load_sub_davis

    davis = data / 'DAVIS' / '2017' / 'trainval'

    def dataset():
        """The 16 videos four times over (as stage 2 repeats DAVIS): 8
        batches an epoch."""
        return torch.utils.data.ConcatDataset([VOSDataset(
            str(davis / 'JPEGImages' / '480p'),
            str(davis / 'Annotations' / '480p'), 5, is_bl=False,
            subset=load_sub_davis(), num_frames=8, seed=1)] * 4)

    def first(loader, batches):
        """(the first batches, seconds until the last of them came: the
        workers' shutdown, which waits for the batches they prefetch, is
        left out)."""
        t0 = time.perf_counter()
        it = iter(loader)
        out = [next(it) for _ in range(batches)]
        seconds = time.perf_counter() - t0
        it.close()                          # stops the workers
        return out, seconds

    rate = {}
    for workers, batches in ((1, 1), (8, 8)):
        loader = DataLoader(dataset(), 8, shuffle=True, num_workers=workers,
                            seed=1)
        rate['processes', workers] = first(loader, batches)[1] / batches
        ds, idx = dataset(), loader._indices()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda b: _stack([ds[int(i)] for i in
                                            idx[8 * b:8 * b + 8]]),
                          range(batches)))
        rate['threads', workers] = (time.perf_counter() - t0) / batches
    runs = [first(DataLoader(dataset(), 8, shuffle=True, num_workers=8,
                             seed=1), 2)[0] for _ in range(2)]
    same = all(x['info'] == y['info'] and all(
        torch.equal(x[k], y[k]) for k in x if k != 'info')
        for x, y in zip(*runs))
    log(f'[train] stage-2 loader alone ({os.cpu_count()} host cores): '
        f'{rate["processes", 1]:.3f} s a batch with 1 worker process, '
        f'{rate["processes", 8]:.3f} s with 8; a pool of threads reading '
        f'the same samples: {rate["threads", 1]:.3f} s with 1, '
        f'{rate["threads", 8]:.3f} s with 8; two runs of one seed '
        f'{"byte-equal" if same else "DIFFER"} over 2 batches')
    if not same:
        raise AssertionError('the process loader is not deterministic')


def train_phase(work: Path, card: str):
    """Stage 0 (batch 8, 3 frames, single object) in a plain process, then
    stage 2 (batch 8, 8 frames, 3 reference frames, 384 crops, bf16) under
    torchrun with one process (DDP over NCCL), on synthetic 854x480 data;
    each with --stats."""
    import json
    data = work / 'train_data'
    t0 = time.perf_counter()
    synth_training_data(data)
    log(f'[train] synthetic data at 854x480 written in '
        f'{time.perf_counter() - t0:.1f} s')
    loader_alone(data)
    common = ['--num_workers', '8']
    s0_s, _ = _train_cli(
        ['--stages', '0', '--static_root', str(data / 'static'),
         '--s0_batch_size', '8', '--s0_iterations', '8',
         '--stats', str(work / 'stats_s0.json')] + common, work, False)
    s2_s, stdout = _train_cli(
        ['--stages', '2', '--davis_root', str(data / 'DAVIS'),
         '--yv_root', str(data / 'YouTube'), '--s2_batch_size', '8',
         '--s2_iterations', '16', '--s2_finetune', '0',
         '--stats', str(work / 'stats_s2.json')] + common, work, True)
    if 'rank 0 of 1' not in stdout:
        raise AssertionError('stage 2 did not run in a process group')
    log(f'[train] processes: stage 0 {s0_s:.1f} s, stage 2 under torchrun '
        f'{s2_s:.1f} s (start-up and data loading included)')
    out = {}
    for name in ('stats_s0.json', 'stats_s2.json'):
        for s in json.loads((work / name).read_text()):
            out[s['stage']] = _report_stage(s, card)
    return out


def train_check_phase(card: str):
    """One float32 training step (TF32 off) on the card and on the CPU with
    the same weights (the JAX initialisation's draws, tamed as
    tests/test_torch_train.py) and batch (64x64, B = 2, T = 3, two object
    slots with one empty): the loss within 1e-5 relative, every trainable
    gradient leaf within 1e-3 of its largest entry (plus 1e-7 of the
    largest gradient anywhere, the rounding floor of a leaf whose gradient
    is zero in exact arithmetic). Every batch norm of the card's step runs
    the epilogue kernel (kernel.bn_epilogue counts them)."""
    import numpy as np
    import torch
    from xmem2_tpu_torch.bridge.torch_params import build_train_model
    from xmem2_tpu_torch.models.init import init_params
    from xmem2_tpu_torch.train.trainer import sample_draws, train_forward
    from xmem2_tpu_torch.utils.profiling import counters, reset_counters

    sd, dims = init_params(seed=0)
    for name, s in (('key_proj.key_proj', 0.01), ('key_proj.d_proj', 0.01),
                    ('key_proj.e_proj', 0.01), ('decoder.pred', 0.001),
                    ('decoder.hidden_update.transform', 0.01),
                    ('value_encoder.hidden_reinforce.transform', 0.01)):
        sd[name + '.weight'] = sd[name + '.weight'] * np.float32(s)
    rng = np.random.default_rng(9)
    b, t, h, w = 2, 3, 64, 64
    frames = rng.standard_normal((b, t, h, w, 3)).astype(np.float32)
    cls = np.zeros((b, t, h, w), np.int64)
    cls[:, :, 10:40, 12:44] = 1
    ffg = np.zeros((b, 1, 2, h, w), np.float32)
    ffg[:, 0, 0] = cls[:, 0] == 1
    sel = np.array([[1, 0], [1, 0]], np.float32)
    result = {}
    for dev in ('cuda', 'cpu'):
        model = build_train_model(sd, dims, dev)
        ref_idx, deep = sample_draws(torch.Generator().manual_seed(0), b, t,
                                     2, 1.0)

        def on(x):
            return torch.from_numpy(x).to(dev)

        reset_counters()
        losses = train_forward(model, on(frames).permute(0, 1, 4, 2, 3),
                               on(ffg), on(sel), on(cls), ref_idx, deep, 0,
                               10, 20)
        losses['total_loss'].backward()
        if dev == 'cuda':
            bn_launches = counters().get('kernel.bn_epilogue', 0)
        result[dev] = (float(losses['total_loss'].detach()),
                       {n: p.grad.cpu().numpy()
                        for n, p in model.named_parameters()})
    (loss_c, g_c), (loss_h, g_h) = result['cuda'], result['cpu']
    floor = 1e-7 * max(float(np.abs(g).max()) for g in g_h.values())
    worst = max((float(np.abs(g_c[n] - g).max())
                 / (float(np.abs(g).max()) + floor / 1e-3), n)
                for n, g in g_h.items())
    rel = abs(loss_c - loss_h) / abs(loss_h)
    log(f'[train-check] f32 step, card vs CPU: loss {loss_c:.7f} vs '
        f'{loss_h:.7f} (rel {rel:.2e}, limit 1e-5); worst gradient leaf '
        f'{worst[1]} at {worst[0]:.2e} of its scale (limit 1e-3), '
        f'{len(g_h)} leaves, on {card}; batch-norm epilogue launches '
        f'{bn_launches}')
    if not bn_launches:
        raise AssertionError('the training step launched no batch-norm '
                             'epilogue')
    if rel > 1e-5:
        raise AssertionError('card and CPU losses disagree')
    if worst[0] > 1e-3:
        raise AssertionError(f'card and CPU gradients disagree: {worst}')


def syncbn_phase(card: str):
    """nn.functional.batch_norm_train over a one-process NCCL group (world
    size 1, so the group's batch is this batch) on the card against the CPU
    without a group, at a ResNet stem's shape (8 x 64 x 96 x 96): the
    output, the batch statistics and the gradients of input, weight and
    bias within 1e-5 of each one's largest entry."""
    import socket

    import torch
    import torch.distributed as dist
    from xmem2_tpu_torch.nn.functional import batch_norm_train

    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'tcp://localhost:{port}',
                            world_size=1, rank=0)
    try:
        gen = torch.Generator().manual_seed(5)
        x = torch.randn(8, 64, 96, 96, generator=gen) * 2 + 0.5
        weight = torch.rand(64, generator=gen) + 0.5
        bias = torch.randn(64, generator=gen)
        grad = torch.randn(x.shape, generator=gen)
        got = {}
        for dev, group in (('cuda', dist.group.WORLD), ('cpu', None)):
            leaves = [t.to(dev, copy=True).requires_grad_()
                      for t in (x, weight, bias)]
            out, mean, var = batch_norm_train(*leaves, group=group)
            (out * grad.to(dev)).sum().backward()
            got[dev] = [t.detach().cpu() for t in (out, mean, var)] + \
                [t.grad.cpu() for t in leaves]
    finally:
        dist.destroy_process_group()
    names = ('out', 'mean', 'var', 'grad x', 'grad weight', 'grad bias')
    err = {n: float((a - b).abs().max() / b.abs().max())
           for n, a, b in zip(names, got['cuda'], got['cpu'])}
    log(f'[syncbn] batch_norm_train over a one-process NCCL group, 8 x 64 x '
        f'96 x 96 f32, card vs CPU on {card}: '
        + ', '.join(f'{n} {e:.2e}' for n, e in err.items())
        + ' of the largest entry (limit 1e-5)')
    if max(err.values()) > 1e-5:
        raise AssertionError(f'syncbn: card and CPU disagree: {err}')


# ---------------------------------------------------------------------------
# phase 16-17: the interactive layer
# ---------------------------------------------------------------------------

# seeded as they are, HRNet's fusions sum their branches stage after stage
# and its features reach ~1e8: the last batch norm of every residual branch
# and of every fusion is damped x0.1
HRNET_DAMPED = (r'(branches\.\d+\.\d+\.bn2|layer1\.\d+\.bn3|'
                r'fuse_layers\..*\.1)\.weight$')


def synth_interactive_weights(work: Path) -> dict:
    """Seeded S2M (DeepLabV3+ ResNet-50, 6 input channels, output stride 16)
    and f-BRS (ResNet-50-v1s DeepLabV3+, output stride 8; HRNet-18+OCR at
    interactive/fbrs/hrnet.py's default widths) checkpoints at the published
    widths, saved as reference-format .pth files. The last conv of each is
    tamed so the logits are O(1): masks neither empty nor full."""
    import torch
    from xmem2_tpu_torch.interactive.fbrs.hrnet import HRNetModel
    from xmem2_tpu_torch.interactive.fbrs.model import FBRSModel
    from xmem2_tpu_torch.interactive.s2m.network import S2MNet

    paths = {}
    for name, module, seed, last, (scale, bias) in (
            ('s2m', S2MNet(), 2, 'classifier.classifier.3', (1e-2, 2.4)),
            ('fbrs', FBRSModel(), 3, 'head.layers.2', (1e-3, 0.0)),
            ('hrnet', HRNetModel(), 4, 'feature_extractor.cls_head',
             (3.0, -16.5))):
        sd = _synth_weights(module, seed)
        for k in sd:
            if name == 'hrnet' and re.search(HRNET_DAMPED, k):
                sd[k] *= 0.1
        sd[last + '.weight'] *= scale
        sd[last + '.bias'][:] = bias
        paths[name] = work / f'synth_{name}.pth'
        torch.save(sd, paths[name])
    return paths


def _sync(device: str):
    import torch
    if device == 'cuda':
        torch.cuda.synchronize()


def interactive_session(work: Path, tag: str, device: str, dtype: str,
                        h: int, w: int, n: int, profile_click=False,
                        presence: float = 0.25) -> dict:
    """A user's session, headless: the workspace from import_existing (n
    synthetic frames with two objects, both annotated on frame 0) opened by
    ResourceManager; on frame 0 a scribble for each object (S2M), f-BRS-B
    clicks on object 1 (positive, positive, negative; zoom-in engages from
    the second) and an undo, a brush stroke; then save_reference,
    propagate('forward'), full_propagate, compute_candidates(k=5) (frames
    whose masks cover under `presence` percent score 0), update_config and
    memory_stats. Returns what the phases report and
    compare; raises if a mask is missing or a probability is not finite."""
    import numpy as np
    import torch
    from xmem2_tpu_torch import import_existing
    from xmem2_tpu_torch.bridge.torch_params import load_model
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.interactive.fbrs.controller import FBRSController
    from xmem2_tpu_torch.interactive.fbrs.predictor import \
        compute_coord_features
    from xmem2_tpu_torch.interactive.clicks.dist_maps import Click
    from xmem2_tpu_torch.interactive.resource_manager import ResourceManager
    from xmem2_tpu_torch.interactive.s2m import (
        S2MController, load_s2m_state_dict)
    from xmem2_tpu_torch.interactive.session import SessionController
    from xmem2_tpu_torch.utils.profiling import reset_counters

    imgs, anns = synth_video(work / f'{tag}_video', h, w, n, 0)
    with contextlib.chdir(work):
        import_existing.main(['--name', tag, '--size', str(min(h, w)),
                              '--images', str(imgs), '--masks', str(anns)])
    config = dict(VIDEO_INFERENCE_CONFIG, workspace=str(work / 'workspace' /
                                                        tag),
                  size=min(h, w), num_objects=None, compute_dtype=dtype,
                  value_store_dtype=dtype)
    res_man = ResourceManager(config)
    if (len(res_man), res_man.num_objects, res_man.h, res_man.w) != \
            (n, 2, h, w):
        raise AssertionError(f'{tag}: workspace of {len(res_man)} frames, '
                             f'{res_man.num_objects} objects, '
                             f'{res_man.h}x{res_man.w}')
    net = XMemNet(load_model(str(work / 'synth_xmem.pth'), device),
                  compute_dtype=dtype, device=device)
    s2m = S2MController(load_s2m_state_dict(str(work / 'synth_s2m.pth')), 2,
                        compute_dtype=dtype, device=device)
    fbrs = FBRSController(str(work / 'synth_fbrs.pth'), compute_dtype=dtype,
                          device=device)
    ctl = SessionController(InferenceCore(net, config, device=device),
                            res_man, s2m, fbrs, config)
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()

    bad = torch.zeros((), dtype=torch.int64, device=device)
    out = {'s2m': [], 'clicks': [], 'scribble_ms': [], 'click_ms': [],
           'evaluations': []}

    def checked(fn, keep=None):
        def call(*a, **k):
            r = fn(*a, **k)
            if r is not None:
                bad.add_((~torch.isfinite(r)).sum())
                if keep is not None:
                    keep.append(r.float().cpu().numpy())
            return r
        return call

    s2m.interact = checked(s2m.interact, out['s2m'])
    fbrs.interact = checked(fbrs.interact, out['clicks'])
    store = ctl._store_step

    def store_checked(ti, prob, *a, **k):
        bad.add_((~torch.isfinite(prob)).sum())
        return store(ti, prob, *a, **k)

    ctl._store_step = store_checked

    def timed(key, fn):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out[key].append(1e3 * (time.perf_counter() - t0))

    # 1. a scribble for each object on frame 0 (S2M)
    ctl.set_cursor(0)
    for k, pts in ((1, ((0.15, 0.45), (0.2, 0.5), (0.25, 0.55))),
                   (2, ((0.75, 0.3), (0.85, 0.3)))):
        ctl.current_object = k
        for fx, fy in pts:
            ctl.push_point(fx * w, fy * h, False, 'scribble')
        timed('scribble_ms', ctl.end_path)
    ctl.commit()
    # 2. f-BRS-B clicks on object 1, then undo the last
    ctl.current_object = 1
    clicks = ((0.2, 0.5, False), (0.26, 0.56, False), (0.45, 0.5, True))
    for fx, fy, neg in clicks:
        timed('click_ms', lambda: ctl.push_point(fx * w, fy * h, neg,
                                                 'click'))
        out['evaluations'].append(fbrs.last_evaluations)
    undone = fbrs.undo()
    if not np.array_equal(undone.cpu().numpy(), out['clicks'][1]):
        raise AssertionError(f'{tag}: undo did not restore the second click')
    ctl.interaction.obj_mask = undone
    ctl.commit()
    # 3. a brush stroke over object 2, committed
    ctl.set_brush_size(5)
    ctl.current_object = 2
    for fx, fy in ((0.7, 0.25), (0.8, 0.35)):
        ctl.push_point(fx * w, fy * h, False, 'free')
    ctl.commit()
    out['frame0'] = ctl.res_man.get_mask(0).copy()
    # 4-5. reference, propagation, candidates, config, gauges
    if not ctl.save_reference():
        raise AssertionError(f'{tag}: frame 0 has no mask to save')
    reset_counters()
    _sync(device)
    t0 = time.perf_counter()
    done = ctl.propagate('forward')
    _sync(device)
    out['propagate_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    done_full = ctl.full_propagate()
    _sync(device)
    out['full_s'] = time.perf_counter() - t0
    out['launches'] = _kernel_launches()
    if done != n - 1 or done_full != n - 1:
        raise AssertionError(f'{tag}: propagated {done} and {done_full} of '
                             f'{n - 1} frames')
    out['masks'] = np.stack([np.asarray(res_man.get_mask(i))
                             for i in range(n)])
    written = len(list(Path(res_man.mask_dir).glob('*.png')))
    out['candidates'] = ctl.compute_candidates(
        k=5, min_mask_presence_percent=presence)
    ctl.update_config({'top_k': 20, 'mem_every': 5})
    if ctl.processor.memory.top_k != 20 or ctl.processor.mem_every != 5:
        raise AssertionError(f'{tag}: update_config did not reach the core')
    out['stats'] = ctl.memory_stats()
    if device == 'cuda':
        out['peak_bytes'] = torch.cuda.max_memory_allocated()
    # one f-BRS forward on the first click's input, as the check compares
    model = fbrs.controller.model
    image = ctl.image(0).permute(2, 0, 1)[None].float()
    with torch.no_grad():
        coord = compute_coord_features(image, [[Click(True, (0.5 * h,
                                                             0.2 * w))]])
        out['logits'] = model(image, coord).float().cpu().numpy()
    if profile_click:
        out['profile'] = _profile_click(fbrs, ctl.image(0), clicks, w, h)
    if written != n or int(bad.item()) or out['candidates'] is None:
        raise AssertionError(f'{tag}: {written} of {n} masks written, '
                             f'{int(bad.item())} non-finite values, '
                             f'candidates {out["candidates"]}')
    return out


def _profile_click(fbrs, image, clicks, w, h):
    """The second click (zoom-in and L-BFGS) replayed under torch.profiler
    on a fresh anchor: (wall ms, {kernel group: device us}, device us,
    L-BFGS evaluations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fbrs.unanchor()
    fx, fy, neg = clicks[0]
    fbrs.interact(image, fx * w, fy * h, not neg)
    fx, fy, neg = clicks[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fbrs.interact(image, fx * w, fy * h, not neg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, groups, total = _kernel_groups(prof)
    return 1e3 * wall, groups, total, fbrs.last_evaluations


def interactive_phase(work: Path, card: str) -> dict:
    """The session at 854x480, 60 frames, bf16, after a warm-up session of 8
    frames (cuDNN picks its algorithms): ms per scribble and click,
    L-BFGS evaluations, frames/s, launches, peak memory, a click's profile.
    Fails unless K1, K2 and usage launched during the propagation and the
    candidates (every frame admitted) chose a frame."""
    synth_interactive_weights(work)
    interactive_session(work, 'warm', 'cuda', 'bfloat16', 480, 854, 8)
    n = 60
    # the seeded weights propagate near-empty masks at 480p: every frame
    # is admitted to the candidates, as in the select phase
    r = interactive_session(work, 'ws480', 'cuda', 'bfloat16', 480, 854, n,
                            profile_click=True, presence=0.0)
    log(f'[interactive] 854x480, {n} frames, 2 objects, bf16 on {card}:')
    log(f'[interactive]   scribbles (S2M, both objects in one batch): '
        + ', '.join(f'{ms:.2f} ms = {ms / 2:.2f} ms/object'
                    for ms in r['scribble_ms']))
    log(f'[interactive]   f-BRS-B clicks: '
        + ', '.join(f'{ms:.2f} ms ({e} L-BFGS evaluations)'
                    for ms, e in zip(r['click_ms'], r['evaluations'])))
    log(f'[interactive]   propagate forward {n - 1} frames in '
        f'{r["propagate_s"]:.3f} s = {(n - 1) / r["propagate_s"]:.2f} '
        f'frames/s; full propagation {(n - 1) / r["full_s"]:.2f} frames/s; '
        f'launches {r["launches"]}; candidates {r["candidates"]}; peak '
        f'{r["peak_bytes"] / 1e9:.3f} GB allocated; gauges {r["stats"]}')
    wall, groups, total, evals = r['profile']
    log(f'[interactive]   profile of the second click: wall {wall:.2f} ms, '
        f'{evals} evaluations, device busy {total / 1e3:.2f} ms '
        f'({100 * total / 1e3 / wall:.1f}%), idle {wall - total / 1e3:.2f} '
        f'ms')
    for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f'[interactive]     {grp}: {us / 1e3:.2f} ms '
            f'({100 * us / total:.1f}%)')
    _launched('interactive propagation', r['launches'])
    if not any(r['candidates']):
        raise AssertionError(f'interactive: the candidates chose no frame '
                             f'({r["candidates"]})')
    if 'device_bytes_in_use' not in r['stats']:
        raise AssertionError('memory_stats has no device entry on the card')
    return r['launches']


def interactive_check_phase(work: Path, card: str,
                            devices=('cuda', 'cpu')):
    """The session in float32 on a 24-frame 96x160 workspace, on the card
    and on the CPU (plain version of every kernel), compared."""
    import numpy as np

    r = {dev: interactive_session(work, f'check_{dev}', dev, 'float32', 96,
                                  160, 24) for dev in devices}
    a, b = (r[dev] for dev in devices)
    s2m = max(float(np.abs(x - y).max()) for x, y in zip(a['s2m'], b['s2m']))
    logit = float(np.abs(a['logits'] - b['logits']).max()
                  / np.abs(b['logits']).max())
    clicks = [int((x != y).sum()) for x, y in zip(a['clicks'], b['clicks'])]
    frame0 = float((a['frame0'] != b['frame0']).mean())
    masks = float((a['masks'] != b['masks']).mean())
    px = b['clicks'][0].size
    log(f'[interactive-check] f32, 24 frames of 96x160, card vs CPU on '
        f'{card}: S2M probabilities {s2m:.2e} apart (limit 1e-3); f-BRS '
        f'logits {logit:.2e} of their largest (limit 1e-4); click masks '
        f'differ on {clicks} of {px} pixels (limit 1%); frame 0 after the '
        f'tools {100 * frame0:.4f}%, propagated masks {100 * masks:.4f}% of '
        f'pixels differ (limit 0.1%); candidates {a["candidates"]} vs '
        f'{b["candidates"]}; evaluations {a["evaluations"]} vs '
        f'{b["evaluations"]}')
    if s2m > 1e-3 or logit > 1e-4:
        raise AssertionError('card and CPU networks disagree')
    if max(clicks) > 0.01 * px:
        raise AssertionError('card and CPU f-BRS masks disagree')
    if masks > 1e-3:
        raise AssertionError('card and CPU propagated masks disagree')
    if a['candidates'] != b['candidates']:
        raise AssertionError('card and CPU choose other candidates')
    fbrs_modes_check(work, card, devices)


FBRS_MODES = ('NoBRS', 'RGB-BRS', 'DistMap-BRS', 'f-BRS-A', 'f-BRS-B',
              'f-BRS-C')


def _blob_image(h: int, w: int):
    """A normalised [h, w, 3] float32 image: an ellipse on a background,
    with seeded noise."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - h / 2) / (h / 4)) ** 2 + ((xx - w / 3) / (w / 5)) ** 2 < 1
    img = np.where(blob[..., None], np.array([1.5, -0.5, -1.0]),
                   np.array([-0.8, 0.6, 0.4])).astype(np.float32)
    noise = np.random.default_rng(4).standard_normal((h, w, 3))
    return img + 0.1 * noise.astype(np.float32)


def fbrs_modes_check(work: Path, card: str, devices=('cuda', 'cpu')):
    """Two clicks (positive on the object, negative off it) through
    FBRSController with each of the six predictor modes, on both f-BRS
    backbones (ResNet-50 DeepLabV3+ and HRNet-18+OCR), f32 on a 96x160
    image, on the card and on the CPU: masks within 1% of pixels, the same
    L-BFGS evaluation counts. The controller's settings, with the zoom-in
    target at the image's size and at most 4 L-BFGS evaluations a click
    (the GUI's 20 let the two devices' trajectories part on these seeded
    networks: PERF.md section 6)."""
    import torch
    from xmem2_tpu_torch.interactive.fbrs.controller import FBRSController
    from xmem2_tpu_torch.utils.profiling import counters, reset_counters

    h, w = 96, 160
    image = _blob_image(h, w)
    clicks = ((w / 3, h / 2, True), (0.85 * w, 0.2 * h, False))
    # the DeepLab head's bias raised from 0 to 2, so that the first click
    # leaves a sixth of the image foreground: with the sessions' 0.6%, the
    # f-BRS-A/B iterates part between the two devices within 4 evaluations
    sd = torch.load(work / 'synth_fbrs.pth')
    sd['head.layers.2.bias'][:] = 2.0
    torch.save(sd, work / 'synth_fbrs_modes.pth')
    rows = []
    for backbone, ckpt in (('fbrs', 'synth_fbrs_modes.pth'),
                           ('hrnet', 'synth_hrnet.pth')):
        ctls = [FBRSController(str(work / ckpt), compute_dtype='float32',
                               device=dev)
                for dev in devices]
        for mode in FBRS_MODES:
            got = []
            reset_counters()
            for dev, ctl in zip(devices, ctls):
                params = ctl.controller.predictor_params
                ctl.controller.reset_predictor(dict(
                    params, brs_mode=mode, lbfgs_params={'maxfun': 4},
                    zoom_in_params=dict(params['zoom_in_params'],
                                        target_size=h)))
                ctl.unanchor()
                img = torch.from_numpy(image).to(dev)
                masks, evals = [], []
                for x, y, pos in clicks:
                    masks.append(ctl.interact(img, x, y, pos).cpu().numpy())
                    evals.append(ctl.last_evaluations)
                got.append((masks, evals))
            (ma, ea), (mb, eb) = got
            diff = max(float((x != y).mean()) for x, y in zip(ma, mb))
            rows.append((backbone, mode, diff, ea, eb,
                         [float(m.mean()) for m in mb],
                         counters().get('kernel.bn_epilogue', 0)))
    log(f'[interactive-check] six predictor modes x two backbones, two '
        f'clicks each, f32 at 96x160, card vs CPU on {card} (limits: 1% of '
        f'pixels, equal evaluations):')
    for backbone, mode, diff, ea, eb, fg, bn in rows:
        log(f'[interactive-check]   {backbone} {mode}: masks differ on '
            f'{diff:.4%} of pixels, L-BFGS evaluations {ea} vs {eb}, '
            f'foreground after each click '
            + ', '.join(f'{x:.2%}' for x in fg)
            + f'; batch-norm epilogue launches {bn}')
    for backbone, mode, diff, ea, eb, _, bn in rows:
        if diff > 0.01 or ea != eb:
            raise AssertionError(f'{backbone} {mode}: card and CPU clicks '
                                 f'disagree ({diff:.4%}, {ea} vs {eb})')
        if 'cuda' in devices and not bn:
            raise AssertionError(f'{backbone} {mode}: no batch-norm epilogue '
                                 f'launched on the card')


def kernels_json(rows, launches):
    """The kernels line: each kernel at the main path's shape, then at the
    many-object shapes (named with the shape) where the many phase's runs
    launched it. launches: per kernel-row label, the launches of the run
    that label stands for."""
    src = 'xmem2_tpu_torch/ops/csrc/'
    meta = {
        'block_topk_candidates': (src + 'block_topk.cu',
                                  'xmem2_tpu/ops/readout_kernel.py:244'),
        'topk_readout_float32': (src + 'topk_readout.cu',
                                 'xmem2_tpu/ops/readout_kernel.py:53'),
        'topk_readout_bfloat16': (src + 'topk_readout.cu',
                                  'xmem2_tpu/ops/readout_kernel.py:53'),
        'topk_usage': (src + 'topk_readout.cu',
                       'xmem2_tpu/ops/readout_kernel.py:53'),
        'bn_epilogue': (src + 'bn_epilogue.cu',
                        'none (XLA fuses the batch norm, the residual add and '
                        'the ReLU on the TPU)'),
    }
    out = []
    for label, counts in launches.items():
        for name, (source, replaces) in meta.items():
            if not counts.get(name):
                continue
            r = rows[(name, label)]
            out.append({
                'name': name if label == 'P=1620' else
                f'{name} {label.split(" ", 1)[1]}',
                'route': 'cuda', 'source': source, 'replaces': replaces,
                'launches': counts[name], 'shape': r.get('shape', label),
                'timing': r.get('timing', 'CUDA events around calls'),
                'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                'plain_ms': r['plain_ms'], 'bound_ms': r['bound'][0],
                'bound_by': r['bound'][1], 'library_ms': r['library_ms']})
    return {'kernels': out}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--match-from', metavar='DIR',
                    help='only time the whole readout call (match ms) of the '
                         'port checked out under DIR, e.g. a parent commit '
                         'unpacked there with git archive')
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    root = Path(args.match_from or Path(__file__).parent).resolve()
    sys.path.insert(0, str(root))
    import xmem2_tpu_torch  # (fails outside the repository)
    if Path(xmem2_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f'xmem2_tpu_torch imported from '
                           f'{xmem2_tpu_torch.__file__}, not from {root}')
    from xmem2_tpu_torch.config import pin_f32_precision

    pin_f32_precision()
    card = card_line()
    log(f'[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}'
        f', {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')
    if args.match_from:
        log(f'[match] timing the port under {root}')
        match_phase()
        return 0
    build_phase()
    rows = kernel_phase()
    rows['bn_epilogue', 'P=1620'] = bn_epilogue_phase()
    match_phase()
    with tempfile.TemporaryDirectory() as work:
        counts = main_path_phase(Path(work), card)
        profile_phase(Path(work), card)
        augment_phase(Path(work), card)
        profile_phase(Path(work), card, 'augmented',
                      augment_images_with_masks=True)
        select_phase(Path(work), card)
        spill_phase(Path(work), card)
        eval_phase(Path(work), card)
        merge_phase(Path(work), card)
        sharded = shard_phase(Path(work), card)
        many = many_phase(Path(work), card)
        small_check_phase(Path(work))
        train_phase(Path(work), card)
        train_check_phase(card)
        syncbn_phase(card)
        interactive_phase(Path(work), card)
        interactive_check_phase(Path(work), card)

    def by_dtype(default, exact=None):
        return dict(default, topk_readout_bfloat16=default['topk_readout'],
                    topk_readout_float32=exact['topk_readout'] if exact
                    else 0)

    launches = {'P=1620': by_dtype(*counts.values()),
                'P=1620 O=12 G=10': by_dtype(many['12 in 10 default'],
                                             many['12 in 10 exact']),
                'P=1620 O=70 G=3': by_dtype(many['70 in 3 default'])}
    log(f'[shard] launches of the 60-frame runs with 4 shards on one card: '
        f'bf16 {sharded["bf16"]}, f32 {sharded["f32"]}')
    log(f'[done] the whole script in {time.perf_counter() - t_start:.1f} s')
    log(card)
    log(json.dumps(kernels_json(rows, launches)))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
