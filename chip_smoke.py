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
              k = 30, two objects in two groups, duplicated keys for ties):
              K2's values, k-th-value counts, merge and the softmax stats
              bit-equal, K1 within tolerance, also in the overflow cases (a
              segment smaller than k, top_k = 300, a key repeated 3,000
              times); each timed with CUDA events beside its plain version,
              a PyTorch yardstick where one call computes the same function,
              and its bound on this card; then `match ms`, one whole
              fused_topk_readout_multi call (three segments, usage on);
  4. main:    `run_on_video` of the port on the card, at the published XMem
              widths with seeded synthetic weights, on a synthetic 854x480
              video of 120 frames with two objects annotated on frames 0 and
              60: once in the default mode (bf16, chunked) and once with
              --exact (f32). Every mask must be written, no probability NaN,
              and every kernel's launch count must rise during the run;
  5. check:   the port on the card against the port on the CPU (plain
              versions of every kernel) on a small f32 video: masks equal.

The second-to-last line of output is the kernels JSON line; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --match-from DIR

times only `match ms` of the port checked out under DIR (for instance a
parent commit unpacked with `git archive`), on the same inputs.
"""

import json
import math
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


def _segments(dev, p, seg_ns=(10128, 17820, 6480), ck=64, cv=512, o=2, g=2,
              seed=0):
    """[long | temp | perm] segments at the main path's widths. perm repeats
    the first slots of temp bit for bit, so the k-th value ties across
    segments (the duplicated-memory regime)."""
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
        valid[1, :n // 3] = False          # a later group lacks old slots
        segs.append([mk, ms, values, valid])
    long_, temp, perm = segs
    temp[3][:, -37:] = False               # invalid ragged tail
    n_perm = perm[0].shape[0]
    perm[0] = temp[0][:n_perm].clone()
    perm[1] = temp[1][:n_perm].clone()
    perm[2] = temp[2][:, :n_perm].clone()
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


def kernel_phase():
    import torch
    from xmem2_tpu_torch.ops import readout_kernel as RK
    from xmem2_tpu_torch.ops.similarity import get_similarity_padded

    dev = torch.device('cuda')
    k, gids = 30, (0, 1)
    rows = {}
    for p in (1620, 9 * 1620):
        qk, qe, segs = _segments(dev, p)
        sims = [get_similarity_padded(mk, ms, qk, qe, p, mk.shape[0])
                for mk, ms, _, _ in segs]
        valids = [s[3] for s in segs]

        # K2: values, k-th counts, merge and stats bit-equal to plain
        stats = _check_k2(RK, sims, valids, k, f'P={p}')
        tau, rmax, invz = stats
        n_ties = sum(int(((s == tau[:, :1]) & v[0]).sum()) for s, v in
                     zip(sims, valids)) - p
        log(f'[kernels] P={p}: K2 values, k-th counts, merge and stats '
            f'bit-equal to plain; {n_ties} slots beyond one per row sit on '
            f'the k-th value')

        # K1: readout (f32 and bf16 values) and usage, per segment
        err = {'topk_readout_float32': 0.0, 'topk_readout_bfloat16': 0.0,
               'topk_usage': 0.0}
        _check_k1(RK, sims, segs, stats, gids, err)
        for sim, (_, _, _, valid) in zip(sims, segs):
            got = RK.topk_usage(sim, valid, tau, rmax, invz)
            want = RK.topk_usage_plain(sim, valid, tau, rmax, invz)
            rel = ((got - want).abs() / want.abs().clamp_min(1e-3)).max()
            err['topk_usage'] = max(err['topk_usage'], rel.item())
        _overflow_cases(RK, qk, qe, sims, segs, gids, err)
        log(f'[kernels] P={p}: max abs err readout f32 '
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

        # timings at the largest segment (temp, N = 17820), one wrapper call
        sim, (_, _, values, valid) = sims[1], segs[1]
        n = sim.shape[1]
        reps = 10 if p == 1620 else 3
        g = valid.shape[0]
        # K2 reads the similarity and validity once and writes k values and
        # one count per (group, row); its yardstick is torch.topk over each
        # group's masked row
        k2_bytes = sim.numel() * 4 + valid.numel() + g * p * (k + 1) * 4
        masked = torch.where(valid[:, None, :], sim[None], -math.inf)
        rows[('block_topk_candidates', p)] = dict(
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
            rows[(name, p)] = dict(
                ms=_time_ms(lambda: RK.topk_readout(
                    sim, v, valid, tau, rmax, invz, gids), reps),
                plain_ms=_time_ms(lambda: RK.topk_readout_plain(
                    sim, v, valid, tau, rmax, invz, gids), reps),
                library_ms=None,
                bound=_bound_ms(nbytes, flops, str(vdt)[6:]),
                max_abs_err=err[name])
        rows[('topk_usage', p)] = dict(
            ms=_time_ms(lambda: RK.topk_usage(sim, valid, tau, rmax, invz),
                        reps),
            plain_ms=_time_ms(lambda: RK.topk_usage_plain(
                sim, valid, tau, rmax, invz), reps),
            library_ms=None,
            bound=_bound_ms(sim.numel() * 4 + valid.numel() + 3 * tau.numel()
                            * 4 + n * 4, 2.0 * keep[0], 'float32'),
            max_abs_err=err['topk_usage'])
        for (name, pp), r in sorted(rows.items()):
            if pp == p:
                log(f'[kernels] P={p} N={n} {name}: {r["ms"]:.4f} ms, plain '
                    f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]}, '
                    f'bound {r["bound"][0]:.4f} ms ({r["bound"][1]})')
        del sims, segs, stats
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4-5: the main path
# ---------------------------------------------------------------------------

def synth_checkpoint(path: Path, seed: int = 0):
    """Seeded synthetic weights at the published XMem widths (key 64, value
    512, hidden 64; ResNet-50 / ResNet-18 encoders), names and shapes from
    the port's own module, conditioned as tests/golden_utils.py (BN near
    identity, He-scaled convs) and with the key/shrinkage projections tamed
    as tests/test_e2e_parity.py:46-47. Saved as a reference-format .pth."""
    import numpy as np
    import torch
    from xmem2_tpu_torch.models.network import XMem

    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in XMem().state_dict().items():
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


def _run(imgs, anns, out, ckpt, device, overwrite, frames=(0, 60)):
    """run_on_video with every probability map checked for NaN on its way
    to the mask packer. Returns (seconds, frames written, non-finite)."""
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
                     overwrite_config=dict(overwrite, model=str(ckpt)))
        if device == 'cuda':
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        core.prob_to_mask_packed = pack
    return seconds, len(list((Path(out) / 'masks').glob('*.png'))), \
        int(bad.item())


def main_path_phase(work: Path, card: str):
    from xmem2_tpu_torch.ops.readout_kernel import LAUNCHES, \
        reset_launch_counts

    ckpt = work / 'synth_xmem.pth'
    synth_checkpoint(ckpt)
    n = 120
    imgs, anns = synth_video(work / 'video480', 480, 854, n, 60)
    exact = {'compute_dtype': 'float32', 'value_store_dtype': 'float32'}
    # warm-up: cuDNN picks its algorithms, kernels load
    _run(imgs, anns, work / 'warm', ckpt, 'cuda', {})
    counts = {}
    for tag, over in (('default (bf16, chunked)', {}), ('exact (f32)', exact)):
        reset_launch_counts()
        seconds, written, bad = _run(imgs, anns, work / tag.split()[0], ckpt,
                                     'cuda', over)
        counts[tag] = dict(LAUNCHES)
        log(f'[main] {tag}: {n} frames at 854x480 in {seconds:.3f} s = '
            f'{n / seconds:.2f} frames/s on {card}; launches {counts[tag]}')
        if written != n:
            raise AssertionError(f'{tag}: {written} of {n} masks written')
        if bad:
            raise AssertionError(f'{tag}: {bad} non-finite probabilities')
        for name, c in counts[tag].items():
            if c == 0:
                raise AssertionError(f'{tag}: kernel {name} never launched')
    return counts


def profile_phase(work: Path, card: str):
    """One default-mode run under torch.profiler: device time by kernel,
    grouped, and the device's busy share of the run's wall time (the
    profiler's own cost is inside that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    imgs, anns = work / 'video480' / 'JPEGImages', work / 'video480' / \
        'Annotations'
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seconds, _, _ = _run(imgs, anns, work / 'prof', work /
                             'synth_xmem.pth', 'cuda', {})
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
        elif any(w in k for w in ('fprop', 'dgrad', 'conv', 'cudnn',
                                  'nchwtonhwc', 'nhwctonchw')):
            grp = 'convolutions (cuDNN, with its layout transposes)'
        elif any(w in k for w in ('gemm', 'cublas', 'cutlass')):
            grp = 'matrix products (cuBLAS)'
        else:
            grp = 'elementwise, reductions, copies'
        groups[grp] = groups.get(grp, 0) + us
    log(f'[profile] default mode, 120 frames at 854x480 on {card}: wall '
        f'{seconds:.3f} s under the profiler, device busy {total / 1e6:.3f} '
        f's ({100 * total / 1e6 / seconds:.1f}% of wall)')
    for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f'[profile]   {grp}: {us / 1e3:.1f} ms ({100 * us / total:.1f}%)'
            f', {us / 1e3 / 120:.3f} ms/frame')
    for us, key, count in dev[:12]:
        log(f'[profile]   top: {us / 1e3:9.1f} ms  x{count:<6d} {key[:90]}')
    host = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    for us, key, count in host[:8]:
        log(f'[profile]   host: {us / 1e3:9.1f} ms  x{count:<6d} {key[:80]}')


def small_check_phase(work: Path):
    """The port on the card against the port on the CPU (plain version of
    every kernel), f32, on a small video: masks equal up to 0.1% of pixels
    (argmax near-ties under another float32 summation order)."""
    import numpy as np
    from PIL import Image

    imgs, anns = synth_video(work / 'video_small', 64, 96, 12, 6)
    over = {'size': -1, 'mem_every': 2, 'max_mid_term_frames': 4,
            'min_mid_term_frames': 2, 'num_prototypes': 16,
            'max_long_term_elements': 24, 'compute_dtype': 'float32',
            'value_store_dtype': 'float32'}
    ckpt = work / 'synth_xmem.pth'
    for dev in ('cuda', 'cpu'):
        _, written, bad = _run(imgs, anns, work / f'small_{dev}', ckpt, dev,
                               over, frames=(0, 6))
        if written != 12 or bad:
            raise AssertionError(f'small video on {dev}: {written} masks, '
                                 f'{bad} non-finite')
    worst = 0.0
    for f in sorted((work / 'small_cpu' / 'masks').glob('*.png')):
        a = np.asarray(Image.open(f).convert('RGB'))
        b = np.asarray(Image.open(work / 'small_cuda' / 'masks' / f.name)
                       .convert('RGB'))
        worst = max(worst, float(np.any(a != b, axis=-1).mean()))
    log(f'[check] card vs CPU masks on the small video: worst frame '
        f'{worst:.4%} of pixels differ (limit 0.1%)')
    if worst > 1e-3:
        raise AssertionError('card and CPU masks disagree')


def kernels_json(rows, launches):
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
    }
    out = []
    for name, (source, replaces) in meta.items():
        r = rows[(name, 1620)]
        out.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces,
            'launches': launches[name],
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
    match_phase()
    with tempfile.TemporaryDirectory() as work:
        counts = main_path_phase(Path(work), card)
        profile_phase(Path(work), card)
        small_check_phase(Path(work))

    default, exact = counts.values()
    launches = dict(default, topk_readout_float32=exact['topk_readout'],
                    topk_readout_bfloat16=default['topk_readout'])
    log(card)
    log(json.dumps(kernels_json(rows, launches)))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
