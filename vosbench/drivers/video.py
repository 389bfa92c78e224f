"""Driver of the video cells: whole videos through run_on_video, the
product's entry, back to back; one call per video, each loading the
checkpoint as process_video users pay it.

Set-up makes the cell's distinct videos and the seeded weights from the
seed, then runs one whole warm-up video. The window runs videos until the
deadline (none starts after it) with the card's operations recorded
(trace.device_window): device_ms_per_frame is the seconds in which an
operation ran on the card over every frame written in the window. With
--trace 1 the same window gives the host's frames/s (every frame written
over the time from the first call's start to the last call's end), and
then one more whole video runs under the profiler, with the ranges that
the cell's metric readers declare and the program's own spans. Then one
finished video, drawn from the seed, is run again by the plain reference
and compared.

A reader's read(trace, run) gets the Trace of the profiled video and the
run's facts: `frames` (written in the profiled video), `window_frames` and
`window_s` (the window's frames and host seconds), `record` (the
reference's record of the checked video: its memory sizes at every readout
and its network's operations, which the cell's fixed schedule makes the
same for every video of the cell), `config` (the cell's configuration) and
`program` (the configuration the program ran with).
"""

import gc
import os
import random
import shutil
import tempfile
import time
import types
from pathlib import Path

from vosbench.harness import trace as T
from vosbench.harness.common import log
from vosbench.harness.videos import palette, write_video
from vosbench.reference import compare, vos, weights


def _program_config(cell, ckpt: str) -> dict:
    cfg = dict(cell.config['inference'])
    cfg.update(cell.config['precision']['program'])
    cfg['model'] = ckpt
    return cfg


def _one_video(run_on_video, video: dict, out: Path, cfg: dict,
               device: str) -> int:
    """One run_on_video call; returns the masks it wrote."""
    run_on_video(video['frames'], video['annotations'], str(out),
                 frames_with_masks=video['annotated'], print_progress=False,
                 save_overlay=False, device=device, overwrite_config=cfg)
    return len(list((out / 'masks').glob('*.png')))


def setup(cell, seed: int, work_dir: Path, device='cuda'):
    """The cell's videos and the seeded, calibrated checkpoint."""
    import torch
    traffic = cell.traffic
    t0 = time.perf_counter()
    videos = [write_video(str(work_dir / f'video{i}'), traffic['video'],
                          [seed, i]) for i in range(traffic['contents'])]
    log(f'{len(videos)} videos written in {time.perf_counter() - t0:.2f} s')
    t0 = time.perf_counter()
    sw = cell.config['seeded_weights']
    ref_cfg = cell.config['inference']
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = weights.make_state_dict(seed, device, sw['residual_scale'],
                                 sw['mask_gain'])
    sd = weights.calibrate(
        sd, weights.video_probe(videos[0]['frames'], videos[0]['annotations'],
                                ref_cfg, device),
        sw['head_mean'], sw['head_std'], sw['similarity_std'],
        sw.get('readout_gain', 1.0))
    ckpt = work_dir / 'xmem_seeded.pth'
    torch.save(sd, ckpt)
    log(f'weights made and calibrated in {time.perf_counter() - t0:.2f} s')
    return videos, str(ckpt)


def run(cell, args, device: dict, process_start: float, dev='cuda'):
    """dev: the torch device; 'cpu' only in the rehearsal tests, which
    run the driver at a tiny size through the program's plain paths."""
    import torch
    from xmem2_tpu_torch.inference.run_on_video import run_on_video

    work_dir = Path(tempfile.mkdtemp(prefix='vosbench-',
                                     dir=os.environ.get('TMPDIR')))
    try:
        videos, ckpt = setup(cell, args.seed, work_dir, dev)
        cfg = _program_config(cell, ckpt)
        n_frames = cell.traffic['video']['frames']
        t = time.perf_counter()
        _one_video(run_on_video, videos[-1], work_dir / 'warm', cfg, dev)
        shutil.rmtree(work_dir / 'warm')
        sync = torch.cuda.synchronize if dev == 'cuda' else (lambda: None)
        sync()
        log(f'warm-up video in {time.perf_counter() - t:.2f} s')
        setup_s = time.perf_counter() - process_start

        outs, written = [], []
        with T.device_window(dev == 'cuda') as card:
            t0 = time.perf_counter()
            deadline = t0 + args.seconds
            ends = []
            while time.perf_counter() < deadline:
                i = len(outs)
                out = work_dir / f'out{i}'
                written.append(_one_video(
                    run_on_video, videos[i % len(videos)], out, cfg, dev))
                outs.append(out)
                ends.append(time.perf_counter() - t0)
            sync()
            t1 = time.perf_counter()
        window_frames = sum(written)
        log('videos ended at (s): ' + ', '.join(f'{e:.2f}' for e in ends))
        log(f'window: {len(outs)} videos, {window_frames} frames in '
            f'{t1 - t0:.2f} s ({window_frames / (t1 - t0):.4f} frames/s); '
            f'card busy {card.busy_s} s over {card.ops} operations '
            f'(CUDA activities {card.kinds})')
        if args.trace:
            readers = cell.readers()
            declared = T.declared_ranges(readers.values())
            path = str(work_dir / 'trace.json')
            with T.ranges(declared), T.window(path):
                out = work_dir / f'out{len(outs)}'
                written.append(_one_video(run_on_video,
                                          videos[len(outs) % len(videos)],
                                          out, cfg, dev))
                outs.append(out)
        peak = torch.cuda.max_memory_allocated() if dev == 'cuda' else 0
        gc.collect()
        if dev == 'cuda':
            torch.cuda.empty_cache()

        log(f'peak {peak} bytes')
        # the check: one finished video drawn from the seed
        pick = random.Random(args.seed).randrange(len(outs))
        video = videos[pick % len(videos)]
        t = time.perf_counter()
        record = vos.run_video(video['frames'], video['annotations'], ckpt,
                               cell.config['inference'], dev, 'f32')
        log(f'reference over video {pick} in {time.perf_counter() - t:.2f} s')
        chk = cell.traffic['check']
        pal = palette(len(cell.traffic['video']['first_frames']))
        bad, diff, _ = compare.confident_mismatch(
            str(outs[pick] / 'masks'), record, pal, chk['margin'])
        failed = sum(1 for w in written if w != n_frames)
        checks = {'confident_mismatch': {'value': bad,
                                         'limit': chk['limit']},
                  'masks_missing': {'value': failed, 'limit': 0}}
        correct = bad <= chk['limit'] and failed == 0
        dev_info = dict(device, memory_peak_bytes=int(peak))
        result = {'correct': bool(correct), 'attempted': len(outs),
                  'failed': failed, 'metrics': {}, 'device': dev_info,
                  'info': {'pixels_differing': diff,
                           'consolidations': record.consolidations}}
        if args.trace:
            t = time.perf_counter()
            tr = T.read(path, declared)
            log(f'trace read in {time.perf_counter() - t:.2f} s')
            facts = types.SimpleNamespace(frames=float(written[-1]),
                                          window_frames=float(window_frames),
                                          window_s=t1 - t0, record=record,
                                          config=cell.config, program=cfg)
            for m in cell.per_layer:
                v = readers[m['name']].read(tr, facts)
                if v is not None:
                    result['metrics'][m['name']] = {'value': v,
                                                    'unit': m['unit']}
            dev_info['busy_s'] = tr.busy_s
            dev_info['window_s'] = tr.window_s
            result['breakdown'] = T.breakdown(tr)
        else:
            values = {'setup_s': setup_s}
            if card.busy_s:
                values['device_ms_per_frame'] = 1e3 * card.busy_s / \
                    window_frames
            for m in cell.end_to_end:
                if m['name'] in values:
                    result['metrics'][m['name']] = {
                        'value': values[m['name']], 'unit': m['unit']}
        return result, checks
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
