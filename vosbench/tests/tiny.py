"""Cells of the video driver (drivers/video.py) cut to a tiny size for
rehearsals on the CPU: frames of 96x160, the program and the reference in
float32 on the CPU (the program's plain kernel versions). A cell of
another driver brings its own cut with its rehearsals."""

import types

from vosbench.harness import common


def tiny_cell(name: str, frames: int = 24):
    cell = common.Cell(name)
    v = cell.traffic['video']
    scale = frames / v['frames']
    v.update(height=96, width=160, frames=frames)
    v['annotated'] = sorted({int(a * scale) for a in v['annotated']})
    v['first_frames'] = [min(int(a * scale), v['annotated'][-1])
                         for a in v['first_frames']]
    cfg = cell.config['inference']
    cfg.update(size=-1, mem_every=3, min_mid_term_frames=2,
               max_mid_term_frames=4, num_prototypes=16)
    cell.config['precision']['program'] = {'compute_dtype': 'float32',
                                           'value_store_dtype': 'float32'}
    # 96x160 masks over 24 frames have few pixels that lead by the cell's
    # margin; the rehearsal counts every pixel that leads by 0.05 instead
    # (more pixels, so a stricter comparison) against the cell's limit
    cell.traffic['check']['margin'] = 0.05
    return cell


def args(seed: int, trace: int = 0):
    return types.SimpleNamespace(seed=seed, seconds=0.1, trace=trace)
