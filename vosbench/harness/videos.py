"""Seeded synthetic videos in the DAVIS layout: JPEG frames and palette
PNG annotations, drawn from a cell's traffic parameters.

Each object is a textured ellipse that drifts across a textured background;
an annotated frame carries every object present on it (exhaustive, as
XMem++ users and YouTube-VOS annotate). Positions, sizes, motion and
textures come from the seed; the frame count, the size, the objects and
the annotated frames come from the traffic file, so every seed gives the
same work.
"""

import os
from typing import Dict, List

import numpy as np
from PIL import Image


def palette(objects: int) -> List[int]:
    """Index 0 black, then distinct saturated colours (the annotation
    palette, which the written masks take)."""
    out = [0, 0, 0]
    for o in range(objects):
        hue = (o * 0.618034) % 1.0
        rgb = _hsv(hue, 0.9, 0.95 - 0.3 * (o // 8 % 2))
        out += [int(round(255 * c)) for c in rgb]
    return out + [0] * (768 - len(out))


def _hsv(h, s, v):
    i = int(h * 6) % 6
    f = h * 6 - int(h * 6)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
            (v, p, q)][i]


def write_video(root: str, traffic: Dict, seed: int) -> Dict:
    """Writes root/JPEGImages/frame_%06d.jpg and root/Annotations/*.png.
    traffic: frames, height, width, first_frames (the frame on which each
    object appears), annotated (frames with a mask). Returns the paths and
    the annotated frames."""
    rng = np.random.default_rng(seed)
    n, h, w = traffic['frames'], traffic['height'], traffic['width']
    first = list(traffic['first_frames'])
    annotated = sorted(traffic['annotated'])
    objs = len(first)
    imgs, anns = os.path.join(root, 'JPEGImages'), os.path.join(root,
                                                                'Annotations')
    os.makedirs(imgs, exist_ok=True)
    os.makedirs(anns, exist_ok=True)
    pal = palette(objs)
    cols = min(objs, 4)
    rows = -(-objs // cols)
    bg = rng.integers(0, 255, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
    bg = np.asarray(Image.fromarray(bg).resize((w, h), Image.BILINEAR))
    tex = rng.integers(0, 255, (objs, h // 24 + 1, w // 24 + 1, 3)) \
        .astype(np.uint8)
    tex = [np.asarray(Image.fromarray(t).resize((w, h), Image.BILINEAR))
           for t in tex]
    cy0 = (np.arange(objs) // cols + 0.5 + rng.uniform(-0.2, 0.2, objs)) \
        * h / rows
    cx0 = (np.arange(objs) % cols + 0.5 + rng.uniform(-0.2, 0.2, objs)) \
        * w / cols
    ry = rng.uniform(0.25, 0.4, objs) * h / rows
    rx = rng.uniform(0.25, 0.4, objs) * w / cols
    vy = rng.uniform(-0.3, 0.3, objs) * ry / n * 4
    vx = rng.uniform(-0.5, 0.5, objs) * rx / n * 4
    noise = rng.integers(-10, 11, (4, h, w, 3), dtype=np.int16)
    colours = [np.asarray(pal[3 * (o + 1):3 * (o + 2)], np.float32)
               for o in range(objs)]
    # appearance drift: the background pans and every object's colour
    # turns, so that frames far from an annotation look unlike it and the
    # working memory of recent frames matters
    drift = float(traffic.get('drift', 0.0))
    for t in range(n):
        label = np.zeros((h, w), np.uint8)
        for o in range(objs):
            if t < first[o]:
                continue
            cy, cx = cy0[o] + vy[o] * t, cx0[o] + vx[o] * t
            y0, y1 = max(int(cy - ry[o]) - 1, 0), min(int(cy + ry[o]) + 2, h)
            x0, x1 = max(int(cx - rx[o]) - 1, 0), min(int(cx + rx[o]) + 2, w)
            yy = np.arange(y0, y1, dtype=np.float32)[:, None]
            xx = np.arange(x0, x1, dtype=np.float32)[None, :]
            inside = ((yy - cy) / ry[o]) ** 2 + ((xx - cx) / rx[o]) ** 2 < 1
            label[y0:y1, x0:x1][inside] = o + 1
        shift = int(round(drift * 0.5 * w * t / n))
        frame = np.roll(bg, shift, axis=1) if shift else bg.copy()
        turn = drift * t / n
        for o in range(objs):
            m = label == o + 1
            c = colours[o] * (1 - turn) + colours[o][::-1] * turn
            frame[m] = (0.6 * tex[o][m] + 0.4 * c).astype(np.uint8)
        frame = np.clip(frame + noise[t % 4], 0, 255).astype(np.uint8)
        Image.fromarray(frame).save(os.path.join(imgs, f'frame_{t:06d}.jpg'),
                                    quality=90)
        if t in annotated:
            m = Image.fromarray(label, mode='P')
            m.putpalette(pal)
            m.save(os.path.join(anns, f'frame_{t:06d}.png'))
    return {'frames': imgs, 'annotations': anns, 'annotated': annotated,
            'count': n}
