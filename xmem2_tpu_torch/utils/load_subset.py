"""Training-video whitelists: a copy of xmem2_tpu/utils/load_subset.py
(reference util/load_subset.py). The .txt lists are data files carried over
verbatim: the DAVIS train split and the curated YouTubeVOS subset."""

from pathlib import Path

_DATA = Path(__file__).parent / 'data'


def _load(name):
    with open(_DATA / name) as f:
        return set(line.strip() for line in f if line.strip())


def load_sub_davis(path=None):
    return _load('davis_subset.txt') if path is None else \
        set(line.strip() for line in open(path))


def load_sub_yv(path=None):
    return _load('yv_subset.txt') if path is None else \
        set(line.strip() for line in open(path))
