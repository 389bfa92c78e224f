"""Host spill tier for the long-term memory.

A copy of xmem2_tpu/memory/spill.py. The reference discards the least-used
long-term elements when the store reaches max_long_term_elements
(kv_memory_store.py:160-181), so on a long video early appearances are gone
for good. With `spill_long_term` the evicted rows are archived in host
memory instead, and `MemoryManager.revive_from_archive` re-uploads the most
relevant of them into free long-term capacity (for instance when
`max_long_term_elements` is raised on a live memory).

Cost model: a spill happens once per long-term overflow and moves only the
evicted rows, in one device-to-host copy; revival is an explicit, rare
host-to-device upload. The steady-state frame loop never touches the host
archive.
"""

from typing import Dict, Optional

import numpy as np


class HostArchive:
    """Append-only store of evicted long-term rows, host-resident."""

    def __init__(self):
        self._chunks = []          # list of dicts of numpy arrays

    def __len__(self) -> int:
        return sum(c['key'].shape[0] for c in self._chunks)

    @property
    def empty(self) -> bool:
        return not self._chunks

    def archive(self, key: np.ndarray, shrinkage: np.ndarray,
                value: np.ndarray, val_valid: np.ndarray,
                usage: np.ndarray):
        """key [n, Ck]; shrinkage [n]; value [O, n, Cv]; val_valid [G, n];
        usage [n] (use/life at eviction time, kept as revival priority)."""
        if key.shape[0] == 0:
            return
        self._chunks.append({
            'key': np.asarray(key), 'shrinkage': np.asarray(shrinkage),
            'value': np.asarray(value), 'val_valid': np.asarray(val_valid),
            'usage': np.asarray(usage),
        })

    def _consolidated(self) -> Optional[Dict[str, np.ndarray]]:
        if not self._chunks:
            return None
        if len(self._chunks) > 1:
            merged = {
                'key': np.concatenate([c['key'] for c in self._chunks], 0),
                'shrinkage': np.concatenate(
                    [c['shrinkage'] for c in self._chunks], 0),
                'value': np.concatenate([c['value'] for c in self._chunks], 1),
                'val_valid': np.concatenate(
                    [c['val_valid'] for c in self._chunks], 1),
                'usage': np.concatenate([c['usage'] for c in self._chunks], 0),
            }
            self._chunks = [merged]
        return self._chunks[0]

    def scores(self, query_key: Optional[np.ndarray]) -> np.ndarray:
        """Relevance of each archived row. With a query key [P, Ck]: the
        shrinkage-scaled anisotropic similarity against the mean query key (a
        cheap host-side proxy for the device readout's scoring); without:
        the archived usage."""
        data = self._consolidated()
        if data is None:
            return np.zeros((0,), np.float32)
        if query_key is None:
            return data['usage']
        q = np.asarray(query_key, np.float32).reshape(-1, data['key'].shape[1])
        qm = q.mean(axis=0)
        d = data['key'] - qm[None, :]
        return -(d * d).sum(axis=1) * data['shrinkage']

    def take_top(self, n: int, query_key: Optional[np.ndarray]):
        """Remove and return the n most relevant rows
        (key, shrinkage, value, val_valid); None when empty."""
        data = self._consolidated()
        if data is None or n <= 0:
            return None
        s = self.scores(query_key)
        n = min(n, s.shape[0])
        top = np.argsort(-s)[:n]
        keep = np.ones(s.shape[0], bool)
        keep[top] = False
        out = (data['key'][top], data['shrinkage'][top],
               data['value'][:, top], data['val_valid'][:, top])
        remaining = {
            'key': data['key'][keep], 'shrinkage': data['shrinkage'][keep],
            'value': data['value'][:, keep],
            'val_valid': data['val_valid'][:, keep],
            'usage': data['usage'][keep],
        }
        self._chunks = [] if remaining['key'].shape[0] == 0 else [remaining]
        return out
