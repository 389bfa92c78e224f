"""Faults planted in the program under the timed path of a cell of the
video driver (drivers/video.py: run_on_video, XMem's frame step and
memory), which the check has to catch (one card: no exchange between
cards to leave out). Each is a context manager that patches the program
and restores it. A cell of another driver plants its own faults."""

import contextlib

FAULTS = ('state unchanged', 'half the batch', 'answer altered')


@contextlib.contextmanager
def planted(fault: str):
    import torch
    from xmem2_tpu_torch.inference import core
    from xmem2_tpu_torch.inference import run_on_video as R
    from xmem2_tpu_torch.memory import store as ST
    from xmem2_tpu_torch.memory.manager import MemoryManager
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == 'state unchanged':
        # after the annotated frames are preloaded, a frame step leaves the
        # state as it found it: appends to memory return the store
        # unchanged and the hidden state keeps its first value
        append, preload = ST.append, R._preload_permanent_memory
        set_hidden = MemoryManager.set_hidden
        live = {'preloading': False}

        def preloading(*a, **k):
            live['preloading'] = True
            try:
                return preload(*a, **k)
            finally:
                live['preloading'] = False

        def dropped(store, *a, **k):
            return append(store, *a, **k) if live['preloading'] else store

        def frozen(self, hidden):
            if live['preloading'] or self.hidden is None:
                set_hidden(self, hidden)
        patch(R, '_preload_permanent_memory', preloading)
        patch(ST, 'append', dropped)
        patch(MemoryManager, 'set_hidden', frozen)
    elif fault == 'half the batch':
        # the readout of the second half of each call's query rows is lost
        match = MemoryManager.match_query

        def half(self, qk, *a, **k):
            out = match(self, qk, *a, **k)
            out[:, qk.shape[0] // 2:] = 0.0
            return out
        patch(MemoryManager, 'match_query', half)
    elif fault == 'answer altered':
        # where a mask is produced, its top eighth takes the classes in
        # reverse order
        pack = core.prob_to_mask_packed

        def altered(prob, out_hw=None):
            prob = prob.clone()
            rows = prob.shape[1] // 8
            prob[:, :rows] = torch.flip(prob[:, :rows], dims=[0])
            return pack(prob, out_hw)
        patch(core, 'prob_to_mask_packed', altered)
    else:
        raise ValueError(f'unknown fault {fault!r}')
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
