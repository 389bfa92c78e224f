"""The devices a sharded memory bank lives on.

Counterpart of xmem2_tpu/parallel/mesh.py:memory_mesh (:30-39). One process
drives every shard (as one JAX process drives every device of its mesh), so
a shard is a device, not a rank: consolidation and eviction keep a global
view of the bank."""

from typing import List

import torch


def memory_devices(n_shards: int, device) -> List[torch.device]:
    """The first n_shards devices of `device`'s kind: cuda:0 .. cuda:n-1 on
    the card, raising when fewer cards are visible (JAX memory_mesh raises
    alike); on the CPU every shard is the CPU, as the JAX tests place their
    shards on XLA's virtual CPU devices."""
    device = torch.device(device)
    if device.type == 'cpu':
        return [device] * n_shards
    if device.type != 'cuda':
        raise ValueError(f'memory sharding over {device.type} devices is not '
                         f'supported')
    visible = torch.cuda.device_count()
    if visible < n_shards:
        raise ValueError(f'memory_shards={n_shards} but only {visible} CUDA '
                         f'devices are visible (shard_devices places several '
                         f'shards on one card)')
    return [torch.device('cuda', i) for i in range(n_shards)]
