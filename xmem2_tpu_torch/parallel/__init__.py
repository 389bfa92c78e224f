"""Memory-bank sharding over several devices (config `memory_shards`).

Counterpart of xmem2_tpu/parallel/: `mesh.memory_devices` picks the shards'
devices, `sharded_readout` computes the exact top-k readout over banks whose
slots are split across them."""
