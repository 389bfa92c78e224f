"""xmem2_tpu_torch: the PyTorch/CUDA port of xmem2_tpu.

Video object segmentation with permanent, working and long-term memory
(XMem++), run on an NVIDIA GPU. The memory readout runs through two
hand-written CUDA kernels (ops/csrc/); everything else is PyTorch. Module
names follow xmem2_tpu/, which stays the reference the port is tested
against. This package imports neither JAX nor anything of xmem2_tpu.
"""
