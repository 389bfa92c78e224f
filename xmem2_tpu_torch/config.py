"""Inference configuration defaults, device and precision rules.

VIDEO_INFERENCE_CONFIG has the keys and defaults of xmem2_tpu/config.py
(reference util/configuration.py:138-162), so `overwrite_config` dicts keep
working.
"""

import torch

VIDEO_INFERENCE_CONFIG = {
    'buffer_size': 100,
    'deep_update_every': -1,
    'enable_long_term': True,
    'enable_long_term_count_usage': True,
    'fbrs_model': 'saves/fbrs.pth',
    'hidden_dim': 64,
    'images': None,
    'key_dim': 64,
    'max_long_term_elements': 10000,
    'max_mid_term_frames': 10,
    'mem_every': 10,
    'min_mid_term_frames': 5,
    'model': './saves/XMem.pth',
    'no_amp': False,
    'num_objects': 1,
    'num_prototypes': 128,
    's2m_model': 'saves/s2m.pth',
    'size': 480,
    'top_k': 30,
    'value_dim': 512,
    'masks_out_path': None,
    'workspace': None,
    'save_masks': True,
    # --- extensions of the JAX package (not in the reference) ---
    # Compute dtype of the convolutions: 'auto' is bfloat16 on CUDA (the
    # analog of the reference's autocast) and float32 on the CPU;
    # 'float32' (CLI --exact) for parity runs.
    'compute_dtype': 'auto',
    # Dtype of the memory value banks, same 'auto' rule.
    'value_store_dtype': 'auto',
    # Upload raw uint8 frames and normalise/resize on the device.
    'device_preprocess': True,
    # Run steady-state frames in chunks (InferenceCore.step_chunk).
    'chunk_frames': True,
    # Frames in flight before the oldest packed mask is copied back.
    'pipeline_depth': 4,
    # Capacity (in frames) the permanent-memory buffer grows by.
    'permanent_buffer_frames': 4,
    'max_object_groups': 4,
    # Archive evicted long-term rows in host memory (memory/spill.py).
    'spill_long_term': False,
    # Split every memory store by slot range over this many devices
    # (parallel/); 0 or 1: one device.
    'memory_shards': 0,
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent;
    never falls back to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: pass device="cpu" to run '
                           'the port on the CPU')
    return dev


def resolve_dtype_name(name, device) -> str:
    """'auto' -> 'bfloat16' on CUDA, 'float32' elsewhere (the JAX package's
    rule with CUDA in the TPU's place). Explicit names pass through."""
    name = str(name)
    if name == 'auto':
        return 'bfloat16' if torch.device(device).type == 'cuda' \
            else 'float32'
    if name not in ('float32', 'bfloat16'):
        raise ValueError(f'unknown dtype name {name!r}')
    return name


def torch_dtype(name: str) -> torch.dtype:
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[name]


def pin_f32_precision():
    """float32 work runs in float32: no TF32 in matrix products or cuDNN
    convolutions. The JAX package pins Precision.HIGHEST for the same reason
    (nn/functional.py:19-22, ops/similarity.py:33-35), and the similarity
    feeds a discrete top-k whose membership TF32 rounding would flip. This
    sets process-wide torch flags; the entry points call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
