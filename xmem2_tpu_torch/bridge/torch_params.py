"""Weights into the port: reference .pth state dicts and the JAX package's
parameter trees and .npz checkpoints.

The port's XMem module carries the reference state-dict names, so a
reference checkpoint needs only two fix-ups, the same as in
xmem2_tpu/bridge/torch_params.py:
  - hyperparameters sniffed from shapes (reference network.py:134-182);
  - single->multi-object surgery: the value encoder's conv1 padded from 4 to
    5 input channels with zeros (reference network.py:184-198).
The JAX package stores conv weights HWIO and linear weights [in, out];
params_from_jax inverts its conversion (OIHW -> HWIO, [out, in] -> [in, out])
and keeps a single-object tree's 4-channel conv1 as it is. Whether a state
dict holds the single-object (stage-0) network is read off that conv1.
"""

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from xmem2_tpu_torch.config import resolve_device
from xmem2_tpu_torch.models.network import XMem

Dims = Tuple[int, int, int]   # key_dim, value_dim, hidden_dim


def sniff_dims(sd: Mapping[str, np.ndarray]) -> Dims:
    """(key_dim, value_dim, hidden_dim) from a reference-layout state dict."""
    key_dim = sd['key_proj.key_proj.weight'].shape[0]
    value_dim = sd['value_encoder.fuser.block2.conv2.weight'].shape[0]
    if 'decoder.hidden_update.transform.weight' in sd:
        hidden_dim = sd['decoder.hidden_update.transform.weight'].shape[0] // 3
    else:
        hidden_dim = 0
    return int(key_dim), int(value_dim), int(hidden_dim)


def convert_state_dict(sd: Mapping[str, np.ndarray],
                       init_as_zero_if_needed: bool = True
                       ) -> Tuple[Dict[str, np.ndarray], Dims]:
    """A reference-format state dict (numpy arrays) made loadable into XMem:
    num_batches_tracked dropped, conv1 padded 4 -> 5 channels. Returns the
    new dict and the sniffed dims."""
    sd = {k: np.asarray(v) for k, v in sd.items()
          if not k.endswith('num_batches_tracked')}
    ve_conv1 = sd['value_encoder.conv1.weight']
    if ve_conv1.shape[1] == 4:
        pads = np.zeros((ve_conv1.shape[0], 1) + ve_conv1.shape[2:],
                        ve_conv1.dtype)
        if not init_as_zero_if_needed:
            pads = np.random.default_rng(0).standard_normal(
                pads.shape).astype(ve_conv1.dtype)
        sd['value_encoder.conv1.weight'] = np.concatenate([ve_conv1, pads], 1)
    return sd, sniff_dims(sd)


def _flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f'{prefix}.{k}' if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def tree_to_state_dict(tree) -> Dict[str, np.ndarray]:
    """A JAX package parameter tree (nested dict of numpy arrays, HWIO convs,
    [in, out] linears; or an already flat {dotted name: array} dict) ->
    the reference-layout state dict: names joined with dots, OIHW convs,
    [out, in] linears. It serves the XMem tree and the interactive models'
    (load_s2m_params, xmem2_tpu/interactive/s2m/network.py:106-125;
    load_fbrs_params, xmem2_tpu/interactive/fbrs/model.py:194-217, DeepLabV3+
    or HRNet+OCR), whose state dicts S2MNet and the f-BRS models load
    strictly: the f-BRS ASPP pooling branch's 'gap' level is a level of the
    reference's names (aspp.concurent.4.gap.1), so joining the keys restores
    it."""
    flat = _flatten(tree)
    bn_prefixes = {k.rsplit('.', 1)[0] for k in flat
                   if k.endswith('running_mean')}
    sd = {}
    for name, a in flat.items():
        prefix, leaf = name.rsplit('.', 1)
        if leaf == 'weight' and a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))          # HWIO -> OIHW
        elif leaf == 'weight' and a.ndim == 2 and prefix not in bn_prefixes:
            a = np.transpose(a, (1, 0))                # [in,out] -> [out,in]
        sd[name] = np.ascontiguousarray(a)
    return sd


def params_from_jax(tree) -> Tuple[Dict[str, np.ndarray], Dims]:
    """The JAX package's parameter tree -> (reference-layout state dict,
    dims). `tree` is the nested dict of numpy arrays (XMemParams.tree, or an
    object with a `.tree`), or an already flat {dotted name: array} dict as
    stored in the JAX .npz format."""
    sd = tree_to_state_dict(getattr(tree, 'tree', tree))
    return sd, sniff_dims(sd)


def load_params_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dims]:
    """A checkpoint in the JAX package's .npz format (save_params,
    xmem2_tpu/bridge/torch_params.py:96-114)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith('__meta.')}
    return params_from_jax(flat)


def load_state_dict_file(path: str) -> Tuple[Dict[str, np.ndarray], Dims]:
    """A .npz (JAX format) or reference .pth checkpoint, by extension."""
    if str(path).endswith('.npz'):
        return load_params_npz(path)
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return convert_state_dict({k: v.detach().cpu().numpy()
                               for k, v in sd.items()})


def _module(sd: Mapping[str, np.ndarray], dims: Dims, device,
            copy: bool) -> XMem:
    """An XMem module holding the state dict (float32) on `device`: CUDA
    unless the caller passes another (config.resolve_device). The module is
    built on the meta device and takes the checkpoint's tensors: no random
    initialisation to overwrite (0.5 s for the ResNet-50/18 encoders).
    Without `copy`, tensors on the CPU share memory with `sd`."""
    device = resolve_device(device)
    # the stage-0 network: a value-encoder conv1 over 3 + 1 channels
    single_object = sd['value_encoder.conv1.weight'].shape[1] == 4
    with torch.device('meta'):
        model = XMem(*dims, single_object=single_object)
    tensor = torch.tensor if copy else torch.from_numpy
    model.load_state_dict({k: tensor(np.require(v, np.float32, ['W']))
                           for k, v in sd.items()}, assign=True)
    return model.to(device)


def build_model(sd: Mapping[str, np.ndarray], dims: Dims,
                device=None) -> XMem:
    """An inference XMem module: frozen, in eval mode."""
    return _module(sd, dims, device, copy=False).eval().requires_grad_(False)


def build_train_model(sd: Mapping[str, np.ndarray], dims: Dims,
                      device=None) -> XMem:
    """A training XMem module holding a copy of the state dict: every
    parameter trainable, the batch-norm running statistics frozen buffers
    (BatchNorm2d always normalises with them, as the reference's trainer
    does under .eval())."""
    return _module(sd, dims, device, copy=True).requires_grad_(True)


def state_dict_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A module's reference-layout state dict as float32 numpy arrays on
    the host."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def save_network(model: torch.nn.Module, path: str):
    """The weights as a reference-format .pth, read by load_model here and
    by the JAX package's load_any."""
    torch.save({k: torch.from_numpy(v)
                for k, v in state_dict_numpy(model).items()}, path)


def load_model(path: str, device=None) -> XMem:
    """A .npz or .pth checkpoint as an XMem module on `device` (CUDA
    unless the caller passes another)."""
    device = resolve_device(device)
    sd, dims = load_state_dict_file(path)
    return build_model(sd, dims, device)
