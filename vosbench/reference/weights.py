"""Seeded XMem weights at the published widths, made on the device.

The tensor names and shapes are XMem's checkpoint format (github.com/
hkchengrex/XMem model/network.py), listed here from the architecture, so
neither side of the comparison supplies them. The values come from one
torch.Generator on the device in one draw, conditioned as a trained
network's statistics would be (batch-norm scales near 1, He-scaled
convolutions, small last scales on residual branches), then calibrated on
the video (`calibrate`) so that the masks depend on memory and are neither
saturated nor ties. The benchmark writes the
result once as a .pth file that the program and the reference both read.
"""

from typing import List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]


def _bn(name: str, c: int) -> Spec:
    return [(f'{name}.{k}', (c,)) for k in
            ('weight', 'bias', 'running_mean', 'running_var')]


def _conv(name: str, cout: int, cin: int, k: int, bias: bool = True) -> Spec:
    out = [(f'{name}.weight', (cout, cin, k, k))]
    return out + ([(f'{name}.bias', (cout,))] if bias else [])


def _resnet(pre: str, cin: int, stages, bottleneck: bool) -> Spec:
    spec = _conv(pre + 'conv1', 64, cin, 7, False) + _bn(pre + 'bn1', 64)
    c = 64
    for name, planes, blocks, stride in stages:
        for i in range(blocks):
            b = f'{pre}{name}.{i}'
            s = stride if i == 0 else 1
            if bottleneck:
                out = planes * 4
                spec += (_conv(b + '.conv1', planes, c, 1, False)
                         + _bn(b + '.bn1', planes)
                         + _conv(b + '.conv2', planes, planes, 3, False)
                         + _bn(b + '.bn2', planes)
                         + _conv(b + '.conv3', out, planes, 1, False)
                         + _bn(b + '.bn3', out))
            else:
                out = planes
                spec += (_conv(b + '.conv1', planes, c, 3, False)
                         + _bn(b + '.bn1', planes)
                         + _conv(b + '.conv2', planes, planes, 3, False)
                         + _bn(b + '.bn2', planes))
            if s != 1 or c != out:
                spec += (_conv(b + '.downsample.0', out, c, 1, False)
                         + _bn(b + '.downsample.1', out))
            c = out
    return spec


def _res_block(pre: str, cin: int, cout: int) -> Spec:
    spec = _conv(pre + '.downsample', cout, cin, 3) if cin != cout else []
    return spec + _conv(pre + '.conv1', cout, cin, 3) \
        + _conv(pre + '.conv2', cout, cout, 3)


def _fusion(pre: str, x_in: int, g_in: int, mid: int, out: int) -> Spec:
    a = pre + '.attention'
    return (_res_block(pre + '.block1', x_in + g_in, mid)
            + [(f'{a}.ChannelGate.mlp.1.weight', (mid // 16, mid)),
               (f'{a}.ChannelGate.mlp.1.bias', (mid // 16,)),
               (f'{a}.ChannelGate.mlp.3.weight', (mid, mid // 16)),
               (f'{a}.ChannelGate.mlp.3.bias', (mid,))]
            + _conv(f'{a}.SpatialGate.spatial.conv', 1, 2, 7)
            + _res_block(pre + '.block2', mid, out))


def xmem_spec(key_dim: int = 64, value_dim: int = 512,
              hidden_dim: int = 64) -> Spec:
    """(name, shape) of every tensor of an XMem checkpoint."""
    spec = _resnet('key_encoder.', 3, [('res2', 64, 3, 1),
                                       ('layer2', 128, 4, 2),
                                       ('layer3', 256, 6, 2)], True)
    spec += (_conv('key_proj.key_proj', key_dim, 1024, 3)
             + _conv('key_proj.d_proj', 1, 1024, 3)
             + _conv('key_proj.e_proj', key_dim, 1024, 3))
    spec += _resnet('value_encoder.', 5, [('layer1', 64, 2, 1),
                                          ('layer2', 128, 2, 2),
                                          ('layer3', 256, 2, 2)], False)
    spec += _fusion('value_encoder.fuser', 1024, 256, value_dim, value_dim)
    spec += _conv('value_encoder.hidden_reinforce.transform', 3 * hidden_dim,
                  value_dim + hidden_dim, 3)
    spec += _fusion('decoder.fuser', 1024, value_dim + hidden_dim, 512, 512)
    hu = 'decoder.hidden_update.'
    spec += (_conv(hu + 'g16_conv', 256, 512, 1)
             + _conv(hu + 'g8_conv', 256, 256, 1)
             + _conv(hu + 'g4_conv', 256, 257, 1)
             + _conv(hu + 'transform', 3 * hidden_dim, 256 + hidden_dim, 3))
    spec += (_conv('decoder.up_16_8.skip_conv', 512, 512, 3)
             + _res_block('decoder.up_16_8.out_conv', 512, 256)
             + _conv('decoder.up_8_4.skip_conv', 256, 256, 3)
             + _res_block('decoder.up_8_4.out_conv', 256, 256)
             + _conv('decoder.pred', 1, 256, 3))
    return spec


def make_state_dict(seed: int, device, residual_scale: float = 1.0,
                    mask_gain: float = 1.0, spec: Spec = None) -> dict:
    """Seeded float32 weights for `spec` (default: XMem at the published
    widths) from one draw on `device`, returned on the CPU.
    residual_scale: the last batch-norm scale of every residual branch
    (bn3 of a bottleneck, bn2 of a basic block) is multiplied by it, as
    trained ResNets keep those small, so activations do not double with
    every block. mask_gain: the value encoder's first convolution weighs
    the mask and the other objects' masks by it against the frame, so that
    memory values depend on the masks. The shrinkage projection is damped
    (shrinkage near 1)."""
    spec = spec or xmem_spec()
    total = sum(_numel(s) for _, s in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    sd, at = {}, 0
    for name, shape in spec:
        n = _numel(shape)
        a = flat[at:at + n].view(shape)
        at += n
        if name.endswith('running_var'):
            a = (1.0 + 0.2 * a).abs() + 0.1
        elif name.endswith('running_mean') or name.endswith('bias'):
            a = 0.2 * a
        elif name.endswith('weight') and a.dim() == 1:
            a = 1.0 + 0.2 * a
        elif name.endswith('weight') and a.dim() == 4:
            a = a * (2.0 / _numel(shape[1:])) ** 0.5
        elif name.endswith('weight') and a.dim() == 2:
            a = a / shape[1] ** 0.5
        if name == 'key_proj.d_proj.weight':
            a = a * 0.01
        elif name.endswith(('.bn3.weight', '.bn3.bias')) or (
                name.startswith('value_encoder.layer')
                and name.endswith(('.bn2.weight', '.bn2.bias'))):
            a = a * residual_scale
        elif name == 'value_encoder.conv1.weight':
            a = torch.cat([a[:, :3], a[:, 3:] * mask_gain], dim=1)
        sd[name] = a
    return {k: v.cpu() for k, v in sd.items()}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def calibrate(sd: dict, probe, mean: float, std: float, sim_std: float,
              readout_gain: float = 1.0) -> dict:
    """Seeded weights made to behave as a trained network's do on the
    cell's own inputs, from four short reference passes (`probe(sd)` runs
    one and returns the network, whose last_* features it leaves readable,
    and the spread of the similarities it read; each change rescales a
    linear map, so the network keeps its form):
      0. the key projection gives similarities of the given spread, so the
         softmax selects among slots;
      1. the value encoder's fuser weighs the frame features (f16) as much
         as the mask-dependent trunk features, so memory values carry the
         masks;
      2. the decoder's fuser weighs the memory readout readout_gain times
         as much as f16, so the masks depend on memory;
      3. the mask head's logits get the given mean and spread, so masks are
         neither saturated (one object everywhere, no margin, no gradient)
         nor ties."""
    out = dict(sd)
    _, spread = probe(out)
    out['key_proj.key_proj.weight'] = out['key_proj.key_proj.weight'] * (
        sim_std / spread) ** 0.5

    def rescale_f16(block, ratio):
        for conv in ('conv1', 'downsample'):
            w = out[f'{block}.{conv}.weight'].clone()
            w[:, :1024] *= ratio
            out[f'{block}.{conv}.weight'] = w

    net, _ = probe(out)
    rescale_f16('value_encoder.fuser.block1',
                float(net.last_trunk.std() / net.last_f16.std()))
    net, _ = probe(out)
    rescale_f16('decoder.fuser.block1',
                float(net.last_readout.std() / net.last_f16.std())
                / readout_gain)
    net, _ = probe(out)
    logits = net.last_logits.float().cpu()
    a = std / float(logits.std().clamp_min(1e-12))
    out['decoder.pred.weight'] = sd['decoder.pred.weight'] * a
    out['decoder.pred.bias'] = a * (sd['decoder.pred.bias']
                                    - float(logits.mean())) + mean
    return out


def video_probe(frames_dir: str, ann_dir: str, cfg: dict, device):
    """A probe for `calibrate`: the inference reference over a video up to
    its first propagated (not annotated) frame."""
    import os
    from vosbench.reference.vos import run_video
    anns = {f[:-4] for f in os.listdir(ann_dir)}
    upto = 1 + next(t for t, f in enumerate(sorted(os.listdir(frames_dir)))
                    if f[:-4] not in anns)

    def probe(sd):
        rec = run_video(frames_dir, ann_dir, sd, cfg, device, frames=upto)
        return rec.net, rec.sim_std
    return probe
