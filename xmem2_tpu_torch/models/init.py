"""From-scratch parameter initialization for the XMem architecture.

Counterpart of xmem2_tpu/models/init.py. The draws are built in that
module's layouts (HWIO convs, [in, out] linears) and in its order, then laid
out as a reference state dict by bridge.torch_params.params_from_jax.
Initializers follow the reference: He-normal convs with n = k*k*out_channels
(reference model/resnet.py:130-133), BN scale 1 / shift 0, orthogonal key
projection with zero bias (modules.py:204-205), Xavier-normal GRU transforms
(modules.py:56, 84).
"""

from typing import Dict, Optional, Tuple

import numpy as np

from xmem2_tpu_torch.bridge.torch_params import Dims, params_from_jax


class _Init:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def conv(self, kh, kw, cin, cout, bias=False, scale: Optional[float] = None):
        n = kh * kw * cout
        std = np.sqrt(2.0 / n) if scale is None else scale
        p = {'weight': (self.rng.standard_normal((kh, kw, cin, cout))
                        * std).astype(np.float32)}
        if bias:
            p['bias'] = np.zeros((cout,), np.float32)
        return p

    def conv_xavier(self, kh, kw, cin, cout, bias=True):
        std = np.sqrt(2.0 / (kh * kw * (cin + cout)))
        p = {'weight': (self.rng.standard_normal((kh, kw, cin, cout))
                        * std).astype(np.float32)}
        if bias:
            p['bias'] = np.zeros((cout,), np.float32)
        return p

    def conv_orthogonal(self, kh, kw, cin, cout, bias=True):
        """torch nn.init.orthogonal_: orthonormal rows of the [cout, cin*k*k]
        flattened weight."""
        rows, cols = cout, kh * kw * cin
        a = self.rng.standard_normal((max(rows, cols), min(rows, cols)))
        q, _ = np.linalg.qr(a)          # [max, min], orthonormal columns
        q = q.T if rows < cols else q   # -> [rows, cols]
        w = q[:rows, :cols].reshape(cout, cin, kh, kw)
        p = {'weight': np.transpose(w, (2, 3, 1, 0)).astype(np.float32)}
        if bias:
            p['bias'] = np.zeros((cout,), np.float32)
        return p

    def bn(self, c):
        return {'weight': np.ones((c,), np.float32),
                'bias': np.zeros((c,), np.float32),
                'running_mean': np.zeros((c,), np.float32),
                'running_var': np.ones((c,), np.float32)}

    def linear(self, cin, cout, bias=True):
        bound = 1.0 / np.sqrt(cin)
        p = {'weight': self.rng.uniform(-bound, bound, (cin, cout)).astype(np.float32)}
        if bias:
            p['bias'] = self.rng.uniform(-bound, bound, (cout,)).astype(np.float32)
        return p

    # -- blocks -------------------------------------------------------------
    def basic_block(self, cin, cout, stride=1):
        p = {'conv1': self.conv(3, 3, cin, cout), 'bn1': self.bn(cout),
             'conv2': self.conv(3, 3, cout, cout), 'bn2': self.bn(cout)}
        if stride != 1 or cin != cout:
            p['downsample'] = {'0': self.conv(1, 1, cin, cout),
                               '1': self.bn(cout)}
        return p

    def bottleneck(self, cin, planes, stride=1):
        cout = planes * 4
        p = {'conv1': self.conv(1, 1, cin, planes), 'bn1': self.bn(planes),
             'conv2': self.conv(3, 3, planes, planes), 'bn2': self.bn(planes),
             'conv3': self.conv(1, 1, planes, cout), 'bn3': self.bn(cout)}
        if stride != 1 or cin != cout:
            p['downsample'] = {'0': self.conv(1, 1, cin, cout),
                               '1': self.bn(cout)}
        return p

    def res_layer(self, block, cin, planes, blocks, stride=1):
        expansion = 4 if block == 'bottleneck' else 1
        make = self.bottleneck if block == 'bottleneck' else self.basic_block
        p = {'0': make(cin, planes, stride)}
        cin = planes * expansion
        for i in range(1, blocks):
            p[str(i)] = make(cin, planes)
        return p

    def group_resblock(self, cin, cout):
        p = {'conv1': self.conv(3, 3, cin, cout, bias=True),
             'conv2': self.conv(3, 3, cout, cout, bias=True)}
        if cin != cout:
            p['downsample'] = self.conv(3, 3, cin, cout, bias=True)
        return p

    def cbam(self, c, reduction=16):
        return {
            'ChannelGate': {'mlp': {'1': self.linear(c, c // reduction),
                                    '3': self.linear(c // reduction, c)}},
            'SpatialGate': {'spatial': {'conv': self.conv(7, 7, 2, 1, bias=True)}},
        }

    def feature_fusion(self, x_in, g_in, g_mid, g_out):
        return {'block1': self.group_resblock(x_in + g_in, g_mid),
                'attention': self.cbam(g_mid),
                'block2': self.group_resblock(g_mid, g_out)}

    def gru(self, g_dim, hidden_dim):
        return {'transform': self.conv_xavier(3, 3, g_dim + hidden_dim,
                                              hidden_dim * 3)}


def init_params(key_dim: int = 64, value_dim: int = 512, hidden_dim: int = 64,
                single_object: bool = False, seed: int = 0
                ) -> Tuple[Dict[str, np.ndarray], Dims]:
    """A randomly initialised reference-layout state dict and its dims
    (key_dim, value_dim, hidden_dim), with the reference architecture
    (reference network.py:17-38 constructor + modules.py blocks);
    bridge.torch_params.build_train_model or build_model turns it into a
    module. The draws are those of xmem2_tpu/models/init.py in the same
    order, so a seed gives bit-identical weights."""
    I = _Init(seed)

    key_encoder = {
        'conv1': I.conv(7, 7, 3, 64), 'bn1': I.bn(64),
        'res2': I.res_layer('bottleneck', 64, 64, 3, 1),
        'layer2': I.res_layer('bottleneck', 256, 128, 4, 2),
        'layer3': I.res_layer('bottleneck', 512, 256, 6, 2),
    }

    extra = 1 if single_object else 2
    value_encoder = {
        'conv1': I.conv(7, 7, 3 + extra, 64), 'bn1': I.bn(64),
        'layer1': I.res_layer('basic', 64, 64, 2, 1),
        'layer2': I.res_layer('basic', 64, 128, 2, 2),
        'layer3': I.res_layer('basic', 128, 256, 2, 2),
        'fuser': I.feature_fusion(1024, 256, value_dim, value_dim),
    }
    if hidden_dim > 0:
        value_encoder['hidden_reinforce'] = I.gru(value_dim, hidden_dim)

    key_proj = {
        'key_proj': I.conv_orthogonal(3, 3, 1024, key_dim),
        'd_proj': I.conv(3, 3, 1024, 1, bias=True),
        'e_proj': I.conv(3, 3, 1024, key_dim, bias=True),
    }

    decoder = {
        'fuser': I.feature_fusion(1024, value_dim + hidden_dim, 512, 512),
        'up_16_8': {'skip_conv': I.conv(3, 3, 512, 512, bias=True),
                    'out_conv': I.group_resblock(512, 256)},
        'up_8_4': {'skip_conv': I.conv(3, 3, 256, 256, bias=True),
                   'out_conv': I.group_resblock(256, 256)},
        'pred': I.conv(3, 3, 256, 1, bias=True),
    }
    if hidden_dim > 0:
        decoder['hidden_update'] = {
            'g16_conv': I.conv(1, 1, 512, 256, bias=True),
            'g8_conv': I.conv(1, 1, 256, 256, bias=True),
            'g4_conv': I.conv(1, 1, 256 + 1, 256, bias=True),
            'transform': I.conv_xavier(3, 3, 256 + hidden_dim, hidden_dim * 3),
        }

    tree = {'key_encoder': key_encoder, 'value_encoder': value_encoder,
            'key_proj': key_proj, 'decoder': decoder}
    return params_from_jax(tree)
