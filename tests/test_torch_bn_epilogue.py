"""The batch-norm epilogue (xmem2_tpu_torch/ops/bn_epilogue.py): its plain
version against the composition the trunks ran before it, the trunks and the
interactive networks against copies of their old forwards, training's
gradients (the plain version's, and the autograd Function's backward around
the kernel), the NCHW order of every batch norm's input, and, on the card,
the CUDA kernel against the plain version.

Imports nothing of JAX, so the card's tests run on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_bn_epilogue.py
"""

import pytest
import torch

from xmem2_tpu_torch.models import resnet as R
from xmem2_tpu_torch.ops import bn_epilogue as BE
from xmem2_tpu_torch.ops.bn_epilogue import (
    bn_epilogue, bn_epilogue_plain, vector_width)
from xmem2_tpu_torch.utils.profiling import counters, reset_counters

DTYPES = (torch.bfloat16, torch.float32)
# the trunks' planes at 480p (480x864 after padding) and a ragged one
PLANES = ((240, 432), (120, 216), (60, 108), (30, 54), (7, 13))


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, at run
    time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card: the kernel runs only on the card')
    return torch.cuda.get_device_name(0)


def _bn_vectors(c, gen, device='cpu'):
    """weight, bias, running mean, running var for c channels: signs of
    both kinds, variances from 0.01 to ~2."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(device)
    return (1.0 + 0.5 * rnd(c), 0.3 * rnd(c), 0.3 * rnd(c),
            0.01 + rnd(c).abs())


def _seeded(module, seed=0):
    """Seeded weights conditioned as chip_smoke.py's (batch norm near
    identity, He-scaled convolutions)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in module.state_dict().items():
        a = torch.randn(t.shape, generator=gen)
        if name.endswith('running_var'):
            a = (1.0 + 0.2 * a).abs() + 0.1
        elif name.endswith(('running_mean', 'bias')):
            a = 0.2 * a
        elif name.endswith('weight') and a.dim() == 1:
            a = 1.0 + 0.2 * a
        elif name.endswith('weight') and a.dim() == 4:
            a = a * (2.0 / a[0].numel()) ** 0.5
        elif name.endswith('weight') and a.dim() == 2:
            a = a / a.shape[1] ** 0.5
        sd[name] = a
    module.load_state_dict(sd)
    return module


# ---------------------------------------------------------------------------
# the composition before the epilogue, and the forwards that ran it
# ---------------------------------------------------------------------------

def old_batch_norm(x, weight, bias, mean, var, eps=1e-5):
    dt = x.dtype
    scale = weight.float() * torch.rsqrt(var.float() + eps)
    shift = bias.float() - mean.float() * scale
    return (x.float() * scale[:, None, None] + shift[:, None, None]).to(dt)


def old_bn_forward(self, x, residual=None, relu=False):
    out = old_batch_norm(x, self.weight, self.bias, self.running_mean,
                         self.running_var)
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


def old_basic_forward(self, x):
    out = torch.relu(self.bn1(self.conv1(x)))
    out = self.bn2(self.conv2(out))
    residual = x if self.downsample is None else self.downsample(x)
    return torch.relu(out + residual)


def old_bottleneck_forward(self, x):
    out = torch.relu(self.bn1(self.conv1(x)))
    out = torch.relu(self.bn2(self.conv2(out)))
    out = self.bn3(self.conv3(out))
    residual = x if self.downsample is None else self.downsample(x)
    return torch.relu(out + residual)


def old_stem(self, x):
    from xmem2_tpu_torch.nn import functional as XF
    return XF.max_pool(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)


def _old_forwards(monkeypatch):
    monkeypatch.setattr(R.BatchNorm2d, 'forward', old_bn_forward)
    monkeypatch.setattr(R.BasicBlock, 'forward', old_basic_forward)
    monkeypatch.setattr(R.Bottleneck, 'forward', old_bottleneck_forward)
    monkeypatch.setattr(R.Stem, 'stem', old_stem)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return a is None and b is None or torch.equal(a, b)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_plain_equals_the_old_composition():
    gen = torch.Generator().manual_seed(0)
    shape = (2, 3, 7, 13)
    x = (3 * torch.randn(shape, generator=gen)).bfloat16()
    res = torch.randn(shape, generator=gen).bfloat16()
    vecs = _bn_vectors(shape[1], gen)
    want = torch.relu(old_batch_norm(x, *vecs) + res)
    for fn in (bn_epilogue, bn_epilogue_plain):
        got = fn(x, *vecs, res, True)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _operands(shape, dtype, residual, seed):
    gen = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=gen)).to(dtype)
    res = torch.randn(shape, generator=gen).to(dtype) if residual else None
    return x, res, _bn_vectors(shape[1], gen), \
        torch.randn(shape, generator=gen).to(dtype)


def _grads(fn, x, res, vecs, weight_grad, relu, upstream):
    """Gradients of (fn(...) * upstream).sum() as a training step (weight
    and bias requiring grad) or as f-BRS's refinement (x alone) takes
    them: x's, the residual's, then weight's and bias's."""
    x = x.clone().requires_grad_(True)
    res = None if res is None else res.clone().requires_grad_(True)
    w, b, m, v = (t.clone() for t in vecs)
    w.requires_grad_(weight_grad)
    b.requires_grad_(weight_grad)
    out = fn(x, w, b, m, v, res, relu)
    (out.float() * upstream.float()).sum().backward()
    return out.detach(), [x.grad, None if res is None else res.grad,
                          w.grad, b.grad]


@pytest.mark.parametrize('weight_grad', [True, False])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('residual,relu', [(False, False), (False, True),
                                           (True, True), (True, False)])
@pytest.mark.parametrize('shape', [(2, 3, 7, 13), (1, 5, 1, 1)])
def test_function_gradients_equal_the_plain_versions(
        shape, residual, relu, dtype, weight_grad, monkeypatch):
    """The autograd Function that wraps the kernel, with the plain version
    in the kernel's place (the kernel equals it bit for bit on the card):
    its backward gives the plain version's gradients bit for bit."""
    def plain_launch(x, params, residual, relu, eps):
        return bn_epilogue_plain(x, *params, residual, relu, eps)

    monkeypatch.setattr(BE, '_launch', plain_launch)
    x, res, vecs, upstream = _operands(shape, dtype, residual, sum(shape))

    def function(x, w, b, m, v, r, relu):
        return BE._BNEpilogue.apply(x, w, b, m, v, r, relu, BE.EPS)

    out, got = _grads(function, x, res, vecs, weight_grad, relu, upstream)
    want_out, want = _grads(bn_epilogue_plain, x, res, vecs, weight_grad,
                            relu, upstream)
    assert torch.equal(out, want_out)
    assert got[2] is not None or not weight_grad
    assert _equal(got, want)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('trunk', ['resnet50', 'resnet18'])
def test_trunks_equal_their_old_forwards(trunk, dtype, monkeypatch):
    model = _seeded(R.ResNet50Trunk() if trunk == 'resnet50'
                    else R.ResNet18Trunk(5))
    R.cast_weights(model, dtype)
    x = torch.randn(2, 3 if trunk == 'resnet50' else 5, 48, 80,
                    generator=torch.Generator().manual_seed(1))
    run = model if trunk == 'resnet50' else model.trunk
    with torch.no_grad():
        new = run(x)
        _old_forwards(monkeypatch)
        old = run(x)
    assert _equal(new, old)


def _interactive_nets():
    from xmem2_tpu_torch.interactive.fbrs.hrnet import HRNetModel
    from xmem2_tpu_torch.interactive.fbrs.model import FBRSModel
    from xmem2_tpu_torch.interactive.s2m.network import S2MNet
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(1, 3, 64, 64, generator=gen)
    maps = torch.rand(1, 2, 64, 64, generator=gen)
    return {
        's2m': (S2MNet(stem=8, base=8, ch=16, low_ch=8),
                (torch.randn(1, 6, 64, 64, generator=gen),)),
        'fbrs-deeplab': (FBRSModel(stem=8, base=8, ch=16, skip=8),
                         (img, maps)),
        'fbrs-hrnet': (HRNetModel(width=4, ocr_width=8, small=True),
                       (img, maps)),
    }


@pytest.mark.parametrize('name', ['s2m', 'fbrs-deeplab', 'fbrs-hrnet'])
def test_interactive_networks_equal_their_old_forwards(name, monkeypatch):
    net, args = _interactive_nets()[name]
    net = _seeded(net).eval().requires_grad_(False)
    with torch.no_grad():
        new = net(*args)
        _old_forwards(monkeypatch)
        old = net(*args)
    assert _equal(new, old)


@pytest.mark.parametrize('block', ['bottleneck', 'basic'])
def test_training_gradients_equal_the_old_forwards(block, monkeypatch):
    """Parameters and input requiring grad, grad mode on: the same
    gradients as the old forwards, through the plain version."""
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn(2, 16, 12, 10, generator=gen)
    w = torch.randn(2, 32 if block == 'bottleneck' else 8, 6, 5,
                    generator=gen)

    def grads():
        m = _seeded(R.Bottleneck(16, 8, stride=2) if block == 'bottleneck'
                    else R.BasicBlock(16, 8, stride=2))
        x = x0.clone().requires_grad_(True)
        (m(x) * w).sum().backward()
        return [x.grad] + [p.grad for p in m.parameters()]

    new = grads()
    _old_forwards(monkeypatch)
    old = grads()
    assert all(g is not None for g in new) and _equal(new, old)


def test_vector_width_follows_plane_and_alignment():
    buf = torch.empty(4096, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    assert vector_width(103680, 2, buf) == 8
    assert vector_width(1620, 2, buf) == 4
    assert vector_width(1620, 4, buf.view(torch.float32)) == 4
    assert vector_width(7 * 13, 2, buf) == 1
    assert vector_width(6480, 2, buf, buf[4:]) == 4
    assert vector_width(6480, 2, buf[1:]) == 1


def _recording_nchw(monkeypatch):
    """Every batch norm's x and residual, contiguous in NCHW order or not,
    recorded as the plain version runs them (the kernel takes NCHW
    alone; a convolution over a channels-last view returns channels-last
    activations, on the CPU as with cuDNN)."""
    seen = []

    def recorded(x, weight, bias, mean, var, residual=None, relu=False):
        seen.append(x.is_contiguous() and (residual is None
                                           or residual.is_contiguous()))
        return bn_epilogue_plain(x, weight, bias, mean, var, residual, relu)

    monkeypatch.setattr(R, 'bn_epilogue', recorded)
    return seen


@pytest.mark.parametrize('name', ['s2m', 'fbrs-deeplab', 'fbrs-hrnet'])
def test_interactive_networks_hand_batch_norms_nchw(name, monkeypatch):
    net, args = _interactive_nets()[name]
    net = _seeded(net).eval().requires_grad_(False)
    # f-BRS's image and its flip, as the predictor runs them
    args = tuple(torch.cat([a, a.flip(-1)]) for a in args)
    seen = _recording_nchw(monkeypatch)
    net(*args)
    assert seen and all(seen)


def test_training_step_hands_batch_norms_nchw(monkeypatch):
    """train_forward on frames permuted from [B, T, H, W, 3] data, as the
    trainer passes them."""
    import numpy as np
    from xmem2_tpu_torch.bridge.torch_params import build_train_model
    from xmem2_tpu_torch.models.init import init_params
    from xmem2_tpu_torch.train.trainer import sample_draws, train_forward

    sd, dims = init_params(seed=0)
    model = build_train_model(sd, dims, 'cpu')
    rng = np.random.default_rng(0)
    b, t, h, w = 1, 3, 32, 32
    frames = torch.from_numpy(
        rng.standard_normal((b, t, h, w, 3)).astype(np.float32))
    cls = torch.zeros((b, t, h, w), dtype=torch.int64)
    cls[:, :, 8:24, 8:24] = 1
    ffg = torch.zeros((b, 1, 2, h, w))
    ffg[:, 0, 0] = (cls[:, 0] == 1).float()
    sel = torch.tensor([[1.0, 0.0]])
    ref_idx, deep = sample_draws(torch.Generator().manual_seed(0), b, t, 2,
                                 1.0)
    seen = _recording_nchw(monkeypatch)
    losses = train_forward(model, frames.permute(0, 1, 4, 2, 3), ffg, sel,
                           cls, ref_idx, deep, 0, 10, 20)
    losses['total_loss'].backward()
    assert seen and all(seen)


def test_cpu_calls_count_nothing():
    reset_counters()
    x = torch.randn(1, 2, 3, 3)
    bn_epilogue(x, *_bn_vectors(2, torch.Generator().manual_seed(0)),
                relu=True)
    assert counters() == {}


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('hw', PLANES)
def test_kernel_equals_plain(card, hw, dtype):
    gen = torch.Generator().manual_seed(hw[0])
    c = 16
    calls = 0
    reset_counters()
    for n in (1, 9):
        shape = (n, c) + hw
        x = (3 * torch.randn(shape, generator=gen)).to(dtype).cuda()
        res = torch.randn(shape, generator=gen).to(dtype).cuda()
        vecs = _bn_vectors(c, gen, 'cuda')
        # a contiguous view one element off the allocation's alignment
        shifted = torch.empty(x.numel() + 1, dtype=dtype,
                              device='cuda')[1:].view(shape)
        shifted.copy_(x)
        for xin in (x, shifted):
            for r in (None, res):
                for relu in (False, True):
                    got = bn_epilogue(xin, *vecs, r, relu)
                    want = bn_epilogue_plain(xin, *vecs, r, relu)
                    calls += 1
                    assert got.dtype == dtype and torch.equal(got, want), \
                        (shape, dtype, r is not None, relu)
    torch.cuda.synchronize()
    assert counters() == {'kernel.bn_epilogue': calls}


@pytest.mark.card
def test_hrnet_ocr_equal_with_kernel_and_plain(card, monkeypatch):
    """f-BRS's HRNet-18+OCR in f32 on the card, on a batch of two (an image
    and its flip, as the predictor runs it), whose OCR block transposes its
    context before 1x1 convolutions: every batch norm gets NCHW input from
    cuDNN, and the kernel equals the plain version."""
    from xmem2_tpu_torch.config import pin_f32_precision
    from xmem2_tpu_torch.interactive.fbrs.hrnet import HRNetModel
    pin_f32_precision()
    net = _seeded(HRNetModel()).cuda().eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(6)
    args = (torch.randn(2, 3, 96, 160, generator=gen).cuda(),
            torch.rand(2, 2, 96, 160, generator=gen).cuda())
    seen = []

    def recorded(x, *a):
        seen.append(x.is_contiguous())
        return bn_epilogue(x, *a)

    monkeypatch.setattr(R, 'bn_epilogue', recorded)
    with torch.no_grad():
        kernel = net(*args)
        monkeypatch.setattr(R, 'bn_epilogue', bn_epilogue_plain)
        plain = net(*args)
    assert seen and all(seen) and torch.equal(kernel, plain)


@pytest.mark.card
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_xmemnet_equal_with_kernel_and_plain(card, dtype, monkeypatch):
    """encode_key and encode_value at 480p (480x864 after padding), two
    objects: the kernel against the plain version forced in its place."""
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.models.network import XMem

    net = XMemNet(_seeded(XMem()), dtype, device='cuda')
    gen = torch.Generator().manual_seed(4)
    frame = torch.randn(1, 3, 480, 864, generator=gen).cuda()
    masks = torch.rand(1, 2, 480, 864, generator=gen).cuda()

    def run():
        key = net.encode_key(frame)
        return key, net.encode_value(frame, key[3], None, masks)

    reset_counters()
    kernel = run()
    # every batch norm: 43 in ResNet-50's conv1..layer3, 15 in ResNet-18's
    assert counters() == {'kernel.bn_epilogue': 43 + 15}
    monkeypatch.setattr(R, 'bn_epilogue', bn_epilogue_plain)
    plain = run()
    assert _equal(kernel, plain)


@pytest.mark.card
def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 6, 8, generator=gen).cuda()
    vecs = _bn_vectors(4, gen, 'cuda')
    with pytest.raises(ValueError, match='x must be contiguous'):
        bn_epilogue(x.transpose(2, 3), *vecs)
    with pytest.raises(ValueError, match='x must be contiguous'):
        bn_epilogue(x.to(memory_format=torch.channels_last), *vecs)
    with pytest.raises(ValueError, match='residual must be contiguous'):
        bn_epilogue(x, *vecs, x.to(memory_format=torch.channels_last))
    mean = vecs[2].clone().requires_grad_(True)
    with pytest.raises(ValueError, match='running statistics'):
        bn_epilogue(x, vecs[0], vecs[1], mean, vecs[3])
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match='dtype'):
            bn_epilogue(x.to(bad), *vecs)
    with pytest.raises(TypeError, match='residual'):
        bn_epilogue(x, *vecs, x.bfloat16())
    with pytest.raises(ValueError, match='shape'):
        bn_epilogue(x, *vecs, x[:1].contiguous())
    with pytest.raises(ValueError, match='batch-norm vectors'):
        bn_epilogue(x[:, :3].contiguous(), *vecs)
    with pytest.raises(ValueError, match='is on cpu'):
        bn_epilogue(x, *(v.cpu() for v in vecs))


@pytest.mark.card
@pytest.mark.parametrize('autocast', [False, True])
@pytest.mark.parametrize('block', ['bottleneck', 'basic'])
def test_training_gradients_on_the_card_equal_plain(card, block, autocast,
                                                    monkeypatch):
    """A training step's block on the card (parameters and input requiring
    grad; f32, and bf16 under autocast as the trainer runs it): every batch
    norm launches the kernel, and the output and every gradient equal the
    plain version's bit for bit. cuDNN is held to deterministic algorithms:
    its convolutions' backward may otherwise give x another gradient from
    one run to the next, the plain version's included."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    monkeypatch.setattr(torch.backends.cudnn, 'benchmark', False)
    gen = torch.Generator().manual_seed(7)
    x0 = torch.randn(2, 16, 24, 20, generator=gen).cuda()
    m0 = _seeded(R.Bottleneck(16, 8, stride=2) if block == 'bottleneck'
                 else R.BasicBlock(16, 8, stride=2)).cuda()
    upstream = torch.randn(m0(x0).shape, generator=gen).cuda()

    def step():
        m = _seeded(R.Bottleneck(16, 8, stride=2) if block == 'bottleneck'
                    else R.BasicBlock(16, 8, stride=2)).cuda()
        x = x0.clone().requires_grad_(True)
        with torch.autocast('cuda', dtype=torch.bfloat16, enabled=autocast):
            out = m(x)
        (out.float() * upstream).sum().backward()
        return [out.detach(), x.grad] + [p.grad for p in m.parameters()]

    reset_counters()
    kernel = step()
    launched = counters().get('kernel.bn_epilogue')
    monkeypatch.setattr(R, 'bn_epilogue', bn_epilogue_plain)
    plain = step()
    assert launched == (4 if block == 'bottleneck' else 3)
    assert kernel[0].dtype == (torch.bfloat16 if autocast else torch.float32)
    assert all(g is not None for g in kernel) and _equal(kernel, plain)


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
def test_input_gradients_on_the_card_equal_plain(card, dtype):
    """f-BRS's refinement: frozen batch norm, gradients through x and the
    residual alone, every (residual, ReLU) case and a ragged plane."""
    for shape in ((2, 16, 30, 54), (1, 5, 7, 13)):
        for residual in (False, True):
            for relu in (False, True):
                x, res, vecs, up = _operands(shape, dtype, residual, 8)
                x, up = x.cuda(), up.cuda()
                res = None if res is None else res.cuda()
                vecs = tuple(v.cuda() for v in vecs)
                reset_counters()
                got = _grads(bn_epilogue, x, res, vecs, False, relu, up)
                assert counters() == {'kernel.bn_epilogue': 1}
                want = _grads(bn_epilogue_plain, x, res, vecs, False, relu,
                              up)
                assert _equal(got, want), (shape, residual, relu)
