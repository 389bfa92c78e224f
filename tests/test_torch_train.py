"""The port's training math against xmem2_tpu.train: init_params, the dense
read_memory, the losses, train_forward's loss and gradients, one AdamW step,
the learning-rate schedule, DDP against one process, and the two places the
JAX trainer departs from the reference (ROADMAP.md Queue 3).

Weights come from the JAX init_params through params_from_jax. At the He
initialisation the network is saturated: the shrinkage d^2 + 1 reaches 1e6,
the decoder's logits clamp in the soft aggregation, the GRU and selection
gates saturate. So the gradient tests tame the key, shrinkage and selection
projections, the prediction head and the two GRU transforms by the same
factors on both sides (TAME). Even so a ReLU network's gradient is piecewise
constant in its inputs: a relative change of 1e-6 in the frames moves some
leaves' gradients by ~1e-2 of their largest entry at this size (a kink or a
max-pool choice flips, and one position is a sizable share of a 4 x 4
feature map). Most input seeds differ between the two packages by such a
flip somewhere; the seeds below give none here, and then every leaf agrees
to ~1e-5 of its largest entry.
"""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xmem2_tpu.models import network as XN
from xmem2_tpu.models.init import init_params as jax_init_params
from xmem2_tpu.train import losses as JL
from xmem2_tpu.train import trainer as JT
from xmem2_tpu_torch.bridge.torch_params import build_train_model, \
    convert_state_dict, params_from_jax
from xmem2_tpu_torch.models.init import init_params
from xmem2_tpu_torch.models.network import XMem
from xmem2_tpu_torch.train import losses as TL
from xmem2_tpu_torch.train.trainer import XMemTrainer, sample_draws, \
    train_forward

REPO = Path(__file__).resolve().parents[1]
B, T, H, W = 2, 3, 64, 64
START_WARM, END_WARM = 10, 20
TAME = {'key_proj.key_proj': 0.01, 'key_proj.d_proj': 0.01,
        'key_proj.e_proj': 0.01, 'decoder.pred': 0.001,
        'decoder.hidden_update.transform': 0.01,
        'value_encoder.hidden_reinforce.transform': 0.01}
# input seeds without a kink flip between the packages (module docstring)
INPUT_SEED = {False: 9, True: 1}
CONFIG = {'num_frames': T, 'num_ref_frames': 2, 'deep_update_prob': 1.0,
          'hidden_dim': 64, 'start_warm': START_WARM, 'end_warm': END_WARM,
          'lr': 1e-4, 'weight_decay': 0.05, 'steps': [3, 5], 'gamma': 0.1,
          'amp': False}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """torch on one thread while this module runs (the suite's workers
    otherwise spin against each other's intra-op threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch(single_object: bool, seed: int):
    """Frames, frame-0 one-hot masks, selector and class maps; two object
    slots with the second empty (one slot for the single-object shape)."""
    rng = np.random.default_rng(seed)
    o = 1 if single_object else 2
    frames = rng.standard_normal((B, T, H, W, 3)).astype(np.float32)
    cls = np.zeros((B, T, H, W), np.int32)
    cls[:, :, 10:40, 12:44] = 1
    ffg = np.zeros((B, 1, o, H, W), np.float32)
    ffg[:, 0, 0] = cls[:, 0] == 1
    sel = np.zeros((B, o), np.float32)
    sel[:, 0] = 1
    return {'rgb': frames, 'first_frame_gt': ffg, 'selector': sel,
            'cls_gt': cls}


def tamed_jax_params(single_object: bool):
    p = jax_init_params(seed=0, single_object=single_object)
    for path, s in TAME.items():
        node = p.tree
        for k in path.split('.'):
            node = node[k]
        node['weight'] = node['weight'] * np.float32(s)
    return p


def jax_loss_and_grads(p, data):
    fwd = partial(JT.train_forward, num_frames=T, num_ref_frames=2,
                  deep_update_prob=1.0, hidden_dim=64,
                  start_warm=START_WARM, end_warm=END_WARM)

    def loss_fn(tree):
        return fwd(XN.XMemParams(tree, p.key_dim, p.value_dim, p.hidden_dim,
                                 p.single_object),
                   data['rgb'], data['first_frame_gt'], data['selector'],
                   data['cls_gt'], jax.random.PRNGKey(0), jnp.int32(0))

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        p.tree)
    return float(loss), jax.device_get(grads)


def port_loss_and_grads(sd, dims, data):
    model = build_train_model(sd, dims, 'cpu')
    ref_idx, deep = sample_draws(torch.Generator().manual_seed(0), B, T, 2,
                                 1.0)
    losses = train_forward(
        model, torch.from_numpy(data['rgb']).permute(0, 1, 4, 2, 3),
        torch.from_numpy(data['first_frame_gt']),
        torch.from_numpy(data['selector']),
        torch.from_numpy(data['cls_gt']).long(), ref_idx, deep, 0,
        START_WARM, END_WARM)
    losses['total_loss'].backward()
    return float(losses['total_loss'].detach()), {
        n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.fixture(scope='module')
def ref():
    """The JAX references, computed once: both shapes' tamed weights, loss
    and gradients."""
    out = {}
    for single in (False, True):
        p = tamed_jax_params(single)
        data = batch(single, INPUT_SEED[single])
        sd, dims = params_from_jax(p)
        loss, grads = jax_loss_and_grads(p, data)
        out[single] = dict(jparams=p, sd=sd, dims=dims, data=data,
                           loss=loss, grad_tree=grads,
                           grads=params_from_jax(grads)[0])
    return out


@pytest.mark.parametrize('single_object', [False, True])
def test_init_params_bit_equal(single_object):
    sd, dims = init_params(seed=5, single_object=single_object)
    want, want_dims = params_from_jax(jax_init_params(
        seed=5, single_object=single_object))
    assert dims == want_dims == (64, 512, 64)
    assert set(sd) == set(want) == set(XMem(
        single_object=single_object).state_dict())
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    assert sd['value_encoder.conv1.weight'].shape[1] == (
        4 if single_object else 5)


def test_read_memory():
    rng = np.random.default_rng(3)
    b, o, t, ck, cv, h, w = 2, 3, 4, 16, 24, 5, 6
    qk = rng.standard_normal((b, h, w, ck)).astype(np.float32)
    qe = rng.uniform(0, 1, (b, h, w, ck)).astype(np.float32)
    mk = rng.standard_normal((b, t, h, w, ck)).astype(np.float32)
    ms = rng.uniform(1, 3, (b, t, h, w)).astype(np.float32)
    mv = rng.standard_normal((b, o, t, h, w, cv)).astype(np.float32)
    want = np.asarray(XN.read_memory(None, qk, qe, mk, ms, mv))
    got = XMem.read_memory(
        torch.from_numpy(qk).permute(0, 3, 1, 2),
        torch.from_numpy(qe).permute(0, 3, 1, 2),
        torch.from_numpy(mk).permute(0, 1, 4, 2, 3),
        torch.from_numpy(ms)[:, :, None],
        torch.from_numpy(mv).permute(0, 1, 2, 5, 3, 4))
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('it', [0, 14, 25])   # plain CE, warming, warm
def test_losses(it):
    rng = np.random.default_rng(it)
    b, o, t, h, w = 2, 3, 4, 12, 16
    logits = [rng.standard_normal((b, o + 1, h, w)).astype(np.float32) * 3
              for _ in range(t - 1)]
    masks = [rng.uniform(0, 1, (b, o, h, w)).astype(np.float32)
             for _ in range(t - 1)]
    cls = rng.integers(0, o + 1, (b, t, h, w)).astype(np.int32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    cls[1][cls[1] == 2] = 0
    cls[0][cls[0] == 3] = 0
    want = JL.compute_losses([jnp.asarray(x) for x in logits],
                             [jnp.asarray(x) for x in masks],
                             jnp.asarray(cls), jnp.asarray(valid),
                             jnp.int32(it), START_WARM, END_WARM)
    got = TL.compute_losses([torch.from_numpy(x) for x in logits],
                            [torch.from_numpy(x) for x in masks],
                            torch.from_numpy(cls).long(),
                            torch.from_numpy(valid), it, START_WARM,
                            END_WARM)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize('single_object', [False, True])
def test_train_forward_loss_and_gradients(ref, single_object):
    """Loss to 1e-5 relative, every trainable leaf's gradient to 1e-3 of its
    largest entry. key_proj.key_proj.bias has a zero gradient in exact
    arithmetic (the bias cancels in mk - qk), so every leaf is also allowed
    1e-7 of the largest gradient anywhere (rounding noise)."""
    r = ref[single_object]
    want_loss, want = r['loss'], r['grads']
    loss, grads = port_loss_and_grads(r['sd'], r['dims'], r['data'])
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(grads) == {k for k in want if 'running_' not in k}
    floor = 1e-7 * max(float(np.abs(g).max()) for g in want.values())
    for name, g in grads.items():
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(g - want[name]).max())
        assert err <= 1e-3 * scale + floor, (name, err, scale)


def test_adamw_step_and_frozen_statistics(ref):
    """The trainer's AdamW, fed the JAX gradients, moves every trainable
    parameter as optax.adamw does (the running statistics excluded). The
    JAX step also moves the batch-norm running statistics (they are leaves
    of its parameter tree, read without stop_gradient, and its optimizer
    has no mask: xmem2_tpu/models/init.py:52-56, nn/functional.py:70-72,
    train/trainer.py:39-43); the port's stay as they were."""
    r = ref[False]
    trainer = XMemTrainer(CONFIG, r['sd'], r['dims'], device='cpu')
    for n, p in trainer.model.named_parameters():
        p.grad = torch.from_numpy(r['grads'][n].copy())
    trainer.optimizer.step()

    opt = JT.make_optimizer(CONFIG)
    tree = r['jparams'].tree
    updates, _ = opt.update(r['grad_tree'], opt.init(tree), tree)
    stepped = params_from_jax(optax.apply_updates(tree, updates))[0]

    state = {k: v.detach().numpy() for k, v in
             trainer.model.state_dict().items()}
    for name in stepped:
        if 'running_' in name:
            np.testing.assert_array_equal(state[name], r['sd'][name])
            continue
        np.testing.assert_allclose(state[name], stepped[name], rtol=1e-6,
                                   atol=1e-9, err_msg=name)
    var = 'key_encoder.bn1.running_var'
    assert np.abs(stepped[var] - r['sd'][var]).max() > 1e-6


def test_lr_schedule_matches_optax():
    """MultiStepLR as the trainer steps it against optax's
    piecewise_constant_schedule at the counts around each boundary: the
    rate changes when the count reaches a boundary."""
    sd, dims = convert_state_dict({k: v.numpy() for k, v in
                                   XMem(8, 16, 4).state_dict().items()})
    trainer = XMemTrainer(CONFIG, sd, dims, device='cpu')
    sched = JT.make_lr_schedule(CONFIG['lr'], CONFIG['steps'],
                                CONFIG['gamma'])
    for count in range(8):
        got = trainer.optimizer.param_groups[0]['lr']
        np.testing.assert_allclose(got, float(sched(jnp.int32(count))),
                                   rtol=1e-6, err_msg=str(count))
        trainer.optimizer.step()
        trainer.scheduler.step()


def test_stage_handoff_pads_like_the_reference():
    """The JAX CLI hands stage 0's single-object parameters to stage 2 as
    they are (train.py:117-120, 254): its trainer keeps a 4-channel value
    conv1 and single_object=True. The port pads the handoff as the reference
    does: 5 channels, the first 4 stage 0's, the fifth zero."""
    p0 = jax_init_params(seed=1, single_object=True)
    jtrainer = JT.XMemTrainer(dict(CONFIG), p0)
    kept = jtrainer.state.params           # what train.py:254 hands over
    assert kept.single_object
    assert kept.tree['value_encoder']['conv1']['weight'].shape[2] == 4

    sd0, dims = params_from_jax(p0)
    t0 = XMemTrainer(dict(CONFIG, amp=False), sd0, dims, device='cpu')
    assert t0.model.single_object
    handed = t0.network_state()
    sd2, _ = convert_state_dict(handed)
    w = sd2['value_encoder.conv1.weight']
    assert w.shape[1] == 5
    np.testing.assert_array_equal(w[:, :4],
                                  handed['value_encoder.conv1.weight'])
    assert not w[:, 4].any()
    t2 = XMemTrainer(CONFIG, sd2, dims, device='cpu')
    assert not t2.model.single_object
    # load_network_in_memory pads in the same way
    t2.load_network_in_memory(handed)
    assert not t2.model.value_encoder.conv1.weight[:, 4].any()


def test_do_pass_and_checkpoint_round_trip(ref, tmp_path):
    """do_pass moves the weights, leaves the running statistics, counts its
    step; a checkpoint restores weights, optimizer and count."""
    r = ref[False]
    trainer = XMemTrainer(CONFIG, r['sd'], r['dims'], device='cpu',
                          save_path=str(tmp_path / 'net'))
    losses = trainer.do_pass(r['data'], it=0)
    assert np.isfinite(float(losses['total_loss'].detach()))
    assert trainer.it == 1
    state = trainer.network_state()
    assert not np.array_equal(state['decoder.pred.weight'],
                              r['sd']['decoder.pred.weight'])
    np.testing.assert_array_equal(state['key_encoder.bn1.running_mean'],
                                  r['sd']['key_encoder.bn1.running_mean'])
    trainer.save_checkpoint(1)
    other = XMemTrainer(CONFIG, r['sd'], r['dims'], device='cpu')
    assert other.load_checkpoint(str(tmp_path / 'net_checkpoint_1.pth')) == 1
    assert other.it == 1
    for k, v in other.network_state().items():
        np.testing.assert_array_equal(v, state[k], err_msg=k)
    assert other.optimizer.state_dict()['state'].keys() == \
        trainer.optimizer.state_dict()['state'].keys()


DDP_WORKER = '''
import sys
import numpy as np, torch
torch.set_num_threads(1)
torch.distributed.init_process_group('gloo')
rank = torch.distributed.get_rank()
from xmem2_tpu_torch.train.trainer import XMemTrainer
z = np.load(sys.argv[1])
sd = {k[3:]: z[k] for k in z.files if k.startswith('sd.')}
data = {k[5:]: z[k][rank:rank + 1] for k in z.files if k.startswith('data.')}
config = dict(lr=0.0, weight_decay=0.0, num_frames=3, num_ref_frames=2,
              deep_update_prob=1.0, start_warm=10, end_warm=20, amp=False)
logged = {}


class Logger:
    def log_scalar(self, key, value, it):
        logged[key[len('train/'):]] = value


trainer = XMemTrainer(config, sd, (64, 512, 64), logger=Logger(),
                      device='cpu')
assert isinstance(trainer.net, torch.nn.parallel.DistributedDataParallel)
losses = trainer.do_pass(data, 0)
np.savez(sys.argv[2] + f'.losses{rank}.npz',
         **{'returned.' + k: float(v) for k, v in losses.items()},
         **{'logged.' + k: v for k, v in logged.items()})
if rank == 0:
    np.savez(sys.argv[2], **{n: p.grad.numpy()
                             for n, p in trainer.model.named_parameters()})
torch.distributed.destroy_process_group()
'''


def test_ddp_two_processes_match_one(ref, tmp_path):
    """DDP over gloo, two processes with one sample each, gives the
    gradients of one process with both samples: within 1e-5 of each leaf's
    largest entry, plus the rounding floor of test_train_forward (1e-7 of
    the largest gradient anywhere; seen: 1.2e-5 of its own largest entry on
    a leaf whose largest entry is 1e-3 of the largest gradient). The losses
    each rank returns and logs at a log step are the ranks' average, which
    is the one process's losses over both samples, within 1e-5."""
    r = ref[False]
    np.savez(tmp_path / 'in.npz',
             **{f'sd.{k}': v for k, v in r['sd'].items()},
             **{f'data.{k}': v for k, v in r['data'].items()})
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(29500 + os.getpid() % 1000), WORLD_SIZE='2',
               OMP_NUM_THREADS='1')
    env.pop('LOCAL_RANK', None)
    procs = [subprocess.Popen(
        [sys.executable, '-c', DDP_WORKER, str(tmp_path / 'in.npz'),
         str(tmp_path / 'ddp.npz')], env=dict(env, RANK=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]

    config = dict(CONFIG, lr=0.0, weight_decay=0.0)
    one = XMemTrainer(config, r['sd'], r['dims'], device='cpu')
    one_losses = one.do_pass(r['data'], 0)
    for rank in range(2):
        with np.load(tmp_path / f'ddp.npz.losses{rank}.npz') as z:
            for kind in ('returned', 'logged'):
                got = {k.split('.', 1)[1]: float(z[k]) for k in z.files
                       if k.startswith(kind + '.')}
                assert set(got) == set(one_losses), (kind, sorted(got))
                for k, v in one_losses.items():
                    np.testing.assert_allclose(got[k], float(v), rtol=1e-5,
                                               atol=1e-5, err_msg=(kind, k))
    want = {n: p.grad.numpy() for n, p in one.model.named_parameters()}
    floor = 1e-7 * max(float(np.abs(g).max()) for g in want.values())
    with np.load(tmp_path / 'ddp.npz') as z:
        for n, g in want.items():
            err = float(np.abs(z[n] - g).max())
            assert err <= 1e-5 * float(np.abs(g).max()) + floor, (n, err)
