"""The port's batch_norm_train (SyncBN) against xmem2_tpu (mirroring
tests/test_syncbn.py): forward statistics and output, and the backward,
against the JAX function and its autodiff and against the C++ oracle
(xmem2_tpu/nn/syncbn_ref.py, the reference's CUDA kernels' semantics on the
host); then two gloo processes, each with half the batch, against one
process with the whole batch."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmem2_tpu.nn import functional as JF
from xmem2_tpu.nn import syncbn_ref as SB
from xmem2_tpu_torch.nn.functional import batch_norm_train

REPO = Path(__file__).resolve().parents[1]
EPS = 1e-5
TOL = 1e-5


def case(seed=0, n=4, c=5, h=6, w=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    weight = rng.standard_normal((c,)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    dz = rng.standard_normal((n, c, h, w)).astype(np.float32)
    return x, weight, bias, dz


def port(x, weight, bias, dz):
    """Forward and the gradients of <out, dz>, as numpy."""
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in
                  (x, weight, bias))
    out, mean, var = batch_norm_train(xt, wt, bt, eps=EPS)
    (out * torch.from_numpy(dz)).sum().backward()
    return [t.detach().numpy() for t in (out, mean, var, xt.grad, wt.grad,
                                         bt.grad)]


def test_forward_and_backward_match_jax():
    x, weight, bias, dz = case()
    out, mean, var, dx, dw, db = port(x, weight, bias, dz)

    def f(xn, w, b):
        return JF.batch_norm_train(xn, {'weight': w, 'bias': b}, eps=EPS)

    x_nhwc = jnp.asarray(np.moveaxis(x, 1, -1))
    (jout, jmean, jvar), vjp = jax.vjp(f, x_nhwc, jnp.asarray(weight),
                                       jnp.asarray(bias))
    jdx, jdw, jdb = vjp((jnp.asarray(np.moveaxis(dz, 1, -1)),
                         jnp.zeros_like(jmean), jnp.zeros_like(jvar)))
    for a, b in ((out, np.moveaxis(np.asarray(jout), -1, 1)),
                 (mean, jmean), (var, jvar),
                 (dx, np.moveaxis(np.asarray(jdx), -1, 1)), (dw, jdw),
                 (db, jdb)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


def test_forward_and_backward_match_cpp_oracle():
    """The C++ oracle at tests/test_syncbn.py's tolerances: forward within
    1e-4, dx within 2e-3, dw / db within 1e-3 (its backward sums in another
    order)."""
    if SB.load_native() is None:
        pytest.skip('no C++ toolchain for the native SyncBN reference')
    x, weight, bias, dz = case(1)
    out, mean, var, dx, dw, db = port(x, weight, bias, dz)
    count = x.shape[0] * x.shape[2] * x.shape[3]
    s, ss = SB.sum_sqsum(x)
    ref_mean = s / count
    ref_var = ss / count - ref_mean ** 2
    np.testing.assert_allclose(mean, ref_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, ref_var, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        out, SB.forward(x, weight, bias, ref_mean, ref_var, eps=EPS),
        rtol=1e-4, atol=1e-4)
    sum_dz, sum_dz_xhat = SB.backward_xhat(dz, x, ref_mean, ref_var, eps=EPS)
    rdx, rdw, rdb = SB.backward(dz, x, weight, ref_mean, ref_var,
                                sum_dz / count, sum_dz_xhat / count, eps=EPS)
    np.testing.assert_allclose(dx, rdx, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(dw, rdw, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(db, rdb, rtol=1e-3, atol=1e-3)


WORKER = '''
import sys
import numpy as np, torch
torch.set_num_threads(1)
torch.distributed.init_process_group('gloo')
rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
from xmem2_tpu_torch.nn.functional import batch_norm_train
z = np.load(sys.argv[1])
n = z['x'].shape[0] // world
x = torch.from_numpy(z['x'][rank * n:(rank + 1) * n]).requires_grad_()
w = torch.from_numpy(z['w']).requires_grad_()
b = torch.from_numpy(z['b']).requires_grad_()
out, mean, var = batch_norm_train(x, w, b, eps=1e-5,
                                  group=torch.distributed.group.WORLD)
(out * torch.from_numpy(z['dz'][rank * n:(rank + 1) * n])).sum().backward()
for g in (w.grad, b.grad):
    torch.distributed.all_reduce(g)
np.savez(sys.argv[2] + f'{rank}.npz', out=out.detach().numpy(),
         mean=mean.detach().numpy(), var=var.detach().numpy(),
         dx=x.grad.numpy(), dw=w.grad.numpy(), db=b.grad.numpy())
torch.distributed.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_gloo_two_processes_equal_global_batch(tmp_path):
    """Each rank normalises its half with the statistics of the whole batch:
    outputs, statistics and input gradients equal one process's on the whole
    batch, the weight and bias gradients summed over ranks equal its."""
    x, weight, bias, dz = case(2, n=8)
    np.savez(tmp_path / 'in.npz', x=x, w=weight, b=bias, dz=dz)
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(_free_port()), WORLD_SIZE='2',
               OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', WORKER, str(tmp_path / 'in.npz'),
         str(tmp_path / 'out')], env=dict(env, RANK=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    out, mean, var, dx, dw, db = port(x, weight, bias, dz)
    ranks = [np.load(tmp_path / f'out{r}.npz') for r in range(2)]
    np.testing.assert_allclose(np.concatenate([z['out'] for z in ranks]),
                               out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.concatenate([z['dx'] for z in ranks]),
                               dx, rtol=TOL, atol=TOL)
    for z in ranks:
        np.testing.assert_allclose(z['mean'], mean, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(z['var'], var, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(z['dw'], dw, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(z['db'], db, rtol=TOL, atol=TOL)
