"""Frozen batch norm with an optional residual add and ReLU: one
hand-written CUDA pass (csrc/bn_epilogue.cu) and its plain PyTorch version.

Every convolution of the ResNet trunks (models/resnet.py) ends in a frozen
batch norm, often a ReLU, and each residual block in an add and a ReLU.
bn_epilogue computes relu(batch_norm(x) + residual) (the residual and the
ReLU optional) as bn_epilogue_plain composes it, bit for bit: the kernel
rounds at the same places in the same order (csrc/bn_epilogue.cu).

A CPU tensor takes the plain version; on the card every call launches the
kernel. Where autograd records the call (training, f-BRS's refinement), the
kernel is the forward of an autograd Function whose backward gives the
gradients that autograd gives the plain version, bit for bit: it runs the
same operations on the same operands (_BNEpilogue.backward).

Counter (utils/profiling.py): 'kernel.bn_epilogue' counts launches.
"""

import ctypes
import functools
from typing import Optional

import torch

from xmem2_tpu_torch.nn import functional as XF
from xmem2_tpu_torch.ops import cuda_build
from xmem2_tpu_torch.ops.cuda_build import check_cuda, ptr, raise_on, stream
from xmem2_tpu_torch.utils.profiling import count

EPS = 1e-5
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # the launch's dtype codes


def bn_epilogue_plain(x: torch.Tensor, weight, bias, mean, var,
                      residual: Optional[torch.Tensor] = None,
                      relu: bool = False, eps: float = EPS) -> torch.Tensor:
    """batch_norm(x) (nn/functional.py, in float32, back in x's dtype), then
    `+ residual`, then ReLU."""
    out = XF.batch_norm(x, weight, bias, mean, var, eps)
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


def vector_width(run: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """Elements a kernel vector: the widest of at most 16 bytes that divides
    the run a vector may not cross (a plane, H * W) and every tensor's
    address."""
    v = 16 // itemsize
    while v > 1 and (run % v or any(t.data_ptr() % (v * itemsize)
                                    for t in tensors)):
        v //= 2
    return v


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built and typed once (the wrapper runs
    for every batch norm of a frame)."""
    fn = cuda_build.library('bn_epilogue').bn_epilogue_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def _launch(x: torch.Tensor, params, residual: Optional[torch.Tensor],
            relu: bool, eps: float) -> torch.Tensor:
    """The kernel over a CUDA x [N, C, H, W] with the four [C] vectors
    `params`, after the checks that make its raw pointers safe."""
    params = tuple(p.detach().float() for p in params)
    if x.dim() != 4 or any(p.shape != (x.shape[1],) for p in params):
        raise ValueError(f'bn_epilogue: x must be [N, C, H, W] with [C] '
                         f'batch-norm vectors, got {tuple(x.shape)} and '
                         f'{[tuple(p.shape) for p in params]}')
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f'bn_epilogue: residual {tuple(residual.shape)} '
                         f'is not x\'s shape {tuple(x.shape)}')
    tensors = dict(x=(x, tuple(_DTYPES)))
    if residual is not None:
        tensors['residual'] = (residual, (x.dtype,))
    f32 = (torch.float32,)
    check_cuda('bn_epilogue', x.device, weight=(params[0], f32),
               bias=(params[1], f32), mean=(params[2], f32),
               var=(params[3], f32), **tensors)
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    vec = vector_width(h * w, x.element_size(), x, out,
                       *(() if residual is None else (residual,)))
    rc = _launcher()(
        ptr(x), *(ptr(p) for p in params),
        None if residual is None else ptr(residual), ptr(out),
        ctypes.c_int(n * c), ctypes.c_int(c), ctypes.c_int(h * w),
        ctypes.c_float(eps), ctypes.c_int(relu),
        ctypes.c_int(_DTYPES[x.dtype]), ctypes.c_int(vec), stream(x))
    raise_on(rc, 'bn_epilogue')
    count('kernel.bn_epilogue')
    return out


class _BNEpilogue(torch.autograd.Function):
    """_launch as the forward of an autograd graph. The backward repeats,
    on the same operands, the operations that autograd runs back through
    bn_epilogue_plain (ReLU, add, the cast to x's dtype, x * scale + shift,
    scale and shift from the four vectors), so every gradient is the plain
    version's to the bit. The running statistics take none."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, residual, relu, eps):
        out = _launch(x, (weight, bias, mean, var), residual, relu, eps)
        ctx.relu, ctx.eps = relu, eps
        ctx.save_for_backward(x, weight, bias, mean, var,
                              out if relu else None)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, mean, var, out = ctx.saved_tensors
        if ctx.relu:
            grad = torch.ops.aten.threshold_backward(grad, out, 0)
        grad32 = grad.float()
        r = torch.rsqrt(var.float() + ctx.eps)
        scale = weight.float() * r
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        grad_x = grad_w = grad_b = None
        if need_x:
            grad_x = (grad32 * scale[:, None, None]).to(x.dtype)
        if need_w or need_b:
            # what autograd's sum_to gives the broadcast [C, 1, 1] operands
            grad_shift = grad32.sum((0, 2, 3), keepdim=True).view(-1)
            if need_b:
                grad_b = grad_shift.to(bias.dtype)
            if need_w:
                grad_scale = (grad32 * x.float()).sum(
                    (0, 2, 3), keepdim=True).view(-1) \
                    + -grad_shift * mean.float()
                grad_w = (grad_scale * r).to(weight.dtype)
        grad_res = grad if ctx.needs_input_grad[5] else None
        return grad_x, grad_w, grad_b, None, None, grad_res, None, None


def bn_epilogue(x: torch.Tensor, weight, bias, mean, var,
                residual: Optional[torch.Tensor] = None, relu: bool = False,
                eps: float = EPS) -> torch.Tensor:
    """relu(batch_norm(x) + residual) over x [N, C, H, W] with the four [C]
    batch-norm vectors (running statistics); residual (x's shape and dtype)
    and the ReLU are optional. Returns a new tensor in x's dtype.

    On the card, x must be bf16 or f32 and contiguous (NCHW order), and the
    residual in x's dtype, contiguous; the running statistics must not
    require grad."""
    params = (weight, bias, mean, var)
    if x.device.type == 'cpu':
        return bn_epilogue_plain(x, *params, residual, relu, eps)
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad for t in (x, residual) + params):
        return _launch(x, params, residual, relu, eps)
    if mean.requires_grad or var.requires_grad:
        raise ValueError('bn_epilogue: the running statistics take no '
                         'gradient')
    return _BNEpilogue.apply(x, *params, residual, relu, eps)
