"""LayerNorm over the last dim: the CUDA kernels of ``csrc/layer_norm.cu``
(forward and backward), each with its plain PyTorch version.

The JAX package's LayerNorm is jnp code, not a Pallas kernel
(kosmosx_tpu/nn/layers.py:145-154); ``layer_norm_plain`` is its op-for-op
port and what a CPU tensor runs. On the card that chain is about eleven
launches a call, so a CUDA tensor runs one hand-written kernel forward and
one backward instead, computing the same function:

- fp32 math whatever the input dtype, a two-pass mean and variance,
  ``y = (x - mean) * rsqrt(var + eps) * scale (+ bias)`` written in
  ``x.dtype``;
- ``scale`` and ``bias`` read in their own dtype where that is x's or
  float32 (any other is read as float32, as the plain version does, and
  its gradient returned in its own dtype);
- any leading shape, a last dim of 1 to ``MAX_WIDTH``, any ``eps``.

``layer_norm`` is differentiable. On a CUDA tensor it is the
``LayerNorm`` function: the forward saves x, the scale and each row's fp32
mean and rstd, the backward computes the closed form of
``layer_norm_bwd_plain`` in one kernel, with the parameter gradients summed
over rows in an order fixed by the shape and the card (no atomics: two runs
give the same bits) and skipped where neither the scale nor the bias needs
one. ``layer_norm_fwd``, ``layer_norm_bwd`` and ``LayerNorm`` take CUDA
tensors alone; one of another dtype or width raises, and nothing falls
back. The plain versions are what a CPU tensor runs and what the tests
hold the kernels to.

``rms_norm`` is RMSNorm (the LFM2 decoder's norm, forward only): ``y = x *
rsqrt(mean(x^2) + eps) * scale`` in fp32, written in ``out_dtype`` (x's by
default: an fp32 residual stream is normalised into bf16 in the same pass),
by ``kx_rms_norm_fwd_kernel`` of the same source on a CUDA tensor (rows of
64 pack several to a warp) and ``rms_norm_plain`` elsewhere; x, the scale
and y each float32 or bfloat16.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from kosmosx_torch.utils import trace

MAX_WIDTH = 16384
# the backward kernel's threads an SM holds: 65,536 registers at the 64 a
# thread that its launch bounds (1,024 threads a block) allow
_BWD_THREADS_PER_SM = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in plain torch, fp32 math whatever the input dtype
    (kosmosx_tpu/nn/layers.py:145-154)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                   eps: float = 1e-5,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm in plain torch, fp32 math whatever the input dtype, one
    rounding to ``out_dtype`` (x's by default)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(out_dtype or x.dtype)


def layer_norm_stats_plain(x: torch.Tensor, *, eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's fp32 (mean, rstd), shaped as x without its last dim: what
    the forward kernel saves for the backward."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1)
    return mean[..., 0], torch.rsqrt(var + eps)


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         dy: torch.Tensor, *,
                         bias: Optional[torch.Tensor] = None,
                         param_grads: bool = True):
    """The backward kernel's closed form in plain torch, fp32 math:
    ``(dx, dscale, dbias)``. With ``xhat = (x - mean) rstd`` and
    ``g = dy scale``, ``dx = rstd (g - mean(g) - xhat mean(g xhat))`` in x's
    dtype; ``dscale`` (the sum over rows of ``dy xhat``) in the scale's
    dtype and ``dbias`` (of ``dy``) in the bias's, or None without
    ``param_grads`` (and ``dbias`` None without a bias)."""
    x32, dy32 = x.float(), dy.float()
    r = rstd[..., None]
    xhat = (x32 - mean[..., None]) * r
    g = dy32 * scale.float()
    c1 = (g * xhat).mean(dim=-1, keepdim=True)
    c2 = g.mean(dim=-1, keepdim=True)
    dx = (r * (g - c2 - xhat * c1)).to(x.dtype)
    if not param_grads:
        return dx, None, None
    rows = tuple(range(x.dim() - 1))
    dscale = (dy32 * xhat).sum(dim=rows).to(scale.dtype)
    dbias = None if bias is None else dy32.sum(dim=rows).to(bias.dtype)
    return dx, dscale, dbias


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (rows, width) with its rows one stride apart and the last
    dim contiguous: a view where the leading dims allow one, else a copy."""
    t2 = t.reshape(-1, t.shape[-1])
    if t2.shape[-1] > 1 and t2.stride(-1) != 1:
        t2 = t2.contiguous()
    return t2


def _check(x: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor]) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    width = x.shape[-1]
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"layer_norm kernel takes a last dim of 1 to "
                         f"{MAX_WIDTH}, got {width}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.device != x.device
                              or tuple(t.shape) != (width,)):
            raise ValueError(f"{name} must be ({width},) on {x.device}; got "
                             f"{tuple(t.shape)} on {t.device}")


def _params(x: torch.Tensor, scale: torch.Tensor,
            bias: Optional[torch.Tensor]):
    """The scale and bias as the kernels read them: as they are where both
    are in x's dtype or fp32, else both as fp32, which is what the plain
    version computes with (``.float()``), contiguous."""
    w = scale.dtype
    if w not in (x.dtype, torch.float32) or (bias is not None
                                              and bias.dtype != w):
        w = torch.float32
    return (scale.to(w).contiguous(),
            None if bias is None else bias.to(w).contiguous())


def _aligned(*tensors) -> bool:
    """Whether 16-byte loads and stores reach every row of these (rows,
    width) tensors and 1-D parameters: each base and each row stride 16-byte
    aligned, the width a whole number of 16-byte chunks."""
    for t in tensors:
        if t is None:
            continue
        if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
            return False
        if t.dim() == 2 and (t.stride(0) * t.element_size()) % 16:
            return False
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_blocks(x: torch.Tensor, rows: int, params: bool) -> int:
    """Blocks of the backward kernel for ``rows`` of x. Its launch plan
    (``plan()`` in ``csrc/layer_norm.cu``) gives a row a power of two of
    threads, 32 to 1,024, each one 16-byte chunk or more, and packs narrow
    rows up to 256 threads a block. Without parameter gradients one block
    a block's rows; with them no more than the card holds at once, so each
    block walks several rows and the partial rows stay few. The count
    follows the shape, the dtype and the card alone, and so does the order
    in which the parameter gradients are summed."""
    chunks = -(-x.shape[-1] * x.element_size() // 16)
    tpr = min(max(32, 1 << (chunks - 1).bit_length()), 1024)
    rpb = max(1, 256 // tpr)
    need = -(-rows // rpb)
    if not params:
        return need
    held = _sm_count(x.device.index) * (_BWD_THREADS_PER_SM // (tpr * rpb))
    return min(need, held)


def _cast(dscale, dbias, dtypes):
    """The parameter gradients in the parameters' own dtypes."""
    return tuple(None if g is None else g.to(d)
                 for g, d in zip((dscale, dbias), dtypes))


def _on_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the layer_norm kernels take CUDA tensors, got one "
                         f"on {x.device}")


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                   stats: bool = True):
    """The forward kernel, not differentiable: ``(y, mean, rstd)``, the
    stats fp32 per row (None without ``stats``)."""
    from kosmosx_torch.ops import _build

    _on_cuda(x)
    _check(x, scale, bias)
    x2 = _rows(x)
    scale, bias = _params(x, scale, bias)
    rows, width = x2.shape
    y = torch.empty((rows, width), device=x.device, dtype=x.dtype)
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, device=x.device, dtype=torch.float32)
        rstd = torch.empty(rows, device=x.device, dtype=torch.float32)
    if rows:
        lib = _build.library()
        err = lib.kx_layer_norm_fwd(
            x2.data_ptr(), x2.stride(0), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if rstd is None else rstd.data_ptr(), rows, width,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], float(eps),
            int(_aligned(x2, scale, bias, y)), _stream(x))
        _build.check(lib, err, "kx_layer_norm_fwd launch")
        layer_norm.launches += 1
    if stats:
        mean, rstd = mean.view(x.shape[:-1]), rstd.view(x.shape[:-1])
    return y.view(x.shape), mean, rstd


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, dy: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   param_grads: bool = True):
    """The backward kernel from the forward's stats: ``(dx, dscale,
    dbias)`` of ``layer_norm_bwd_plain``."""
    from kosmosx_torch.ops import _build

    _on_cuda(x)
    _check(x, scale, bias)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be a {tuple(x.shape)} {x.dtype} tensor on "
                         f"{x.device}; got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    x2, dy2 = _rows(x), _rows(dy)
    rows, width = x2.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.numel() != rows or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"{rows} rows on {x.device}")
    dtypes = (scale.dtype, None if bias is None else bias.dtype)
    scale, bias = _params(x, scale, bias)
    dx = torch.empty((rows, width), device=x.device, dtype=x.dtype)
    dscale = dbias = None
    if param_grads:
        dscale = torch.empty(width, device=x.device, dtype=scale.dtype)
        if bias is not None:
            dbias = torch.empty_like(dscale)
    if not rows:   # an empty batch: nothing to launch, zero sums
        return dx.view(x.shape), *_cast(
            *(g if g is None else g.zero_() for g in (dscale, dbias)), dtypes)
    lib = _build.library()
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype])
    parts = _bwd_blocks(x, rows, param_grads)
    ds_part = db_part = None
    if param_grads:
        ds_part = torch.empty((parts, width), device=x.device,
                              dtype=torch.float32)
        if bias is not None:
            db_part = torch.empty_like(ds_part)
    err = lib.kx_layer_norm_bwd(
        x2.data_ptr(), x2.stride(0), dy2.data_ptr(), dy2.stride(0),
        scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        *(None if t is None else t.data_ptr()
          for t in (ds_part, db_part, dscale, dbias)),
        parts, rows, width, *codes, int(_aligned(x2, dy2, scale, dx)),
        _stream(x))
    _build.check(lib, err, "kx_layer_norm_bwd launch")
    layer_norm_bwd.launches += 1
    return dx.view(x.shape), *_cast(dscale, dbias, dtypes)


_RMS_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-5,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The RMSNorm kernel on a CUDA tensor (raises on another): y in
    ``out_dtype`` (x's by default), x's shape."""
    from kosmosx_torch.ops import _build

    _on_cuda(x)
    _check(x, scale, None)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _RMS_DTYPES or out_dtype not in _RMS_DTYPES:
        raise TypeError(f"the rms_norm kernel takes and writes float32 or "
                        f"bfloat16; got {x.dtype} to {out_dtype}")
    x2 = _rows(x)
    scale = scale.float().contiguous() if scale.dtype not in _RMS_DTYPES \
        else scale.contiguous()
    rows, width = x2.shape
    y = torch.empty((rows, width), device=x.device, dtype=out_dtype)
    if rows:
        lib = _build.library()
        err = lib.kx_rms_norm_fwd(
            x2.data_ptr(), x2.stride(0), scale.data_ptr(), y.data_ptr(), rows,
            width, _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
            _DTYPE_CODES[out_dtype], float(eps),
            int(_aligned(x2, scale, y)), _stream(x))
        _build.check(lib, err, "kx_rms_norm_fwd launch")
        rms_norm.launches += 1
    return y.view(x.shape)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm over the last dim, forward only, written in ``out_dtype``
    (x's by default): the kernel inside an ``op.rms_norm`` span on a CUDA
    tensor, ``rms_norm_plain`` elsewhere."""
    if x.device.type != "cuda":
        return rms_norm_plain(x, scale, eps=eps, out_dtype=out_dtype)
    with trace.span("op.rms_norm", device=True) as sp:
        if sp.on:
            sp.set(rows=x.numel() // max(x.shape[-1], 1), width=x.shape[-1],
                   itemsize=x.element_size(),
                   out_itemsize=(out_dtype or x.dtype).itemsize)
        return rms_norm_fwd(x, scale, eps=eps, out_dtype=out_dtype)


class LayerNorm(torch.autograd.Function):
    """``layer_norm`` of a CUDA tensor with its gradient on the kernels:
    the forward saves x, the scale and the rows' (mean, rstd); the backward
    returns dx and, where the scale or bias needs one, both parameter
    gradients."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, scale, bias, eps=eps)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        need_x, need_scale, need_bias, _ = ctx.needs_input_grad
        dx, dscale, dbias = layer_norm_bwd(
            x, scale, mean, rstd, dy, bias=bias,
            param_grads=need_scale or need_bias)
        return (dx if need_x else None, dscale if need_scale else None,
                dbias if need_bias else None, None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Differentiable LayerNorm over the last dim. A CUDA tensor launches
    the forward kernel, through ``LayerNorm`` where a gradient is needed,
    inside an ``op.layer_norm`` span; any other runs ``layer_norm_plain``
    (autograd through its ops), as cheap on the host as before the kernels:
    no span there."""
    if x.device.type != "cuda":
        return layer_norm_plain(x, scale, bias, eps=eps)
    with trace.span("op.layer_norm", device=True) as sp:
        if sp.on:
            sp.set(rows=x.numel() // max(x.shape[-1], 1), width=x.shape[-1],
                   itemsize=x.element_size())
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, scale, bias)):
            return LayerNorm.apply(x, scale, bias, float(eps))
        return layer_norm_fwd(x, scale, bias, eps=eps, stats=False)[0]


# kernel launches on CUDA tensors (plain-version calls are not counted); a
# backward with parameter gradients adds its column-sum kernel in the same
# call
layer_norm.launches = 0
layer_norm_bwd.launches = 0
rms_norm.launches = 0
