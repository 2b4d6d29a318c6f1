"""Weight-only int8 (W8) matmul: the CUDA kernels of ``csrc/w8_matmul.cu``
and their plain PyTorch version (counterpart of
kosmosx_tpu/ops/quant_matmul.py).

``w8_matmul(x, q, scale)`` is ``(x @ q) * scale``: x (..., K) bf16 or fp32
with its leading dims flattened, q the (K, N) int8 codes and scale the
(1, N) or (N,) fp32 per-output-channel scale of ``utils/quantize._quantize_w``.
The codes' rows may start further apart than N (``q.stride(0) >= N``,
``q.stride(1) == 1``): ``_quantize_w`` makes the codes of a weight whose N
is not a multiple of 16 as a (K, N) view of a zero-padded (K,
round_up(N, 16)) buffer, whose row pitch TMA can map.
``w8_matmul_stacked(x, q, scale, layer)`` is ``(x @ q[layer]) *
scale[layer]`` over stacked (L, K, N) codes and (L, 1, N) scales, with the
layer index a host int or a device int32 scalar; K and N must be multiples
of 128, the JAX rule (kosmosx_tpu/ops/quant_matmul.py:227). The kernels
dequantise on the tile, accumulate in fp32 and apply the scale in fp32
before one rounding to x's type; the stacked kernel reads the index on the
device and never copies the layer's slice.

A CPU tensor runs the plain version, ``w8_matmul_plain``, the expression of
``w8_matmul_reference`` (:136-139), which rounds the product and the scaled
result separately. A CUDA tensor launches a kernel (built at first use) or
raises. Which one, ``_w8_plan`` decides on the host from the shape before
the launch: bf16 x with K % 8 == 0, a code row pitch that is a multiple of
16, N even and x and q 16-byte aligned takes the Hopper kernel (TMA and
wgmma, split K reduced in the same launch), every other bf16 call the
``mma.sync`` kernel and fp32 x the CUDA-core kernel. A failed build or
launch raises; no path stands in for another.

Where autograd records (grad mode on and x requiring a gradient: training),
the kernel runs inside the custom operator ``kosmosx_torch::w8_matmul``
(``w8_product``), whose backward is ``dx = (dy * scale) @ q^T`` in dy's
type, the gradient of JAX's expression ``(x @ q.astype(x.dtype)) * scale``
(kosmosx_tpu/nn/layers.py:96-107): cuBLAS on a transient copy of the codes
in dy's type (JAX differentiates this product in XLA, never in its
kernel). Codes, scales and the layer index take no gradient. Being an
operator, the product is one a selective-remat policy can name and save
(``nn/decoder._DOTS``).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from kosmosx_torch.utils import trace

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the output tiles of the mma.sync / CUDA-core kernels (csrc/w8_matmul.cu:
# BM x BN, FM x FN)
_TILES = {torch.bfloat16: (64, 128), torch.float32: (64, 64)}
_MIN_K_CHUNK = 128
# the Hopper kernel: 128 output columns and 64-deep K tiles a block;
# (block rows, blocks per SM) of its small and large blocks; the last split
# of an output tile reads every split's fp32 partial sums alone, so rows x
# splits stays within 128 (64 KB of partials)
_HOPPER_BN, _HOPPER_BK = 128, 64
_HOPPER_SMALL, _HOPPER_LARGE = (64, 2), (256, 1)
_HOPPER_REDUCE_ROWS = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def w8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale`` with the codes cast to x's type, as
    ``w8_matmul_reference``."""
    y = x @ q.to(x.dtype)
    return y * scale.reshape(1, -1).to(x.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _k_chunk(m: int, k: int, n: int, tile: tuple, sms: int) -> int:
    """K elements per split of the ``mma.sync`` / CUDA-core kernels' grid:
    all of K when the output tiles give every SM two blocks, else K split
    so that they do, each split at least 128 deep."""
    bm, bn = tile
    want = _cdiv(2 * sms, _cdiv(m, bm) * _cdiv(n, bn))
    if want <= 1:
        return k
    return max(_MIN_K_CHUNK, _cdiv(_cdiv(k, want), 64) * 64)


def _w8_plan(m: int, k: int, n: int, x_aligned: bool, q_aligned: bool,
             sms: int, pitch: Optional[int] = None) -> tuple:
    """The kernel a bf16 (M, K) x (K, N) call takes, with code rows
    ``pitch`` codes apart (None: N, dense codes): ``(path, tiles,
    splits)``. TMA needs row pitches that are multiples of 16 bytes and
    16-byte aligned bases, and the Hopper kernel stores column pairs, so
    K % 8 == 0, pitch % 16 == 0, N even and aligned x and q take
    ``"hopper"`` (blocks by ``_hopper_block``), with K split so that the
    blocks fill the card's ``sms`` SMs where the output tiles alone do
    not, as far as the in-launch reduction allows (rows x splits <= 128; no
    split without K). Any other call takes ``"mma"`` and its split rule."""
    pitch = n if pitch is None else pitch
    if k % 8 or pitch % 16 or n % 2 or not (x_aligned and q_aligned):
        bm, bn = _TILES[torch.bfloat16]
        return ("mma", _cdiv(m, bm) * _cdiv(n, bn),
                _cdiv(k, _k_chunk(m, k, n, (bm, bn), sms)))
    bm, per_sm = _hopper_block(m, n, sms)
    tiles = _cdiv(m, bm) * _cdiv(n, _HOPPER_BN)
    nk = _cdiv(k, _HOPPER_BK)
    splits = max(1, min(nk, per_sm * sms // tiles,
                        _HOPPER_REDUCE_ROWS // min(m, bm)))
    return "hopper", tiles, _cdiv(nk, _cdiv(nk, splits))


def _hopper_block(m: int, n: int, sms: int) -> tuple:
    """(block rows, blocks per SM) of the Hopper kernel: 256 x 128 output
    blocks, one per SM, where M > 64 and they number at least half the SMs
    (prefill: each code tile is converted once per 256 rows); else 64 x 128
    blocks, two per SM (decode, and the few tiles of a ViT or resampler
    projection)."""
    large = _cdiv(m, _HOPPER_LARGE[0]) * _cdiv(n, _HOPPER_BN)
    return _HOPPER_LARGE if m > 64 and 2 * large >= sms else _HOPPER_SMALL


_TICKETS: dict = {}  # device index -> every ticket buffer made there


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets on ``device``: one per output tile
    of the Hopper W8 kernel's split-K reduction, or per (b, h) row of the
    decode kernel's merge. Each launch leaves its tickets 0 again, so
    launches in stream order share them (two such launches in flight at once
    on different streams would not). A call that needs more than the newest
    buffer holds gets a larger one, and the older buffers are kept, never
    freed: a CUDA graph captured earlier still points at them. Growing
    during a capture raises (the zeroing would be captured, not run): make
    one call at the largest shape before capturing."""
    made = _TICKETS.setdefault(device.index, [])
    if not made or made[-1].numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{n} tickets needed during a CUDA graph capture, "
                f"{made[-1].numel() if made else 0} made: call once at this "
                f"shape before capturing")
        made.append(torch.zeros(max(n, 1024, 2 * made[-1].numel() if made
                                    else 0), dtype=torch.int32, device=device))
    return made[-1]


def _code_pitch(q: torch.Tensor) -> int:
    """The codes' row pitch, in codes: q is int8, (K, N) or stacked (L, K,
    N), with unit column stride, rows at least N apart and layers K rows
    apart; raises otherwise."""
    if q.dtype != torch.int8:
        raise ValueError(f"W8 kernel codes must be int8, got {q.dtype}")
    k, n = q.shape[-2:]
    ldq = q.stride(-2)
    if (q.stride(-1) != 1 and n > 1) or ldq < n or (
            q.ndim == 3 and q.stride(0) != k * ldq):
        raise ValueError(f"W8 kernel codes must be rows of unit stride at "
                         f"least N apart, layers K rows apart; got shape "
                         f"{tuple(q.shape)}, strides {q.stride()}")
    return ldq


def _launch(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, n: int,
            layer=None) -> tuple:
    """Run ``csrc/w8_matmul.cu`` on x2 (M, K): the path of ``_w8_plan`` for
    bf16 x, the CUDA-core kernel for fp32; the 2-D entry, or with a device
    int32 ``layer`` the stacked one. Returns ((M, N), path)."""
    from kosmosx_torch.ops import _build

    if x2.dtype not in _X_CODES:
        raise TypeError(f"W8 kernel x must be float32 or bfloat16, got {x2.dtype}")
    ldq = _code_pitch(q)
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
    m, k = x2.shape
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return out, None
    x2 = x2.contiguous()
    scale = scale.to(torch.float32).contiguous()
    sms = _sm_count(x2.device.index or 0)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    n_layers = 1 if layer is None else q.shape[0]
    layer_ptr = None if layer is None else layer.data_ptr()
    lib = _build.library()
    path, tiles, splits = (_w8_plan(m, k, n, x2.data_ptr() % 16 == 0,
                                    q.data_ptr() % 16 == 0, sms, ldq)
                           if x2.dtype == torch.bfloat16 else ("f32", 0, 0))
    if path != "hopper":
        chunk = _k_chunk(m, k, n, _TILES[x2.dtype], sms)
        splits = _cdiv(k, chunk)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x2.device) if splits > 1 else None)
    partial_ptr = None if partial is None else partial.data_ptr()
    if path == "hopper":
        tickets = _tickets(x2.device, tiles) if splits > 1 else None
        err = lib.kx_w8_matmul_hopper(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), layer_ptr,
            out.data_ptr(), partial_ptr,
            None if tickets is None else tickets.data_ptr(), n_layers, m, k,
            n, ldq, _hopper_block(m, n, sms)[0], splits, stream)
        _build.check(lib, err, "w8_matmul launch (hopper)")
        return out, path
    tail = (m, k, n, ldq, chunk, _X_CODES[x2.dtype], stream)
    if layer is None:
        err = lib.kx_w8_matmul(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), partial_ptr, *tail)
    else:
        err = lib.kx_w8_matmul_stacked(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), layer_ptr,
            out.data_ptr(), partial_ptr, n_layers, *tail)
    _build.check(lib, err, f"w8_matmul launch ({path})")
    return out, path


def _run(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
         layer: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on x2 (M, K) and count the launch on its wrapper
    (``w8_matmul`` for 2-D codes, ``w8_matmul_stacked`` with ``layer``)."""
    out, path = _launch(x2, q, scale, q.shape[-1], layer=layer)
    wrapper = w8_matmul if layer is None else w8_matmul_stacked
    wrapper.launches += 1
    wrapper.hopper_launches += path == "hopper"
    return out


def _layer_slice(q: torch.Tensor, scale: torch.Tensor,
                 layer: Optional[torch.Tensor]) -> tuple:
    """(q, scale) of layer ``layer`` of a stack (index read on the device,
    no host sync), or the 2-D operands as they are."""
    if layer is None:
        return q, scale
    li = layer.reshape(1).long()
    return (q.index_select(0, li)[0],
            scale.reshape(q.shape[0], -1).index_select(0, li)[0])


@torch.library.custom_op("kosmosx_torch::w8_matmul", mutates_args=())
def w8_product(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               layer: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(x2 @ q) * scale`` (or over ``q[layer]``) on a 2-D x2 as an
    operator autograd can see: on a CUDA tensor the kernel, on a CPU one
    the plain version."""
    if _on_device(x2, "w8_product"):
        return _run(x2, q, scale, layer)
    return w8_matmul_plain(x2, *_layer_slice(q, scale, layer))


def _product_setup(ctx, inputs, output) -> None:
    _, q, scale, layer = inputs
    ctx.save_for_backward(q, scale, layer)


def _product_backward(ctx, dy: torch.Tensor):
    """dx = (dy * scale) @ q^T in dy's type; the codes cast once, never
    kept. On the current stream like every launch."""
    q, scale = _layer_slice(*ctx.saved_tensors)
    dx = (dy * scale.reshape(1, -1).to(dy.dtype)) @ q.to(dy.dtype).t()
    return dx, None, None, None


w8_product.register_autograd(_product_backward, setup_context=_product_setup)


def _on_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return True


def w8_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale``: x (..., K), q (K, N) int8, scale (1, N) or (N,)
    -> (..., N) in x's type."""
    lead, k = x.shape[:-1], x.shape[-1]
    if q.ndim != 2 or q.shape[0] != k:
        raise ValueError(f"x K={k} vs q {tuple(q.shape)}")
    n = q.shape[1]
    if scale.numel() != n:
        raise ValueError(f"scale {tuple(scale.shape)} for N={n}")
    with trace.span("op.w8_matmul", device=True) as sp:
        if sp.on:
            sp.set(**_span_shapes(x, n))
        if not _on_device(x, "w8_matmul"):
            return w8_matmul_plain(x, q, scale)
        return _product(x.reshape(-1, k), q, scale, None).reshape(*lead, n)


def w8_matmul_stacked(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      layer: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(x @ q[layer]) * scale[layer]``: x (..., K), q (L, K, N) int8,
    scale (L, 1, N), ``layer`` an int or an int32 scalar tensor -> (..., N)
    in x's type. The CUDA kernel reads ``layer`` on the device (an int is
    placed in a device scalar) and offsets into the whole stack."""
    lead, k = x.shape[:-1], x.shape[-1]
    l_, kq, n = q.shape
    if kq != k:
        raise ValueError(f"x K={k} vs q K={kq}")
    if k % 128 or n % 128:
        raise ValueError(f"stacked W8 matmul needs K,N % 128 == 0; got {k},{n}")
    if scale.numel() != l_ * n:
        raise ValueError(f"scale {tuple(scale.shape)} for (L, N) = ({l_}, {n})")
    if isinstance(layer, int) and not 0 <= layer < l_:
        raise IndexError(f"layer {layer} of a stack of {l_}")
    with trace.span("op.w8_matmul_stacked", device=True) as sp:
        if sp.on:
            sp.set(**_span_shapes(x, n))
        if not _on_device(x, "w8_matmul_stacked"):
            li = int(layer)
            return w8_matmul_plain(x, q[li], scale.reshape(l_, n)[li])
        layer = torch.as_tensor(layer, dtype=torch.int32, device=x.device)
        return _product(x.reshape(-1, k), q, scale, layer).reshape(*lead, n)


def _span_shapes(x: torch.Tensor, n: int) -> dict:
    """A W8 call's shapes for its span: (M, K) of x's rows, N, x's element
    size."""
    k = x.shape[-1]
    return dict(m=x.numel() // k, k=k, n=n, itemsize=x.element_size())


def _product(x2, q, scale, layer) -> torch.Tensor:
    """The kernel on a CUDA x2: through the operator where autograd
    records, so that it and the remat policies see the product, else
    launched directly (no operator dispatch on the serving path)."""
    if torch.is_grad_enabled() and x2.requires_grad:
        return w8_product(x2, q, scale, layer)
    return _run(x2, q, scale, layer)


# kernel launches on CUDA tensors (plain-version calls are not counted):
# every launch, and those of the Hopper kernel among them
w8_matmul.launches = 0
w8_matmul.hopper_launches = 0
w8_matmul_stacked.launches = 0
w8_matmul_stacked.hopper_launches = 0
