"""The tile-rate study's attention skeleton, S = Q K^T then O = S V with no
softmax: the CUDA kernel ``csrc/tile_rate.cu`` and its plain PyTorch version
(counterpart of benchmarks/tile_rate_study.py::make_fn.kernel, :29-37).

For each program ``i < G`` on (G, L, d) bf16 q, k and v:
``s = q[i] @ k[i].T`` accumulated in fp32 and rounded to bf16, then
``o = s @ v[i]`` accumulated in fp32 and rounded to bf16. The kernel takes
bf16 only (the Pallas kernel's ``out_shape`` is bf16), d in {64, 128} and
L a positive multiple of its 64-row tiles. The wrapper raises on anything
else, whatever the device. A CPU tensor then runs the plain version; a CUDA
tensor launches the kernel (built at first use) or raises.
"""

from __future__ import annotations

import torch

HEAD_DIMS = (64, 128)
TILE = 64  # rows of a q or key tile (csrc/flash_common.cuh: BQ, BK)


def tile_rate_flops(d: int, g: int, L: int) -> int:
    """Two products of (L, d) by (d, L) and (L, L) by (L, d) per program,
    2 flops per multiply-add."""
    return 4 * g * L * L * d


def tile_rate_bytes(d: int, g: int, L: int) -> int:
    """q, k and v read once and o written once, bf16."""
    return 4 * g * L * d * 2


def tile_attention_skeleton_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: fp32 products, S and O rounded
    to bf16."""
    s = (q.float() @ k.float().mT).bfloat16()
    return (s.float() @ v.float()).bfloat16()


def _check_inputs(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"tile kernel {name} must be bfloat16, got "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"q, k and v must share one (G, L, d) shape; got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"tile kernel needs a contiguous, 16-byte "
                             f"aligned {name}")
    if q.ndim != 3:
        raise ValueError(f"q, k and v must be (G, L, d); got {tuple(q.shape)}")
    g, length, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"tile kernel head dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    if length == 0 or length % TILE:
        raise ValueError(f"tile kernel L must be a positive multiple of "
                         f"{TILE}, got {length}")
    if not 0 < g <= 65535:
        raise ValueError(f"tile kernel G must be in [1, 65535], got {g}")


def tile_attention_skeleton(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """(G, L, d) bf16 q, k, v -> (G, L, d) bf16 ``(q k^T) v``, S rounded to
    bf16 between the products."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return tile_attention_skeleton_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the tile kernel runs on cpu or cuda, not {q.device}")
    from kosmosx_torch.ops import _build

    g, length, d = q.shape
    o = torch.empty_like(q)
    lib = _build.library()
    err = lib.kx_tile_rate(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), g, length, d,
                           torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "tile_rate launch")
    tile_attention_skeleton.launches += 1
    return o


# kernel launches on CUDA tensors (plain-version calls are not counted)
tile_attention_skeleton.launches = 0
