"""Lion over every leaf of an optimizer in three launches: the kernels of
``csrc/optim.cu``.

``train/optim.Optimizer`` runs Lion leaf by leaf on CPU tensors (optax's
chain, op for op). On the card that chain is some fifteen launches a leaf,
about 12,000 a training step, so ``Optimizer(name="lion")`` over CUDA leaves
runs these instead, computing the same function:

- ``LeafTable``: the leaves' parameters and moments, in the optimizer's
  order, as a table on the card (pointers, element counts, dtypes, which
  leaves decay), cut into chunks of ``CHUNK`` elements. Their pointers do
  not move between steps, so the table is built once and again only when
  one does (``current``).
- ``grads``: a step's gradients, a new set of pointers each step, sent in
  one non-blocking copy from pinned memory.
- ``lion_norm``: the global norm of the gradients (launches 1 and 2): each
  chunk's sum of squares, then each leaf's and, in the table's order, the
  norm, left on the card with each leaf's sum (``table.leaf_sq``).
- ``lion``: the clip, Lion and the decoupled decay in one pass over every
  leaf (launch 3), with the norm read on the card: p and m bit for bit as
  the leaf path leaves them given the same norm.

Nothing here waits for the card or copies from it. p, m and g may be
float32 or bfloat16; any other dtype, a non-contiguous parameter or
moment, or a tensor off the table's card raises (a non-contiguous gradient
is copied). ``lion.launches`` counts the launches (three a step),
``lion.leaves`` the leaves updated.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

CHUNK = 65536
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NO_GRAD = 2


def chunk_layout(numels: Sequence[int], chunk: int = CHUNK):
    """(first chunk of each leaf, the leaf of each chunk): each leaf cut
    into ``ceil(n / chunk)`` chunks, leaf after leaf."""
    counts = np.array([-(-int(n) // chunk) for n in numels], dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    owner = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    return first, owner


def _upload(dst: torch.Tensor, values) -> None:
    """``values`` into ``dst`` on the card: one non-blocking copy from
    pinned memory, which the caching host allocator keeps until the copy
    has run."""
    src = torch.as_tensor(np.asarray(values), dtype=dst.dtype).pin_memory()
    dst.copy_(src, non_blocking=True)


def _code(t: torch.Tensor, what: str) -> int:
    code = _CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the Lion kernels take float32 or bfloat16 {what}, "
                        f"got {t.dtype}")
    return code


class LeafTable:
    """The leaves one optimizer updates, as the kernels read them: ``params``
    and ``moments`` in the optimizer's order (each moment its parameter's
    shape), ``decay`` whether a leaf takes weight decay, ``local`` whether
    its sum of squares counts whole in ``lion_norm``'s ``out[1]`` (every
    leaf but a sharded one's piece). All on one card, contiguous."""

    def __init__(self, params: Sequence[torch.Tensor],
                 moments: Sequence[torch.Tensor], decay: Sequence[bool],
                 local: Optional[Sequence[bool]] = None):
        if not params:
            raise ValueError("the Lion kernels need at least one leaf")
        dev = params[0].device
        if dev.type != "cuda":
            raise ValueError(f"the Lion kernels take CUDA tensors, got one on "
                             f"{dev}")
        local = [True] * len(params) if local is None else local
        self.device = dev
        self.numels = [p.numel() for p in params]
        first, owner = chunk_layout(self.numels)
        rows = []
        for i, (p, m) in enumerate(zip(params, moments)):
            for t, what in ((p, "parameters"), (m, "moments")):
                if t.device != dev or not t.is_contiguous():
                    raise ValueError(f"leaf {i}: the Lion kernels take "
                                     f"contiguous {what} on {dev}, got "
                                     f"strides {t.stride()} on {t.device}")
            if m.shape != p.shape:
                raise ValueError(f"leaf {i}: moment {tuple(m.shape)} for a "
                                 f"parameter {tuple(p.shape)}")
            meta = (int(first[i]) | _code(p, "parameters") << 32
                    | _code(m, "moments") << 40 | int(bool(decay[i])) << 48
                    | int(bool(local[i])) << 49)
            rows.append((p.data_ptr(), m.data_ptr(), p.numel(), meta))
        self.ptrs = self.pointers(params, moments)
        self.leaves = len(rows)
        self.chunks = int(owner.size)
        self.table = torch.empty((self.leaves, 4), dtype=torch.int64,
                                 device=dev)
        _upload(self.table, rows)
        self.chunk_leaf = torch.empty(max(self.chunks, 1), dtype=torch.int32,
                                      device=dev)
        if self.chunks:
            _upload(self.chunk_leaf[:self.chunks], owner)
        self.gtab = torch.empty(2 * self.leaves, dtype=torch.int64,
                                device=dev)
        self.partial = torch.empty(max(self.chunks, 1), dtype=torch.float32,
                                   device=dev)
        self.leaf_sq = torch.empty(self.leaves, dtype=torch.float32,
                                   device=dev)
        self._keep: List[torch.Tensor] = []

    @staticmethod
    def pointers(params, moments) -> tuple:
        return tuple(t.data_ptr() for t in params) + \
            tuple(t.data_ptr() for t in moments)

    def current(self, params, moments) -> bool:
        """Whether the table still points at these tensors."""
        return self.pointers(params, moments) == self.ptrs

    def grads(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Send a step's gradients (one a leaf, in order; None where a leaf
        got none) to the table's card."""
        if len(grads) != self.leaves:
            raise ValueError(f"{len(grads)} gradients for {self.leaves} "
                             f"leaves")
        index = self.device.index
        ptrs, codes, keep = [], [], []
        for i, (g, n) in enumerate(zip(grads, self.numels)):
            if g is None:
                ptrs.append(0)
                codes.append(_NO_GRAD)
                continue
            codes.append(_code(g, "gradients"))
            if g.numel() != n or not g.is_cuda or g.get_device() != index:
                raise ValueError(f"leaf {i}: a gradient of {g.numel()} "
                                 f"elements on {g.device} for {n} on "
                                 f"{self.device}")
            if not g.is_contiguous():
                g = g.contiguous()
                keep.append(g)
            ptrs.append(g.data_ptr())
        # a copy made here is read by the launches after this call
        self._keep = keep
        _upload(self.gtab, ptrs + codes)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lion_norm(table: LeafTable) -> torch.Tensor:
    """Launches 1 and 2 over the gradients last sent (``table.grads``): a
    new (2,) float32 tensor on the card, the global norm and the sum of
    squares of the local leaves; each leaf's sum of squares in
    ``table.leaf_sq``."""
    from kosmosx_torch.ops import _build

    lib = _build.library()
    out = torch.empty(2, dtype=torch.float32, device=table.device)
    stream = _stream(out)
    err = lib.kx_lion_sumsq(
        table.table.data_ptr(), table.chunk_leaf.data_ptr(),
        table.gtab.data_ptr(), table.partial.data_ptr(), table.leaves,
        table.chunks, CHUNK, stream)
    _build.check(lib, err, "kx_lion_sumsq launch")
    lion.launches += 1
    err = lib.kx_lion_finish(table.table.data_ptr(), table.partial.data_ptr(),
                             table.leaf_sq.data_ptr(), out.data_ptr(),
                             table.leaves, CHUNK, stream)
    _build.check(lib, err, "kx_lion_finish launch")
    lion.launches += 1
    return out


def lion(table: LeafTable, norm: torch.Tensor, *, lr: float, b1: float,
         b2: float, weight_decay: float, max_norm: Optional[float]) -> None:
    """Launch 3: every leaf's p and m in place over the gradients last sent,
    clipped by the 0-d float32 ``norm`` on the card (no clipping with
    ``max_norm`` None)."""
    from kosmosx_torch.ops import _build

    if norm.dtype != torch.float32 or norm.device != table.device \
            or norm.numel() != 1:
        raise ValueError(f"the norm must be one float32 value on "
                         f"{table.device}, got {norm.dtype} "
                         f"{tuple(norm.shape)} on {norm.device}")
    lib = _build.library()
    err = lib.kx_lion_update(
        table.table.data_ptr(), table.chunk_leaf.data_ptr(),
        table.gtab.data_ptr(), norm.data_ptr(), table.leaves, table.chunks,
        CHUNK, -lr, b1, 1 - b1, b2, 1 - b2, weight_decay,
        0.0 if max_norm is None else max_norm, int(bool(weight_decay)),
        int(max_norm is not None), _stream(norm))
    _build.check(lib, err, "kx_lion_update launch")
    lion.launches += 1
    lion.leaves += table.leaves


# kernel launches (three a step: sums, finish, update) and the leaves the
# updates covered (a step adds its leaf count)
lion.launches = 0
lion.leaves = 0
