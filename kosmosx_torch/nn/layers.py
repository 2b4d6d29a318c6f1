"""NN primitives over parameter trees (counterpart of kosmosx_tpu/nn/layers.py).

Each ``init_*`` returns a nested dict of fp32 tensors (wrapped into a
``ParamTree`` by the model); each apply function takes that tree and casts to
the compute dtype itself, as the JAX functions do.

Weight-only int8 (``utils/quantize.py``): a linear weight may be ``{"q":
int8 (in, out), "scale": fp32 (1, out)}``, or a stacked layer's marker
``{"q": (L, in, out), "scale": (L, 1, out), "layer"}``, and an embedding
table ``{"q": int8 (V, D), "scale": fp32 (V, 1)}``.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.ops import layer_norm as ln_ops


def init_linear(gen, in_dim: int, out_dim: int, *, bias: bool = True,
                gain: float = 1.0, device=None):
    params = {"w": init.xavier_uniform(gen, (in_dim, out_dim), gain, device)}
    if bias:
        params["b"] = init.zeros((out_dim,), device)
    return params


# W8 matmul kernel switch (kosmosx_tpu/nn/layers.py:44-60). "auto": the
# kernels of ops/quant_matmul.py for CUDA tensors, the plain expression for
# CPU ones; "on": the kernels, and a CPU tensor raises; "off": the plain
# expression everywhere. JAX defaults to "off" from a measurement on its TPU;
# on the H100 the default is "auto" (PERF.md).
_W8_KERNEL_MODE = "auto"


def set_w8_kernel(mode: str) -> None:
    """mode: "auto" | "on" | "off"."""
    global _W8_KERNEL_MODE
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"bad w8 kernel mode: {mode!r}")
    _W8_KERNEL_MODE = mode


def _use_w8_kernel(x: torch.Tensor) -> bool:
    if _W8_KERNEL_MODE == "off":
        return False
    if x.device.type == "cuda":
        return True
    if _W8_KERNEL_MODE == "on":
        raise ValueError(f"set_w8_kernel('on') runs the W8 kernels, which "
                         f"take CUDA tensors; x is on {x.device}")
    return False


def _is_w8(w) -> bool:
    return not isinstance(w, torch.Tensor) and "q" in w


def dense_weight(w, dtype=None) -> torch.Tensor:
    """The dense weight in ``dtype`` from a tensor or a W8 ``{"q",
    "scale"}`` (kosmosx_tpu/nn/layers.py:63-71)."""
    if _is_w8(w):
        dt = dtype or torch.float32
        return w["q"].to(dt) * w["scale"].to(dt)
    return w.to(dtype) if dtype is not None else w


def _w8_linear(w, x: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale`` of a W8 weight or stacked marker
    (kosmosx_tpu/nn/layers.py:89-107)."""
    from kosmosx_torch.ops import quant_matmul as qm

    if _use_w8_kernel(x):
        if "layer" in w:
            return qm.w8_matmul_stacked(x, w["q"], w["scale"], w["layer"])
        return qm.w8_matmul(x, w["q"], w["scale"])
    q, scale = w["q"], w["scale"]
    if "layer" in w:
        li = w["layer"].reshape(1).long()
        q, scale = q.index_select(0, li)[0], scale.index_select(0, li)[0]
    return qm.w8_matmul_plain(x, q, scale)


def linear(params, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """y = x @ w (+ b), weights stored ``(in, out)``, dense or W8
    (kosmosx_tpu/nn/layers.py:74-131).

    LoRA: ``params["lora"] = {"a": (in, r), "b": (r, out), "scale"}``
    adds ``scale * (x @ a) @ b`` after the dense or W8 product (W8 + LoRA
    is QLoRA), before the bias. Per-row factors ``a`` (B, in, r), ``b``
    (B, r, out) and ``scale`` (B,) on a (B, L, in) ``x`` give every row its
    own adapter (multi-LoRA serving)."""
    w = params["w"]
    if dtype is not None:
        x = x.to(dtype)
    if _is_w8(w):
        y = _w8_linear(w, x)
    else:
        y = x @ (w.to(dtype) if dtype is not None else w)
    if "lora" in params:
        lora = params["lora"]
        a, bl = lora["a"].to(x.dtype), lora["b"].to(x.dtype)
        scale = lora["scale"].to(x.dtype)
        if a.ndim == 3 and x.ndim == 3:
            d = torch.einsum("blr,bro->blo", torch.einsum("bli,bir->blr", x, a),
                             bl)
            y = y + d * scale[:, None, None]
        else:
            y = y + ((x @ a) @ bl) * scale
    if "b" in params:
        b = params["b"]
        y = y + (b.to(dtype) if dtype is not None else b)
    return y


def init_layer_norm(dim: int, *, bias: bool = True, device=None):
    params = {"scale": init.ones((dim,), device)}
    if bias:
        params["bias"] = init.zeros((dim,), device)
    return params


def layer_norm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 math whatever the input dtype
    (kosmosx_tpu/nn/layers.py:145-154): the plain expression on a CPU
    tensor, the kernels of ``ops/layer_norm.py`` on a CUDA tensor."""
    bias = params["bias"] if "bias" in params else None
    return ln_ops.layer_norm(x, params["scale"], bias, eps=eps)


def init_embedding(gen, num_embeddings: int, dim: int, *,
                   padding_idx: Optional[int] = None, device=None):
    table = init.embedding_init(gen, (num_embeddings, dim), device)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return {"table": table}


def embedding(params, ids: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Plain gather; an int8 table gathers codes and per-row scales and
    multiplies them (kosmosx_tpu/nn/layers.py:169-182)."""
    table = params["table"]
    if _is_w8(table):
        rows = table["q"][ids].to(dtype or torch.float32)
        return rows * table["scale"][ids].to(rows.dtype)
    if dtype is not None:
        table = table.to(dtype)
    return table[ids]


def init_positional_embedding(gen, max_positions: int, dim: int, *,
                              padding_idx: int = 1, device=None):
    return init_embedding(gen, max_positions, dim, padding_idx=padding_idx,
                          device=device)


def positional_embedding(params, seq_len: int, *, padding_idx: int = 1,
                         offset=0, dtype=None) -> torch.Tensor:
    """Rows ``padding_idx + 1 + offset + arange(L)`` of the learned table
    (kosmosx_tpu/nn/layers.py:193-212). An int ``offset`` past the table
    raises; a tensor offset (per-row decode positions) is the caller's to
    bound, as in JAX."""
    table = params["table"]
    if _is_w8(table):
        table = table["q"]
    rows = table.shape[0]
    if isinstance(offset, int):
        last = padding_idx + 1 + offset + seq_len - 1
        if last >= rows:
            raise ValueError(
                f"sequence length {seq_len} (+offset {offset}) needs position "
                f"index {last} but the learned table has {rows} rows (usable "
                f"length = rows - padding_idx - 1 = {rows - padding_idx - 1}); "
                f"raise max_positions")
    positions = padding_idx + 1 + offset + torch.arange(
        seq_len, device=table.device)
    return embedding(params, positions, dtype=dtype)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def activation_fn(name: str):
    """kosmosx_tpu/nn/layers.py:219."""
    if name == "gelu":
        return F.gelu
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu_fast":
        from kosmosx_torch.ops.fast_gelu import gelu_fast
        return gelu_fast
    if name == "quick_gelu":
        return _quick_gelu
    if name == "relu":
        return F.relu
    if name in ("silu", "swish"):
        return F.silu
    raise ValueError(f"unknown activation: {name}")


# ---------------------------------------------------------------------------
# dropout (kosmosx_tpu/nn/layers.py:244-249) on integer keys
# ---------------------------------------------------------------------------
#
# JAX threads a key through the model and splits it; here a key is a host
# integer, and ``fold_in`` derives sub-keys from it. Every mask is drawn
# from a fresh generator seeded with its key, so a layer that activation
# checkpointing recomputes in the backward draws the same masks again,
# whatever the state of any generator by then (torch.utils.checkpoint
# restores only the global RNG states, never an explicit generator's).


def _digest(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little") >> 1


def rng_key(rng: Optional[torch.Generator]) -> Optional[int]:
    """A key hashed from the state of the generator ``rng`` (None for None),
    which it then advances (one draw on its device), so the next call gives
    another key. Reading the state reads no device memory: a CUDA
    generator's state is its seed and offset on the host."""
    if rng is None:
        return None
    key = _digest(rng.get_state().numpy().tobytes())
    torch.empty((), device=rng.device).uniform_(generator=rng)
    return key


def fold_in(key: Optional[int], i: int) -> Optional[int]:
    """The ``i``-th sub-key of ``key`` (None stays None)."""
    if key is None:
        return None
    return _digest(key.to_bytes(8, "little") + int(i).to_bytes(8, "little"))


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[int]) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)``, zero the rest (kosmosx_tpu/nn/layers.py:244-249),
    with the mask drawn from the key ``rng``; the identity when ``rng`` is
    None or ``rate`` is 0."""
    if rng is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(rng)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
