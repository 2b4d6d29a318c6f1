"""NN primitives over parameter trees (counterpart of kosmosx_tpu/nn/layers.py).

Each ``init_*`` returns a nested dict of fp32 tensors (wrapped into a
``ParamTree`` by the model); each apply function takes that tree and casts to
the compute dtype itself, as the JAX functions do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import not_ported


def init_linear(gen, in_dim: int, out_dim: int, *, bias: bool = True,
                gain: float = 1.0, device=None):
    params = {"w": init.xavier_uniform(gen, (in_dim, out_dim), gain, device)}
    if bias:
        params["b"] = init.zeros((out_dim,), device)
    return params


def dense_weight(w: torch.Tensor, dtype=None) -> torch.Tensor:
    """The dense weight in ``dtype`` (kosmosx_tpu/nn/layers.py:63; the W8
    ``{"q","scale"}`` form is ROADMAP.md Queue 1 item 7)."""
    return w.to(dtype) if dtype is not None else w


def linear(params, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """y = x @ w (+ b), weights stored ``(in, out)``: the dense branch of
    kosmosx_tpu/nn/layers.py:74-131."""
    w = params["w"]
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
    y = x @ w
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
    (kosmosx_tpu/nn/layers.py:145-154)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def init_embedding(gen, num_embeddings: int, dim: int, *,
                   padding_idx: Optional[int] = None, device=None):
    table = init.embedding_init(gen, (num_embeddings, dim), device)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return {"table": table}


def embedding(params, ids: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Plain gather (kosmosx_tpu/nn/layers.py:169)."""
    table = params["table"]
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


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """Identity when ``rng`` is None or ``rate`` is 0, as
    kosmosx_tpu/nn/layers.py:244; dropout itself belongs to training."""
    if rng is None or rate <= 0.0:
        return x
    raise not_ported("dropout with an rng", "Queue 1 item 6")

