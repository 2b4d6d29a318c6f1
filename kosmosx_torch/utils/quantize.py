"""Weight-only int8 quantization for inference (W8), counterpart of
kosmosx_tpu/utils/quantize.py.

Linear weights get per-output-channel int8 codes, ``{"q": int8 (…, in, out),
"scale": fp32 (…, 1, out)}``; embedding tables per-row ones, ``{"q": int8
(…, V, D), "scale": fp32 (…, V, 1)}``. The codes and scales are
bit-identical to the JAX package's: for a bf16 weight, ``absmax / 127`` and
the zero guard round to bf16 before the scale becomes fp32, and ``w / scale``
runs in fp32. ``nn/layers.py`` consumes the quantized leaves: ``linear``
through the W8 kernels of ``ops/quant_matmul.py``, ``embedding`` and
``dense_weight`` by gathering and rescaling.

Quantize after the cast to the compute dtype, as the JAX CLIs do
(``init_casted``, then ``quantize_params_w8``), and never call ``.to(dtype)``
or ``.to(device)`` on a W8 model: the first casts the fp32 scales, the second
unshares the stacked codes. Build the model on its device first.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from kosmosx_torch.core.params import ParamTree, to_tree
from kosmosx_torch.nn.moe import find_moe_ffn


# the W8 kernels' TMA loads need code rows that start a multiple of 16
# bytes apart
CODE_PITCH = 16


def pitched_codes(q: torch.Tensor) -> torch.Tensor:
    """int8 codes (…, K, N) with N not a multiple of ``CODE_PITCH`` as the
    (…, K, N) view of a zero-padded (…, K, round_up(N, 16)) buffer: the same
    values and shape, rows 16-byte aligned (the vocab head's (2048, 32002)
    takes the Hopper W8 kernel so). Other codes come back as they are.
    ``.contiguous()``, ``.clone()`` or a move to another device gives a dense
    copy again: make the pitch where the codes last land."""
    n = q.shape[-1]
    if n % CODE_PITCH == 0:
        return q
    buf = q.new_zeros(*q.shape[:-1], -(-n // CODE_PITCH) * CODE_PITCH)
    buf[..., :n] = q
    return buf[..., :n]


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 rounded once, as JAX and the CPU compute it. The divisor is a
    0-d tensor filled on x's device (no host copy, so no sync): CUDA
    divides by a Python scalar as a product with its reciprocal, which
    misses the quotient by an ulp for some fp32 inputs (318 of 8192 scales
    of a (2048, 8192) weight on an H100)."""
    return x / x.new_full((), 127.0)


def _div255(x: torch.Tensor) -> torch.Tensor:
    """x / 255 rounded once, on the card too (as ``_div127``)."""
    return x / x.new_full((), 255.0)


def _quantize_w(w: torch.Tensor):
    """(…, in, out) -> {"q": int8, "scale": (…, 1, out)} per output channel,
    reducing over the contraction axis only, so stacked (L, in, out) weights
    get per-layer scales (kosmosx_tpu/utils/quantize.py:25-32). The codes
    of a 2-D weight whose ``out`` is not a multiple of 16 get a padded row
    pitch (``pitched_codes``); their values are JAX's."""
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax == 0, 1.0, _div127(absmax)).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": pitched_codes(q) if q.ndim == 2 else q, "scale": scale}


def _quantize_table(t: torch.Tensor):
    """(…, V, D) -> {"q": int8, "scale": (…, V, 1)} per row
    (kosmosx_tpu/utils/quantize.py:35-41)."""
    absmax = t.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, 1.0, _div127(absmax)).to(torch.float32)
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


_QUANTIZERS = {"w": _quantize_w, "table": _quantize_table}


def _eligible(shape, dtype: torch.dtype, key, min_size: int) -> bool:
    """JAX's leaf rule: a floating "w" or "table" leaf of ndim >= 2 and at
    least ``min_size`` elements."""
    return (key in _QUANTIZERS and len(shape) >= 2 and dtype.is_floating_point
            and torch.Size(shape).numel() >= min_size)


def _quantize_tree(tree: Any, min_size: int, key=None) -> Any:
    if isinstance(tree, dict):
        return {k: _quantize_tree(v, min_size, k) for k, v in tree.items()}
    if isinstance(tree, list):  # a list index is no "w" or "table" key
        return [_quantize_tree(v, min_size) for v in tree]
    if isinstance(tree, torch.Tensor) and _eligible(tree.shape, tree.dtype,
                                                    key, min_size):
        return _QUANTIZERS[key](tree.detach())
    return tree


def _quantize_stacked(items: list, min_size: int, key=None) -> list:
    """The same subtree of every layer of a ``scan_layers`` stack -> the
    quantized subtree of every layer. A leaf is judged as the stacked
    (L, …) leaf of the JAX layout; a quantized one becomes one pair of
    (L, …) code and scale parameters shared by all layers, and each layer
    gets the marker ``{"q", "scale", "layer": i}``
    (kosmosx_tpu/nn/decoder.py:292-305)."""
    first = items[0]
    if isinstance(first, dict):
        per_key = {k: _quantize_stacked([it[k] for it in items], min_size, k)
                   for k in first}
        return [{k: v[i] for k, v in per_key.items()} for i in range(len(items))]
    if not (isinstance(first, torch.Tensor) and _eligible(
            (len(items),) + tuple(first.shape), first.dtype, key, min_size)):
        return items
    # layer by layer: the same codes as the stacked leaf (each scale reduces
    # within one layer) without a stacked copy in the original dtype
    parts = [_QUANTIZERS[key](t.detach()) for t in items]
    shared = {k: nn.Parameter(torch.stack([p[k] for p in parts]),
                              requires_grad=False) for k in ("q", "scale")}
    return [dict(shared, layer=i) for i in range(len(items))]


def quantize_params_w8(params: Any, *, min_size: int = 4096) -> Any:
    """Quantize every linear weight (leaf "w") and embedding table (leaf
    "table") of ndim >= 2 and at least ``min_size`` elements to weight-only
    int8; everything else keeps its dtype (kosmosx_tpu/utils/quantize.py:
    44-62).

    ``params`` is a model (``Kosmos``, ``KosmosLanguage``) or a nested
    dict/list tree of tensors; the result is of the same kind, a model with
    the same config. A model whose decoder config has ``scan_layers=True``
    gets the stacked layout that ``from_jax_params`` gives a JAX stacked W8
    tree: each decoder weight's codes and scales stacked over the layers,
    held once, and a layer-index marker in every layer. The leaves it leaves
    unquantized are shared with ``params``.

    An MoE decoder raises a ``ValueError``: JAX quantizes its 3-D expert
    stacks into ``{"q", "scale"}`` dicts that its ``moe_ffn`` cannot read
    (kosmosx_tpu/nn/moe.py:174,183), so there is no W8 MoE to port."""
    moe = find_moe_ffn(to_tree(params) if isinstance(params, ParamTree)
                       else params)
    if moe is not None:
        raise ValueError(
            f"W8 quantization of an MoE decoder ({moe}): the expert stacks "
            f"have no W8 path (JAX's moe_ffn reads them as dense arrays)")
    if not isinstance(params, ParamTree):
        return _quantize_tree(params, min_size)
    cfg = params.config
    tree = to_tree(params)
    decoder = (lambda t: t["decoder"]) if hasattr(cfg, "decoder") else \
        (lambda t: t)
    stacked = getattr(cfg, "decoder", cfg).scan_layers
    if stacked:
        layer_trees, decoder(tree)["layers"] = decoder(tree)["layers"], []
    out = _quantize_tree(tree, min_size)
    if stacked:
        decoder(out)["layers"] = _quantize_stacked(layer_trees, min_size)
    return type(params)(cfg, params=out)


def w8_param_bytes(params: Any) -> int:
    """Bytes of every parameter, a shared stacked tensor counted once."""
    if isinstance(params, nn.Module):
        return sum(p.numel() * p.element_size() for p in params.parameters())
    if isinstance(params, dict):
        return sum(w8_param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(w8_param_bytes(v) for v in params)
    return params.numel() * params.element_size() \
        if isinstance(params, torch.Tensor) else 0
