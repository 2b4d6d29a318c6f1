"""Video towers (counterpart of kosmosx_tpu/nn/video.py): clip (B, 3, T, H, W)
-> pooled clip embedding (B, hidden_dim).

``arch="lean"``: a LayerNorm ResNet with stride-2 stages and XLA "SAME"
padding. At stride 2 that padding is asymmetric (low side
``floor(total / 2)``, high side the rest), which torch's symmetric
``padding=`` cannot express and ``padding="same"`` refuses, so the tower
pads explicitly (``F.pad``) and then convolves without padding.
``arch="r3d18"``: torchvision's r3d_18 topology without its head, its
BatchNorms folded into the convs at conversion
(``utils/hf_convert.r3d18_params_from_state_dict``), with torchvision's
symmetric pads.

Layout: the tree keeps JAX's DHWIO kernels ``(kt, kh, kw, cin, cout)``, so
the carry-over from JAX stays a copy by path; each conv permutes its kernel
to torch's ``(cout, cin, kt, kh, kw)`` at the call. Activations are
channels-last, (B, T, H, W, C) as in JAX: permuted to NCDHW for the conv
they are a view in torch's ``channels_last_3d`` memory format, so cuDNN
takes them without a copy and returns channels-last output, and the
LayerNorms, biases and pooling read contiguous channel rows. The 3-D convs
are library calls (``F.conv3d``), as JAX's are XLA convolutions outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import VideoConfig
from kosmosx_torch.nn import layers

_R3D18_PLANES = (64, 128, 256, 512)


def _conv3d_init(gen, k: Tuple[int, int, int], cin: int, cout: int,
                 device=None):
    """He-normal kernel, zero bias (kosmosx_tpu/nn/video.py:25-28)."""
    fan_in = cin * k[0] * k[1] * k[2]
    return {"w": init.normal(gen, k + (cin, cout), std=(2.0 / fan_in) ** 0.5,
                             device=device),
            "b": init.zeros((cout,), device)}


def _same_pads(x: torch.Tensor, kernel: Sequence[int],
               stride: Sequence[int]) -> Tuple[int, ...]:
    """XLA "SAME" pads of a (B, T, H, W, C) input as ``F.pad`` takes them
    for its NCDHW view: (w_lo, w_hi, h_lo, h_hi, t_lo, t_hi)."""
    pads = []
    for n, k, s in zip(x.shape[1:4], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


def _conv3d(p, x: torch.Tensor, stride: Tuple[int, int, int], dtype,
            padding=None) -> torch.Tensor:
    """x (B, T, H, W, C), kernel (kt, kh, kw, cin, cout) -> (B, T', H', W',
    cout). ``padding``: torch's symmetric (pt, ph, pw), or None for XLA
    "SAME"."""
    w = layers.dense_weight(p["w"], dtype)
    xc = x.to(dtype).permute(0, 4, 1, 2, 3)
    if padding is None:
        xc = F.pad(xc, _same_pads(x, w.shape[:3], stride))
        padding = 0
    out = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=stride,
                   padding=padding)
    return out.permute(0, 2, 3, 4, 1) + p["b"].to(dtype)


def init_r3d18(gen, device=None) -> Dict[str, Any]:
    """Random init in the converter's layout, BatchNorms folded as identity
    (kosmosx_tpu/nn/video.py:57-79)."""
    params: Dict[str, Any] = {
        "stem": _conv3d_init(gen, (3, 7, 7), 3, 64, device)}
    stages = []
    cin = 64
    for planes in _R3D18_PLANES:
        blocks = []
        for b in range(2):
            blocks.append({
                "conv1": _conv3d_init(gen, (3, 3, 3), cin, planes, device),
                "conv2": _conv3d_init(gen, (3, 3, 3), planes, planes, device),
                "down": (_conv3d_init(gen, (1, 1, 1), cin, planes, device)
                         if b == 0 and cin != planes else None),
            })
            cin = planes
        stages.append(blocks)
    params["stages"] = stages
    return params


def r3d18_encoder(params, clips: torch.Tensor,
                  cfg: VideoConfig) -> torch.Tensor:
    """clips (B, 3, T, H, W) -> (B, 512) (kosmosx_tpu/nn/video.py:82-102)."""
    dtype = cfg.dtype
    p3 = (1, 1, 1)
    x = clips.permute(0, 2, 3, 4, 1)  # channels-last
    x = F.relu(_conv3d(params["stem"], x, (1, 2, 2), dtype, padding=(1, 3, 3)))
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = (2, 2, 2) if si > 0 and bi == 0 else (1, 1, 1)
            h = F.relu(_conv3d(blk["conv1"], x, stride, dtype, padding=p3))
            h = _conv3d(blk["conv2"], h, (1, 1, 1), dtype, padding=p3)
            res = x
            if blk["down"] is not None:
                res = _conv3d(blk["down"], x, stride, dtype, padding=(0, 0, 0))
            x = F.relu(h + res)
    return x.mean(dim=(1, 2, 3))


def init_video_encoder(gen, cfg: VideoConfig, device=None) -> Dict[str, Any]:
    """kosmosx_tpu/nn/video.py:105-131."""
    if cfg.arch == "r3d18":
        if cfg.hidden_dim != 512:
            raise ValueError("arch='r3d18' is the torchvision topology: "
                             "hidden_dim must be 512")
        return init_r3d18(gen, device)
    widths = [64, 128, 256, cfg.hidden_dim]
    params: Dict[str, Any] = {
        "stem": _conv3d_init(gen, (3, 7, 7), 3, widths[0], device),
        "stem_ln": layers.init_layer_norm(widths[0], device=device),
    }
    blocks = []
    cin = widths[0]
    for w in widths:
        blocks.append({
            "conv1": _conv3d_init(gen, (3, 3, 3), cin, w, device),
            "ln1": layers.init_layer_norm(w, device=device),
            "conv2": _conv3d_init(gen, (3, 3, 3), w, w, device),
            "ln2": layers.init_layer_norm(w, device=device),
            "skip": (_conv3d_init(gen, (1, 1, 1), cin, w, device)
                     if cin != w else None),
        })
        cin = w
    params["blocks"] = blocks
    return params


def video_encoder(params, clips: torch.Tensor,
                  cfg: VideoConfig) -> torch.Tensor:
    """clips (B, 3, T, H, W) -> (B, hidden_dim) (kosmosx_tpu/nn/video.py:
    134-159)."""
    if cfg.arch == "r3d18":
        return r3d18_encoder(params, clips, cfg)
    dtype = cfg.dtype
    x = clips.permute(0, 2, 3, 4, 1)  # channels-last
    x = _conv3d(params["stem"], x, (1, 2, 2), dtype)
    x = F.relu(layers.layer_norm(params["stem_ln"], x))
    for i, blk in enumerate(params["blocks"]):
        stride = (1, 1, 1) if i == 0 else (2, 2, 2)
        h = _conv3d(blk["conv1"], x, stride, dtype)
        h = F.relu(layers.layer_norm(blk["ln1"], h))
        h = _conv3d(blk["conv2"], h, (1, 1, 1), dtype)
        h = layers.layer_norm(blk["ln2"], h)
        res = x
        if blk["skip"] is not None:
            res = _conv3d(blk["skip"], x, stride, dtype)
        elif stride != (1, 1, 1):
            res = x[:, ::stride[0], ::stride[1], ::stride[2]]
        x = F.relu(h + res)
    return x.mean(dim=(1, 2, 3))
