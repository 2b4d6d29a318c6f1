"""The LFM2 gated short convolution: the CUDA kernel ``kx_short_conv`` of
``csrc/lfm2.cu`` and its plain PyTorch version.

The JAX package has no LFM2 model, so this replaces no Pallas kernel. In
plain torch the conv mixer's middle is a chain of chunk, multiply,
transpose, depthwise ``conv1d``, multiply and transpose: each of those
launches moves the (T, D) activations again. The kernel reads ``in_proj``'s
(T, 3 D) output and the (D, 3) taps once and writes (T, D):

    B, C, x~ = bcx[:, :D], bcx[:, D:2D], bcx[:, 2D:]
    y[t] = C[t] * (taps[:, 0] * (B x~)[t - 2] + taps[:, 1] * (B x~)[t - 1]
                   + taps[:, 2] * (B x~)[t])

in fp32, one rounding to the input dtype, with (B x~) taken as 0 before
the first position of each sequence: the rows are sequences of ``seq_len``
positions back to back (a (B, L) batch flattened, one document a row).
That is the published ``Lfm2ShortConv``: a causal depthwise ``Conv1d`` of
kernel 3 with two zeros of left padding, no bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kosmosx_torch.utils import trace

TAPS = 3


def short_conv_plain(bcx: torch.Tensor, taps: torch.Tensor,
                     seq_len: int) -> torch.Tensor:
    """The kernel's function in plain torch, fp32 math: (T, D) from bcx (T,
    3 D) and taps (D, 3), sequences of ``seq_len`` rows."""
    t, d3 = bcx.shape
    d = d3 // 3
    x32 = bcx.float().view(t // seq_len, seq_len, 3, d)
    b, c, xt = x32.unbind(2)
    bx = (b * xt).transpose(1, 2)                       # (batch, D, L)
    conv = F.conv1d(bx, taps.float()[:, None, :], groups=d,
                    padding=TAPS - 1)[..., :seq_len]
    return (c * conv.transpose(1, 2)).reshape(t, d).to(bcx.dtype)


def _check(bcx: torch.Tensor, taps: torch.Tensor, seq_len: int) -> None:
    if bcx.dtype not in (torch.float32, torch.bfloat16) \
            or taps.dtype != bcx.dtype:
        raise TypeError(f"short_conv takes float32 or bfloat16 bcx and taps "
                        f"of its dtype; got {bcx.dtype}, {taps.dtype}")
    if bcx.dim() != 2 or bcx.shape[1] % 3:
        raise ValueError(f"bcx must be (T, 3 D); got {tuple(bcx.shape)}")
    d = bcx.shape[1] // 3
    if tuple(taps.shape) != (d, TAPS):
        raise ValueError(f"taps must be ({d}, {TAPS}); got "
                         f"{tuple(taps.shape)}")
    if seq_len <= 0 or bcx.shape[0] % seq_len:
        raise ValueError(f"{bcx.shape[0]} rows are not whole sequences of "
                         f"{seq_len}")


def _check_cuda(bcx: torch.Tensor, taps: torch.Tensor) -> None:
    d = bcx.shape[1] // 3
    if bcx.dtype != torch.bfloat16:
        raise TypeError(f"the short_conv kernel takes bfloat16 (the plain "
                        f"version runs float32 on the CPU); got {bcx.dtype}")
    if taps.device != bcx.device:
        raise ValueError(f"taps on {taps.device}, bcx on {bcx.device}")
    if d % 8 or not bcx.is_contiguous() or not taps.is_contiguous() \
            or bcx.data_ptr() % 16:
        raise ValueError(f"the short_conv kernel takes contiguous, 16-byte "
                         f"aligned tensors and a width that is a multiple "
                         f"of 8; got width {d}")


def short_conv(bcx: torch.Tensor, taps: torch.Tensor,
               seq_len: int) -> torch.Tensor:
    """The gated short convolution over (T, 3 D) rows of ``in_proj``'s
    output: the kernel inside an ``op.short_conv`` span on a CUDA tensor,
    ``short_conv_plain`` on a CPU one. The kernel takes bfloat16, the
    plain version float32 too."""
    _check(bcx, taps, seq_len)
    if bcx.device.type == "cpu":
        return short_conv_plain(bcx, taps, seq_len)
    if bcx.device.type != "cuda":
        raise ValueError(f"short_conv runs on cpu or cuda, not {bcx.device}")
    from kosmosx_torch.ops import _build

    _check_cuda(bcx, taps)
    t, d = bcx.shape[0], bcx.shape[1] // 3
    with trace.span("op.short_conv", device=True) as sp:
        if sp.on:
            sp.set(rows=t, width=d, taps=TAPS, itemsize=bcx.element_size())
        y = torch.empty((t, d), device=bcx.device, dtype=bcx.dtype)
        if t:
            lib = _build.library()
            err = lib.kx_short_conv(
                bcx.data_ptr(), taps.data_ptr(), y.data_ptr(), t, d, seq_len,
                torch.cuda.current_stream(bcx.device).cuda_stream)
            _build.check(lib, err, "kx_short_conv launch")
            short_conv.launches += 1
        return y


# kernel launches on CUDA tensors (plain-version calls are not counted)
short_conv.launches = 0
