"""The LayerNorm of ``kosmosx_torch/ops/layer_norm.py`` on the CPU.

A CPU tensor runs the plain versions: the forward is the JAX package's
jnp LayerNorm (kosmosx_tpu/nn/layers.py:145-154) op for op, the backward
the closed form the CUDA kernel implements, held here against autograd of
the forward in fp32 (1e-5 of each gradient's largest value). The kernels
themselves, which take CUDA tensors alone, are compared with these plain
versions on the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``
phase 4b).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kosmosx_torch.nn import layers as tlayers
from kosmosx_torch.ops import layer_norm as tln
from kosmosx_torch.ops import roofline as rl
from kosmosx_torch.utils import trace
from kosmosx_tpu.nn import layers as jlayers

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _inputs(shape, *, bias=True, seed=0, dtype=torch.float32):
    """x with a mean far from 0 (a one-pass variance would lose it), the
    scale and the bias, fp32 leaves needing gradients."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2 + 3).to(dtype)
    w = shape[-1]
    scale = torch.randn(w, generator=g) + 1
    b = torch.randn(w, generator=g) if bias else None
    return x, scale, b


def _rel(a, ref):
    return float((a.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def _counters():
    return tln.layer_norm.launches, tln.layer_norm_bwd.launches


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("width", [1, 7, 64, 2048])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_bwd_plain_matches_autograd(bias, width, eps):
    """dx, dscale and dbias of the closed form equal autograd through
    ``layers.layer_norm`` in fp32, within 1e-5 of each largest value."""
    x, scale, b = _inputs((3, 5, width), bias=bias, seed=width)
    leaves = [t.requires_grad_() for t in (x, scale, b) if t is not None]
    params = {"scale": scale} if b is None else {"scale": scale, "bias": b}
    y = tlayers.layer_norm(params, x, eps=eps)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    want = torch.autograd.grad(y, leaves, dy)
    with torch.no_grad():
        mean, rstd = tln.layer_norm_stats_plain(x, eps=eps)
        got = tln.layer_norm_bwd_plain(x, scale, mean, rstd, dy, bias=b)
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for name, a, r in zip(("dx", "dscale", "dbias"), got, want):
        if r.abs().max() == 0:   # width 1: x - mean is 0, so is dx
            assert a.abs().max() == 0, name
        else:
            assert _rel(a, r) <= 1e-5, (name, _rel(a, r))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_bwd_plain_with_a_frozen_scale(bias):
    """A scale that needs no gradient: autograd gives dx (and dbias); the
    closed form without parameter gradients gives the same dx and no
    dscale (the autograd function's None for the scale is checked on the
    card)."""
    x, scale, b = _inputs((4, 64), bias=bias, seed=3)
    x.requires_grad_()
    if b is not None:
        b.requires_grad_()
    params = {"scale": scale} if b is None else {"scale": scale, "bias": b}
    y = tlayers.layer_norm(params, x)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(8))
    leaves = [t for t in (x, b) if t is not None]
    want = torch.autograd.grad(y, leaves, dy)
    with torch.no_grad():
        mean, rstd = tln.layer_norm_stats_plain(x)
        dx, ds, db = tln.layer_norm_bwd_plain(x, scale, mean, rstd, dy,
                                              bias=b, param_grads=False)
    assert ds is None and db is None
    assert _rel(dx, want[0]) <= 1e-5


@pytest.mark.parametrize("entry", ["fwd", "bwd", "autograd"])
def test_kernel_entry_points_refuse_cpu_tensors(entry):
    """``layer_norm_fwd``, ``layer_norm_bwd`` and ``LayerNorm`` are the
    kernels' entry points alone: a CPU tensor raises there (only
    ``layer_norm`` sends it to the plain version), and nothing launches."""
    x, scale, b = _inputs((2, 3, 96), seed=11)
    mean, rstd = tln.layer_norm_stats_plain(x)
    calls = {
        "fwd": lambda: tln.layer_norm_fwd(x, scale, b),
        "bwd": lambda: tln.layer_norm_bwd(x, scale, mean, rstd, x, bias=b),
        "autograd": lambda: tln.LayerNorm.apply(x.requires_grad_(), scale,
                                                b, 1e-5)}
    before = _counters()
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[entry]()
    assert _counters() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_cpu_layer_norm_matches_jax_and_launches_nothing(bias, dtype):
    """On CPU tensors ``layers.layer_norm`` equals the JAX package's
    LayerNorm at the 1e-4 parity bar in fp32 (one bf16 rounding, 2^-7, in
    bf16: the two frameworks sum in another order) and the plain expression
    bit for bit, and leaves both launch counters as they were."""
    x, scale, b = _inputs((2, 9, 160), bias=bias, seed=5, dtype=dtype)
    params = {"scale": scale} if b is None else {"scale": scale, "bias": b}
    before = _counters()
    y = tlayers.layer_norm(params, x, eps=1e-6)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    old = (x32 - mean) * torch.rsqrt(var + 1e-6) * scale.float()
    if b is not None:
        old = old + b.float()
    assert torch.equal(y, old.to(dtype))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jy = jlayers.layer_norm(jparams, jnp.asarray(x.float().numpy(), jdtype),
                            eps=1e-6)
    bar = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=bar, rtol=bar)
    assert _counters() == before


def test_stats_plain_are_the_forwards():
    """The saved (mean, rstd) are those of the forward: normalising with
    them and the scale and bias gives the plain output."""
    x, scale, b = _inputs((3, 4, 33), seed=2)
    mean, rstd = tln.layer_norm_stats_plain(x, eps=1e-5)
    assert mean.shape == rstd.shape == x.shape[:-1]
    y = (x - mean[..., None]) * rstd[..., None] * scale + b
    assert _rel(y, tln.layer_norm_plain(x, scale, b)) <= 1e-6


@pytest.mark.parametrize("case,error", [
    (dict(dtype=torch.float64), TypeError),
    (dict(width=tln.MAX_WIDTH + 1), ValueError),
    (dict(width=0), ValueError),
    (dict(scale_width=63), ValueError),
])
def test_kernel_checks_refuse_what_it_cannot_take(case, error):
    """The CUDA branch's checks (run here on CPU tensors) raise for a dtype
    or width the kernels do not take and a scale of another width."""
    width = case.get("width", 64)
    x = torch.zeros(2, width, dtype=case.get("dtype", torch.float32))
    scale = torch.ones(case.get("scale_width", width),
                       dtype=case.get("scale_dtype", torch.float32))
    bias = torch.zeros(scale.shape[0],
                       dtype=case.get("bias_dtype", scale.dtype))
    with pytest.raises(error):
        tln._check(x, scale, bias)


@pytest.mark.parametrize("x_dtype,scale_dtype,bias_dtype,want", [
    (torch.bfloat16, torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, None, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32, torch.float32),
    (torch.float16, torch.bfloat16, None, torch.float32),
])
def test_params_as_the_kernels_read_them(x_dtype, scale_dtype, bias_dtype,
                                         want):
    """The scale and bias reach the kernels as they are where both are in
    x's dtype or fp32, else both upcast to fp32 (exact, and what the plain
    version computes with): fp32 x with bf16 parameters, mixed parameters,
    fp16 x with bf16 parameters."""
    x = torch.zeros(2, 16, dtype=x_dtype)
    scale = torch.randn(16).to(scale_dtype)
    bias = None if bias_dtype is None else torch.randn(16).to(bias_dtype)
    s2, b2 = tln._params(x, scale, bias)
    assert s2.dtype == want and torch.equal(s2, scale.to(want))
    if bias is None:
        assert b2 is None
    else:
        assert b2.dtype == want and torch.equal(b2, bias.to(want))
    grads = tln._cast(s2, b2, (scale_dtype, bias_dtype))
    assert grads[0].dtype == scale_dtype
    assert (grads[1] is None) == (bias is None)
    if bias is not None:
        assert grads[1].dtype == bias_dtype


def test_rows_view_alignment_and_checks_pass():
    """``_rows`` keeps a strided row view (``x[:, 0]``) and copies only
    where the leading dims do not collapse; ``_aligned`` takes 16-byte
    vectors only where every row start is aligned and the width is whole
    chunks; the kernels' dtypes pass the checks."""
    big = torch.zeros(6, 3, 64, dtype=torch.bfloat16)
    view = tln._rows(big[:, 0])
    assert view.data_ptr() == big.data_ptr() and view.stride() == (192, 1)
    assert tln._aligned(view)
    t = big.transpose(0, 1)          # (3, 6, 64): rows not one stride apart
    rows = tln._rows(t)
    assert rows.shape == (18, 64) and rows.is_contiguous()
    assert not tln._aligned(torch.zeros(4, 100, dtype=torch.bfloat16))
    assert not tln._aligned(torch.zeros(4, 64)[:, 1:])
    assert tln._aligned(torch.zeros(4, 64), torch.ones(64), None)
    for xd, wd in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.float32),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float16, torch.float16)):
        tln._check(torch.zeros(2, 8, dtype=xd), torch.ones(8, dtype=wd),
                   torch.zeros(8, dtype=wd))


# (x dtype, width, rows, params, SMs, blocks): the plan of
# ``csrc/layer_norm.cu`` gives a row 32 to 1,024 threads of one 16-byte
# chunk (more chunks past 1,024 threads) and packs narrow rows 256 threads a
# block; an SM holds 1,024 of the backward's threads
BWD_BLOCKS = [
    (torch.bfloat16, 2048, 8184, True, 132, 132 * 4),   # 256 threads a row
    (torch.bfloat16, 2048, 8184, False, 132, 8184),
    (torch.bfloat16, 8192, 8184, True, 132, 132),       # 1,024 a row
    (torch.bfloat16, 1024, 1028, True, 132, 514),       # 2 rows a block
    (torch.bfloat16, 1024, 256, True, 132, 128),
    (torch.bfloat16, 1024, 12276, True, 132, 132 * 4),
    (torch.float32, 16384, 8184, True, 132, 132),       # 4 chunks a thread
    (torch.float32, 100, 9, True, 132, 2),              # 8 rows a block
    (torch.float16, 1, 1, True, 114, 1),
    (torch.float32, 768, 8184, True, 114, 114 * 4),     # 192 chunks: 256
]


@pytest.mark.parametrize("dtype,width,rows,params,sms,want", BWD_BLOCKS)
def test_bwd_blocks_follow_the_shape_and_the_card(monkeypatch, dtype, width,
                                                  rows, params, sms, want):
    """The backward's block count, and with it the order in which the
    parameter gradients are summed, follows the shape, the dtype and the
    card's SM count alone: the same on every call and in every process."""
    monkeypatch.setattr(tln, "_sm_count", lambda index: sms)
    x = torch.zeros(1, width, dtype=dtype)
    assert tln._bwd_blocks(x, rows, params) == want
    assert tln._bwd_blocks(x, rows, params) == want


def test_cpu_layer_norm_opens_no_span():
    """The CPU path stays as cheap on the host as it was before the
    kernels: with tracing on it records no ``op.layer_norm`` span (the
    kernel path's span is checked on the card)."""
    x, scale, b = _inputs((3, 5, 64), seed=4, dtype=torch.bfloat16)
    trace.clear()
    with trace.enable():
        with trace.span("outer"):
            tlayers.layer_norm({"scale": scale, "bias": b}, x)
    assert [r.name for r in trace.records()] == ["outer"]
    trace.clear()


@pytest.mark.parametrize("rows,width,itemsize,w_itemsize",
                         [(8184, 2048, 2, 4), (12276, 8192, 2, 2),
                          (128, 1024, 4, 4)])
def test_roofline_work_counts_each_byte_once(rows, width, itemsize,
                                             w_itemsize):
    """The forward's bound reads x and writes y once, with the parameters
    and the fp32 stats; the backward reads x and dy and writes dx, reads
    the stats and the scale and writes both parameter gradients."""
    flops, nbytes = rl.layer_norm_fwd_work(rows, width, itemsize=itemsize,
                                           w_itemsize=w_itemsize)
    assert nbytes == 2 * rows * width * itemsize + 2 * width * w_itemsize \
        + 8 * rows
    assert flops == 8 * rows * width
    flops, nbytes = rl.layer_norm_bwd_work(rows, width, itemsize=itemsize,
                                           w_itemsize=w_itemsize)
    assert nbytes == 3 * rows * width * itemsize + 3 * width * w_itemsize \
        + 8 * rows
    assert flops == 12 * rows * width
    assert rl.bound((flops, nbytes))[1] == "bytes"


def test_no_library_normalisation_is_reachable():
    """No module of ``kosmosx_torch`` calls a library normalisation:
    LayerNorm and RMSNorm go through ``ops/layer_norm.py`` alone. The
    port's own RMSNorm is named ``rms_norm`` too: only its definitions in
    that file, its kernel ``kx_rms_norm*`` and calls written
    ``ln.rms_norm(`` are let through."""
    pattern = re.compile(r"\bF\.layer_norm\b|functional\.layer_norm\b|"
                         r"nn\.LayerNorm\b|native_layer_norm|"
                         r"torch\.layer_norm\b|group_norm|rms_norm")
    own = re.compile(r"\bln\.rms_norm\(|\bkx_rms_norm\w*|"
                     r"``ops/layer_norm\.rms_norm``")
    # in ops/layer_norm.py: its own names, bare, and its span's name
    home_own = re.compile(own.pattern + r"|(?<![.\w])rms_norm\w*|"
                          r"\bop\.rms_norm\b")
    home = ROOT / "kosmosx_torch" / "ops" / "layer_norm.py"
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted((ROOT / "kosmosx_torch").rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search((home_own if p == home else own).sub("", line))]
    assert hits == []


KERNEL_NAMES = (
    "void (anonymous namespace)::kx_layer_norm_fwd_kernel<__nv_bfloat16, "
    "float, 4>(__nv_bfloat16 const*, long long, float const*, float const*, "
    "__nv_bfloat16*, float*, float*, int, int, float, bool)",
    "void (anonymous namespace)::kx_layer_norm_bwd_kernel<__nv_bfloat16, "
    "float, 2>(__nv_bfloat16 const*, long long, __nv_bfloat16 const*, long "
    "long, float const*, float const*, float const*, __nv_bfloat16*, float*, "
    "float*, int, int, bool)",
    "void (anonymous namespace)::kx_layer_norm_bwd_sum_kernel<float>(float "
    "const*, float const*, float*, float*, int, int)")


def test_kernel_names_leave_the_elementwise_groups():
    """The profile readers file every LayerNorm kernel under "other", so
    ``nn_elementwise_ms`` no longer counts LayerNorm's time, and
    ``layer_norm_ms`` finds each by its name."""
    import chip_profile
    from perfbench import trace as ptrace

    for name in KERNEL_NAMES:
        assert ptrace.group_of(name) == "other", name
        assert chip_profile.group_of(name) == "other", name


def test_layer_norm_ms_reader():
    """Device ms a profiled step of the kernels named ``kx_layer_norm``;
    None without a profile or without such kernels (a program before the
    kernels)."""
    import types

    from perfbench import harness
    from perfbench import trace as ptrace

    reader = harness.load_module(ROOT, "layer_metrics", "layer_norm_ms")
    kernels = [(0.0, 30.0, KERNEL_NAMES[0], frozenset()),
               (40.0, 100.0, KERNEL_NAMES[1], frozenset()),
               (100.0, 104.0, KERNEL_NAMES[2], frozenset()),
               (110.0, 500.0, "void at::native::elementwise_kernel<128, 2>",
                frozenset())]
    r = types.SimpleNamespace(profile=ptrace.Profile(kernels, {}, [], 1.0),
                              profile_steps=2)
    assert reader.read(r) == pytest.approx(0.047)
    assert r.profile.group_s(ptrace.ELEMENTWISE_GROUPS) == pytest.approx(
        390e-6)
    r.profile.kernels = kernels[3:]
    assert reader.read(r) is None
    assert reader.read(None) is None
