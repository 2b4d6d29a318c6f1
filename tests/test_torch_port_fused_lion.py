"""Lion over every leaf in three launches (``kosmosx_torch/ops/lion.py``,
kernels in ``csrc/optim.cu``), against the leaf path of
``train/optim.Optimizer``.

``Optimizer("lion")`` over CUDA leaves takes the kernels; over CPU leaves
it keeps the leaf path, which the CPU tests hold to optax. On the card
(marker ``cuda``; this file imports no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_fused_lion.py

Bars: given the same norm, p and m bit-identical to the leaf path's after
three steps (the kernels round where each PyTorch op rounds); the norm
within 1e-6 of a float64 norm (its sums run in another order) and
bit-identical from run to run.
"""

import numpy as np
import pytest
import torch

from kosmosx_torch.ops import lion as tlion
from kosmosx_torch.train import optim as toptim
from kosmosx_torch.utils import trace

LRS = (3e-4, 1e-3, 7e-4)   # the schedule's first three values, fp32-exact


def schedule(count):
    return float(np.float32(LRS[count % len(LRS)]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# name -> (numel, parameter dtype, gradient dtype or None): sizes that are
# no multiple of the 8-value vectors, a leaf longer than several chunks,
# decayed (two dims) and undecayed leaves, no gradient, mixed dtypes
LEAVES = {
    "a.scale": (1, torch.float32, torch.float32),
    "a.b": (3, torch.float32, torch.float32),
    "a.w": (4097, torch.float32, torch.float32),
    "big.w": (5_000_003, torch.float32, torch.float32),
    "B.w": (4097, torch.float32, None),
    "B.b": (300, torch.float32, None),
    "h.w": (4097, torch.bfloat16, torch.bfloat16),
    "h.scale": (3, torch.bfloat16, torch.bfloat16),
    "h.none": (1000, torch.bfloat16, None),
    "mix.w": (777, torch.float32, torch.bfloat16),
    "mix.v": (777, torch.bfloat16, torch.float32),
}


def make_leaves(dev, seed=0, offset=False):
    """The parameters of ``LEAVES`` on ``dev``, 2-D where their name ends in
    ``.w`` (decayed), and three steps of gradients; with ``offset`` each
    parameter starts one element into its buffer (no 16-byte vectors)."""
    g = torch.Generator().manual_seed(seed)
    params, steps = {}, [{} for _ in range(3)]
    for name, (n, dtype, gdtype) in LEAVES.items():
        shape = (n, 1) if name.endswith(".w") else (n,)
        data = torch.randn(n, generator=g).to(dtype)
        if offset:
            p = torch.empty(n + 1, dtype=dtype, device=dev)[1:].copy_(data)
        else:
            p = data.to(dev)
        params[name] = p.view(shape)
        for grads in steps:
            grads[name] = None if gdtype is None else \
                (torch.randn(shape, generator=g) * 0.01).to(gdtype).to(dev)
    return params, steps


def clone(params):
    return {n: p.clone() for n, p in params.items()}


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_cpu_leaves_never_reach_the_kernels(monkeypatch):
    """Lion over CPU tensors keeps the leaf path: no table is built, no
    launch counted, and the steps equal the leaf path's bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("the Lion kernels were called for CPU leaves")

    monkeypatch.setattr(tlion, "LeafTable", refuse)
    monkeypatch.setattr(tlion, "lion_norm", refuse)
    before = (tlion.lion.launches, tlion.lion.leaves)
    params, steps = make_leaves("cpu")
    ref_params = clone(params)
    opt = toptim.Optimizer(params, "lion", schedule)
    ref = toptim.Optimizer(ref_params, "lion", schedule)
    for grads in steps:
        norm = opt.step(grads)
        want = toptim.global_norm({n: grads.get(n) for n in ref.order})
        assert torch.equal(norm, want)
        ref._step_leaves(grads, want, schedule(ref.count), ref.count)
        ref.count += 1
    assert (tlion.lion.launches, tlion.lion.leaves) == before
    for n in params:
        assert torch.equal(params[n], ref_params[n]), n
        assert torch.equal(opt.mu[n], ref.mu[n]), n


@pytest.mark.parametrize("numels", [[1], [65536], [65537, 3, 0, 131072],
                                    [5_000_003, 1]])
def test_chunk_layout(numels):
    """Each leaf's chunks follow the one before, ceil(n / CHUNK) of them."""
    first, owner = tlion.chunk_layout(numels)
    counts = [-(-n // tlion.CHUNK) for n in numels]
    assert owner.tolist() == [i for i, c in enumerate(counts)
                              for _ in range(c)]
    assert first.tolist() == [sum(counts[:i]) for i in range(len(numels))]


def test_leaf_table_takes_cuda_tensors_only():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        tlion.LeafTable([p], [torch.zeros(4)], [False])
    with pytest.raises(ValueError, match="at least one"):
        tlion.LeafTable([], [], [])


@pytest.mark.parametrize("name", ["lion", "adamw", "lion8bit"])
def test_update_span_records_the_traffic(name):
    """``train.update`` carries its leaves and the bytes of the parameters,
    the moments and the gradients the step got (None ones left out):
    what ``optimizer_roofline`` counts."""
    params, steps = make_leaves("cpu")
    params = {n: p.float() for n, p in params.items()}
    grads = {n: None if g is None else g.float() for n, g in steps[0].items()}
    opt = toptim.Optimizer(params, name, schedule)
    trace.clear()
    with trace.enable():
        opt.step(grads)
    (up,) = [r for r in trace.records() if r.name == "train.update"]
    trace.clear()
    numel = sum(p.numel() for p in params.values())
    assert up.attrs["leaves"] == len(LEAVES)
    assert up.attrs["param_bytes"] == 4 * numel
    assert up.attrs["moment_bytes"] == opt.moment_bytes()
    assert up.attrs["grad_bytes"] == 4 * sum(
        g.numel() for g in grads.values() if g is not None)
    if name == "lion":
        assert up.attrs["moment_bytes"] == 4 * numel


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def run_both(cuda, clip, offset=False):
    """Three steps on the kernels and, from the kernels' norm, on the leaf
    path: both optimizers and their parameters."""
    params, steps = make_leaves(cuda, offset=offset)
    ref_params = clone(params)
    opt = toptim.Optimizer(params, "lion", schedule, grad_clip=clip)
    ref = toptim.Optimizer(ref_params, "lion", schedule, grad_clip=clip)
    norms = []
    for grads in steps:
        before = tlion.lion.launches
        norm = opt.step(grads)
        assert tlion.lion.launches == before + 3
        norms.append(float(norm))
        ref._step_leaves(grads, norm.clone(), schedule(ref.count), ref.count)
        ref.count += 1
    torch.cuda.synchronize()
    return opt, params, ref, ref_params, norms


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [1e3, 0.5, None],
                         ids=["below_max", "at_or_above_max", "no_clip"])
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_fused_step_is_the_leaf_path_bit_for_bit(cuda, clip, offset):
    """Given the kernels' norm, three steps leave p and m bit-identical to
    the leaf path's, both sides of the clip, on 16-byte vectors and on
    scalar loads."""
    opt, params, ref, ref_params, norms = run_both(cuda, clip, offset)
    if clip is not None:
        assert all((n < clip) == (clip == 1e3) for n in norms)
    start = make_leaves(cuda, offset=offset)[0]
    for n in params:
        assert torch.equal(params[n], ref_params[n]), n
        assert torch.equal(opt.mu[n], ref.mu[n]), n
        if LEAVES[n][2] is not None:   # a leaf with a gradient moved
            assert not torch.equal(params[n], start[n]), n


@pytest.mark.cuda
def test_fused_norm(cuda):
    """The norm within 1e-6 of a float64 norm, bit-identical from run to
    run, with each leaf's sum of squares left on the card."""
    params, steps = make_leaves(cuda)
    opt = toptim.Optimizer(params, "lion", schedule)
    grads = steps[0]
    a, b = opt.norm(grads), opt.norm(grads)
    want = sum(float(g.double().square().sum()) for g in grads.values()
               if g is not None) ** 0.5
    assert a.shape == () and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert abs(float(a) - want) <= 1e-6 * want
    leaf_sq = opt._lion_table.leaf_sq.cpu()
    for i, n in enumerate(opt.order):
        g = grads[n]
        got = float(leaf_sq[i])
        if g is None:
            assert got == 0.0
        else:
            exact = float(g.double().square().sum())
            assert abs(got - exact) <= 1e-6 * exact


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [5, 500])
def test_three_launches_whatever_the_leaves(cuda, leaves):
    g = torch.Generator(device=cuda).manual_seed(3)
    params = {f"l{i}.w": torch.randn(64, 3 + i, generator=g, device=cuda)
              for i in range(leaves)}
    grads = {n: torch.randn(p.shape, generator=g, device=cuda)
             for n, p in params.items()}
    opt = toptim.Optimizer(params, "lion", schedule)
    before = (tlion.lion.launches, tlion.lion.leaves)
    opt.step(grads)
    assert (tlion.lion.launches - before[0],
            tlion.lion.leaves - before[1]) == (3, leaves)


@pytest.mark.cuda
def test_no_host_synchronization(cuda):
    """Neither the first step (which builds the table) nor a later one
    waits for the card or copies from it."""
    params, steps = make_leaves(cuda)
    opt = toptim.Optimizer(params, "lion", schedule)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for grads in steps:
            opt.step(grads)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_resume_equals_an_uninterrupted_run(cuda):
    """A ``state_dict`` after step 1, loaded into a new optimizer over a
    copy of the parameters, then steps 2 and 3: the uninterrupted run's
    bits."""
    params, steps = make_leaves(cuda)
    cont = toptim.Optimizer(clone(params), "lion", schedule)
    first = toptim.Optimizer(params, "lion", schedule)
    first.step(steps[0])
    state = first.state_dict()
    resumed_params = clone(params)
    resumed = toptim.Optimizer(resumed_params, "lion", schedule)
    resumed.load_state_dict(state)
    for grads in steps[1:]:
        resumed.step(grads)
    for grads in steps:
        cont.step(grads)
    torch.cuda.synchronize()
    assert resumed.count == cont.count == 3
    for n in params:
        assert torch.equal(resumed_params[n], cont.params[n]), n
        assert torch.equal(resumed.mu[n], cont.mu[n]), n


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    p = torch.zeros(8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tlion.LeafTable([p.t()], [torch.zeros(4, 8, device=cuda)], [True])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tlion.LeafTable([p.half()], [p.half()], [True])
    table = tlion.LeafTable([p], [torch.zeros_like(p)], [True])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        table.grads([p.double()])
    with pytest.raises(ValueError, match="elements"):
        table.grads([torch.zeros(3, device=cuda)])
