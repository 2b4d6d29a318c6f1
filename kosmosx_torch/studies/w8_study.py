"""The W8 matmul kernels on one NVIDIA GPU: where the Hopper kernel's time
goes, against the mma.sync kernel that these shapes took before it.

    python -m kosmosx_torch.studies.w8_study

Three parts, bf16 x, random codes from a seed:
1. shapes: the decoder's decode (M 4 and 8 over (2048, 2048), (2048, 8192),
   (8192, 2048)), the ViT's and the resampler's projections and prefill (M
   3968): the Hopper kernel (``kx_w8_matmul_hopper``) at the split count of
   ``ops.quant_matmul._w8_plan`` and, for M <= 256, at other split counts;
   the mma.sync kernel (``kx_w8_matmul``) at its own split rule; cuBLAS on
   a dequantised bf16 copy of the codes (not the same function: it reads
   twice the weight bytes); each with its bound (``ops.roofline``);
2. prefill: patched copies of ``csrc/w8_matmul.cu`` that leave a part of
   the Hopper kernel's work out, so that their times say what binds it:
   no conversion (the products read unconverted tiles), no products, half
   of x's TMA traffic (a 128-row box into the 256-row tile), loads only.
   Their results are wrong by design and not checked;
3. L2: decode (M = 4) over all 24 layers of a (24, 2048, 8192) stack in
   turn in one CUDA graph (403 MB of codes, the L2 holds 50 MB), beside
   one layer alone, whose codes stay in L2 between replays.

Times: CUDA-graph replays (``utils.timing.graph_ms``) up to M = 600, where
a call is shorter than its Python launch, CUDA events over back-to-back
launches (``cuda_ms``) above. The kernel results in part 1 are held against
``w8_matmul_plain`` (bar 1e-2 of the largest value) and two launches must
give the same bits. The patched copies are built with the library's nvcc
flags into ``kosmosx_torch/_build/<hash>/w8_study/``. Prints one JSON object
and the card's ``nvidia-smi`` name and power limit; without a CUDA device
it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from kosmosx_torch.ops import _build, quant_matmul as qm, roofline
from kosmosx_torch.utils.quantize import _quantize_w
from kosmosx_torch.utils.timing import cuda_ms, graph_ms

SEED = 0
DECODE_KN = ((2048, 2048), (2048, 8192), (8192, 2048))
SHAPES = ([(m, k, n) for m in (4, 8) for k, n in DECODE_KN]
          + [(64, 1024, 4096), (128, 1024, 1024), (256, 1024, 4096),
             (514, 1024, 1024), (514, 1024, 4096), (3968, 2048, 8192),
             (3968, 8192, 2048)])
SPLIT_SWEEP = (1, 2, 4, 8, 16)
STACK = (24, 2048, 8192)
# patched copies of csrc/w8_matmul.cu: (text, replacement) pairs
_NO_CONVERT = [(
    "    convert_codes(smem + S::codes + (j % CS) * CODE_BYTES, slot(j), ctid);",
    "    fence_proxy_async();")]
_NO_PRODUCTS = [("    issue(it);\n", "    wgmma_commit();\n")]
_HALF_X = [
    ("mbar_arrive_expect_tx(&x_full[s], S::X_BYTES);",
     "mbar_arrive_expect_tx(&x_full[s], S::X_BYTES / 2);"),
    ("tensor_map_2d(&P.x, x, 2, P.M, P.K, P.K, S::BM, HW_BK)",
     "tensor_map_2d(&P.x, x, 2, P.M, P.K, P.K, S::BM / 2, HW_BK)")]
VARIANTS = {"no_convert": _NO_CONVERT, "no_products": _NO_PRODUCTS,
            "half_x": _HALF_X, "loads_only": _NO_CONVERT + _NO_PRODUCTS}
PREFILL = ((3968, 2048, 8192), (3968, 8192, 2048))


def build_variants() -> dict:
    """Each patched copy as a loaded library, one nvcc each, together."""
    out_dir = _build.build_dir() / "w8_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "w8_matmul.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"w8_study: {name}: csrc/w8_matmul.cu no "
                                   f"longer holds {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-shared", str(src), "-o", str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"w8_study: nvcc failed for {name}:\n"
                               f"{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.kx_w8_matmul_hopper.argtypes = _build._SIGNATURES[
            "kx_w8_matmul_hopper"]
        libs[name] = lib
    return libs


class Call:
    """One call of a kernel entry on fixed x, codes and scale, with its own
    scratch: ``hopper(lib, splits, layer=None)`` or ``mma()``."""

    def __init__(self, x, q, scale, n_layers=1):
        self.x, self.q, self.scale, self.n_layers = x, q, scale, n_layers
        self.m, self.k = x.shape
        self.n = q.shape[-1]
        self.out = torch.empty(self.m, self.n, dtype=torch.bfloat16,
                               device=x.device)
        self.tickets = torch.zeros(4096, dtype=torch.int32, device=x.device)

    def _stream(self):
        return torch.cuda.current_stream().cuda_stream

    def hopper(self, lib, splits, layer=None):
        partial = (torch.empty(splits, self.m, self.n, device=self.x.device)
                   if splits > 1 else None)
        block = qm._hopper_block(self.m, self.n, qm._sm_count(0))[0]

        def fn():
            err = lib.kx_w8_matmul_hopper(
                self.x.data_ptr(), self.q.data_ptr(), self.scale.data_ptr(),
                None if layer is None else layer.data_ptr(),
                self.out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                self.tickets.data_ptr(), self.n_layers, self.m, self.k,
                self.n, self.q.stride(-2), block, splits, self._stream())
            _build.check(lib, err, "w8_study hopper launch")
        return fn

    def mma(self):
        lib = _build.library()
        chunk = qm._k_chunk(self.m, self.k, self.n, qm._TILES[torch.bfloat16],
                            qm._sm_count(0))
        splits = qm._cdiv(self.k, chunk)
        partial = (torch.empty(splits, self.m, self.n, device=self.x.device)
                   if splits > 1 else None)

        def fn():
            err = lib.kx_w8_matmul(
                self.x.data_ptr(), self.q.data_ptr(), self.scale.data_ptr(),
                self.out.data_ptr(),
                None if partial is None else partial.data_ptr(), self.m,
                self.k, self.n, self.q.stride(-2), chunk, 1, self._stream())
            _build.check(lib, err, "w8_study mma launch")
        return fn


def checked(fn, call: Call, ref: torch.Tensor) -> dict:
    """Run ``fn`` twice: its error relative to ``ref``'s largest value and
    whether the two launches gave the same bits."""
    fn()
    first = call.out.clone()
    fn()
    torch.cuda.synchronize()
    err = ((first.float() - ref.float()).abs().max()
           / ref.float().abs().max().clamp_min(1e-30)).item()
    return {"rel_err": err, "bit_identical": torch.equal(first, call.out)}


def shapes_part(dev, gen) -> list:
    lib = _build.library()
    results = []
    for m, k, n in SHAPES:
        w = _quantize_w(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        ref = qm.w8_matmul_plain(x, w["q"], w["scale"])
        call = Call(x, w["q"], w["scale"])
        timer = graph_ms if m <= 600 else cuda_ms
        path, tiles, plan_splits = qm._w8_plan(m, k, n, True, True,
                                               qm._sm_count(0))
        nk = qm._cdiv(k, 64)
        sweep = sorted({plan_splits, *(SPLIT_SWEEP if m <= 256 else ())})
        sweep = [s for s in sweep if s <= nk
                 and qm._cdiv(nk, qm._cdiv(nk, s)) == s]
        bound_ms, bound_by = roofline.bound(roofline.w8_matmul_work(m, k, n))
        entry = {"m": m, "k": k, "n": n, "path": path, "tiles": tiles,
                 "plan_splits": plan_splits,
                 "block_m": qm._hopper_block(m, n, qm._sm_count(0))[0],
                 "bound_ms": bound_ms, "bound_by": bound_by, "hopper": {}}
        for splits in sweep:
            fn = call.hopper(lib, splits)
            entry["hopper"][splits] = dict(checked(fn, call, ref),
                                           ms=timer(fn))
        fn = call.mma()
        entry["mma"] = dict(checked(fn, call, ref), ms=timer(fn))
        deq = (w["q"].float() * w["scale"].reshape(1, -1)).bfloat16()
        entry["dequant_bf16_gemm_ms"] = timer(lambda: x @ deq)
        results.append(entry)
        del w, x, ref, deq, call
    return results


def prefill_part(dev, gen, libs) -> list:
    results = []
    for m, k, n in PREFILL:
        w = _quantize_w(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        call = Call(x, w["q"], w["scale"])
        entry = {"m": m, "k": k, "n": n,
                 "kernel_ms": cuda_ms(call.hopper(_build.library(), 1))}
        for name, lib in libs.items():
            entry[f"{name}_ms"] = cuda_ms(call.hopper(lib, 1))
        results.append(entry)
        del w, x, call
    return results


def l2_part(dev, gen) -> dict:
    w = _quantize_w(torch.randn(STACK, generator=gen, device=dev) * 0.02)
    x = torch.randn(4, STACK[1], generator=gen, device=dev).bfloat16()
    layers = [torch.tensor(i, dtype=torch.int32, device=dev)
              for i in range(STACK[0])]
    call = Call(x, w["q"], w["scale"], n_layers=STACK[0])
    splits = qm._w8_plan(4, STACK[1], STACK[2], True, True,
                         qm._sm_count(0))[2]
    lib = _build.library()
    fns = [call.hopper(lib, splits, layer) for layer in layers]

    def every_layer():
        for fn in fns:
            fn()

    return {"m": 4, "stack": list(STACK), "splits": splits,
            "layer_ms_l2_cold": graph_ms(every_layer, calls=1) / STACK[0],
            "layer11_ms_l2_warm": graph_ms(fns[11])}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("w8_study: no CUDA device; this study runs only on an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    libs = build_variants()
    result = {"shapes": shapes_part(dev, gen),
              "prefill_variants": prefill_part(dev, gen, libs),
              "l2": l2_part(dev, gen)}
    print(json.dumps({"device": torch.cuda.get_device_name(0), **result}))
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
