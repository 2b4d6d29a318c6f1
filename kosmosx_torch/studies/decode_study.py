"""Decode attention on one NVIDIA GPU: the chunk size and the number of copy
buffers a block of ``csrc/decode_attention.cu``.

    python -m kosmosx_torch.studies.decode_study

The library's kernel (chunks of 256 positions, one buffer a block) beside
copies of its source built with other compile-time settings: chunks of 128
positions (``-DKX_DECODE_CHUNK=128``), and two or three (K, V, q) buffers a
block (``-DKX_DECODE_STAGES=2`` and ``3``: more copies in flight, fewer
resident blocks). 32 heads of 64 dims, bf16 q, random q and caches from a
seed, a bf16 cache and an int8 one with fp32 scales. Two parts:
1. chunks: 256 against 128 over batches 1-32 and caches of 544-4096
   positions, each row's kv_len drawn from [S / 2, S], with the bound
   (``ops.roofline``);
2. shapes: every copy beside the library's kernel at ``chip_smoke.py``'s
   two decode shapes (the kernels line's and generation's).

Every result is held against ``decode_attention_plain`` (2e-2 bf16, 5e-2
int8, absolute) and two launches must give the same bits. Times: CUDA-graph
replays (``utils.timing.graph_ms``). The copies are built with the
library's nvcc flags into ``kosmosx_torch/_build/<hash>/decode_study/``.
Prints one JSON object and the card's ``nvidia-smi`` name and power limit;
without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from kosmosx_torch.ops import _build, decode_attention as da, roofline
from kosmosx_torch.ops.quant_matmul import _tickets
from kosmosx_torch.utils.timing import graph_ms

SEED = 0
HEADS, D = 32, 64
BATCHES = (1, 2, 4, 8, 16, 32)
CACHES = (544, 1024, 2048, 4096)
# the copies of the source: name -> (nvcc defines, chunk)
VARIANTS = {"chunk128": (["-DKX_DECODE_CHUNK=128"], 128),
            "stages2": (["-DKX_DECODE_STAGES=2"], da.CHUNK),
            "stages3": (["-DKX_DECODE_STAGES=3"], da.CHUNK)}
# chip_smoke.py's decode shapes: (B, S, kv_len)
SHAPES = {"kernels_line": (8, 2048, (2048, 1999, 1500, 1024, 777, 512, 100, 1)),
          "generation": (4, 544, (272, 336, 400, 528))}
BARS = {"bf16": 2e-2, "int8": 5e-2}


def build_variants() -> dict:
    """Each copy of ``VARIANTS`` as (loaded library, chunk), one nvcc each,
    together, and the library itself as "main"; raises on a spill."""
    out_dir = _build.build_dir() / "decode_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
         *defines, "-shared", str(_build.CSRC / "decode_attention.cu"),
         "-o", str(out_dir / f"{name}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (defines, _) in VARIANTS.items()}
    libs = {"main": (_build.library(), da.CHUNK)}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"decode_study: nvcc failed for {name}:\n"
                               f"{log[-3000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        if spills:
            raise RuntimeError(f"decode_study: {name} spills: {spills}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.kx_decode_attention.argtypes = _build._SIGNATURES[
            "kx_decode_attention"]
        libs[name] = (lib, VARIANTS[name][1])
    return libs


def _quantize(x):
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def caches(dev, gen, b: int, s_len: int, lens) -> dict:
    """q, k, v, kv_len and the scales of each cache type: name -> (args,
    scales)."""
    q = torch.randn(b, HEADS, 1, D, generator=gen, device=dev) * D ** -0.5
    k = torch.randn(b, HEADS, s_len, D, generator=gen, device=dev)
    v = torch.randn(b, HEADS, s_len, D, generator=gen, device=dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    (kq, ks), (vq, vs) = _quantize(k), _quantize(v)
    return {"bf16": ((q.bfloat16(), k.bfloat16(), v.bfloat16(), kv_len),
                     (None, None)),
            "int8": ((q.bfloat16(), kq, vq, kv_len), (ks, vs))}


def launcher(lib, args, scales, chunk: int):
    """One launch of ``lib``'s ``kx_decode_attention``, built with chunks of
    ``chunk`` positions, on fixed inputs, with its own output, partials and
    tickets."""
    q, k, v, kv_len = args
    ks, vs = scales
    b, h, s_len, _ = k.shape
    out = torch.empty_like(q)
    chunks = -(-s_len // chunk)
    partial = (torch.empty(b * h * chunks * da._PART, device=q.device)
               if chunks > 1 else None)
    tickets = _tickets(q.device, b * h) if chunks > 1 else None

    def fn():
        err = lib.kx_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(), b, h, s_len, D,
            da._Q_CODES[q.dtype], da._KV_CODES[k.dtype],
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "decode_study launch")
        return out
    return fn


def checked(fn, ref: torch.Tensor, bar: float) -> dict:
    """Two launches of ``fn``: their largest error against ``ref`` and
    whether they gave the same bits; raises past ``bar`` or on a change."""
    first = fn().clone()
    again = fn().clone()
    torch.cuda.synchronize()
    err = (first.float() - ref.float()).abs().max().item()
    if not err < bar or not torch.equal(first, again):
        raise RuntimeError(f"decode_study: error {err} (bar {bar}) or two "
                           f"launches differ")
    return {"max_abs_err": err}


def chunks_part(dev, gen, libs) -> list:
    results = []
    for s_len in CACHES:
        for b in BATCHES:
            lens = torch.randint(s_len // 2, s_len + 1, (b,), generator=gen,
                                 device=dev).tolist()
            for name, (args, scales) in caches(dev, gen, b, s_len,
                                                lens).items():
                ref = da.decode_attention_plain(
                    *args, k_scale=scales[0], v_scale=scales[1])
                work = roofline.decode_work(
                    lens, HEADS, D, kv_itemsize=1 if name == "int8" else 2,
                    scales=name == "int8")
                entry = {"b": b, "s": s_len, "kv_len_sum": sum(lens),
                         "cache": name, "bound_ms": roofline.bound(work)[0],
                         "ms": {}}
                for variant in ("main", "chunk128"):
                    lib, chunk = libs[variant]
                    fn = launcher(lib, args, scales, chunk)
                    checked(fn, ref, BARS[name])
                    entry["ms"][variant] = graph_ms(fn)
                results.append(entry)
    return results


def shapes_part(dev, gen, libs) -> list:
    results = []
    for shape, (b, s_len, lens) in SHAPES.items():
        for name, (args, scales) in caches(dev, gen, b, s_len, lens).items():
            ref = da.decode_attention_plain(*args, k_scale=scales[0],
                                            v_scale=scales[1])
            entry = {"shape": shape, "cache": name, "ms": {}}
            for variant, (lib, chunk) in libs.items():
                fn = launcher(lib, args, scales, chunk)
                checked(fn, ref, BARS[name])
                entry["ms"][variant] = graph_ms(fn)
            results.append(entry)
    return results


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_study: no CUDA device; this study runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    libs = build_variants()
    result = {"shapes": shapes_part(dev, gen, libs),
              "chunks": chunks_part(dev, gen, libs)}
    print(json.dumps({"device": torch.cuda.get_device_name(0), **result}))
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
