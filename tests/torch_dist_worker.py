"""Multi-process worker of kosmosx_torch's parallel tests (the port's
counterpart of tests/dist_worker.py).

``launch(task, world, out)`` (``start`` and ``finish``) runs ``world``
processes of this file under a
torchrun-style environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free port), each joining a gloo process group on the
CPU with one thread, running ``task`` and writing its results as numpy
arrays to ``out/rank{r}.npz``. The inputs come from numpy seeds through
the functions below, which the tests call too for their JAX references.
This file imports torch and kosmosx_torch only, never jax.

Usage: python torch_dist_worker.py TASK OUT_DIR (under that environment)
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the ring cases: JAX's B, H, D with shards of 128 (tests/test_ring_attention
# .py:19-21)
B, H, D, LS = 2, 4, 64, 128
SP_LS = 64        # the SP step's shard length
SP_BATCH = 4
TRAIN_STEPS = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(task: str, world: int, out: str, argv=None, extra_env=None):
    """Start ``world`` ranks of ``task`` (or of the command ``argv``) under
    torchrun's variables on a free port; ``finish`` waits for them."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO,
               **(extra_env or {})}
        cmd = argv or [sys.executable, os.path.abspath(__file__), task, out]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env, cwd=REPO))
    return procs


def finish(procs, timeout: int = 240):
    """[(rc, stdout, stderr)] by rank of ``start``'s processes; every rank
    is killed if one outlives ``timeout`` seconds."""
    outs = []
    try:
        for p in procs:
            out_, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out_, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def launch(task: str, world: int, out: str, timeout: int = 240, **kw):
    """``start`` then ``finish``."""
    return finish(start(task, world, out, **kw), timeout)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def ring_inputs(s: int, seed: int):
    """q, k, v, the cotangent g (B, H, s * LS, D) fp32 and packed segment
    ids (B, s * LS) with a padded (-1) tail, as the JAX tests draw them
    (tests/test_ring_attention.py:_segments)."""
    rng = np.random.default_rng(seed)
    length = s * LS
    q, k = (rng.standard_normal((B, H, length, D)).astype(np.float32) * 0.5
            for _ in range(2))
    v, g = (rng.standard_normal((B, H, length, D)).astype(np.float32)
            for _ in range(2))
    borders = np.sort(rng.integers(1, length - 1, (B, 2)), axis=1)
    pos = np.arange(length)[None, :]
    seg = (pos >= borders[:, :1]).astype(np.int32)
    seg = np.where(pos >= borders[:, 1:] + 1, -1, seg).astype(np.int32)
    return q, k, v, g, seg


RING_CASES = {
    # name: (schedule, shards, causal, segments)
    "ring4_causal": ("ring", 4, True, False),
    "ring4_full": ("ring", 4, False, False),
    "ring4_causal_seg": ("ring", 4, True, True),
    "ring4_full_seg": ("ring", 4, False, True),
    "ring2_causal_seg": ("ring", 2, True, True),
    "zigzag4": ("zigzag", 4, True, False),
    "zigzag4_seg": ("zigzag", 4, True, True),
    "zigzag2": ("zigzag", 2, True, False),
    "zigzag2_seg": ("zigzag", 2, True, True),
}


def sp_config(**kw):
    """JAX's SP_CFG (tests/test_ring_attention.py:140-144) as a port
    config, list-layout layers."""
    from kosmosx_torch.core.config import MagnetoConfig

    return MagnetoConfig(**{**dict(
        vocab_size=89, embed_dim=64, ffn_dim=128, layers=2, heads=4,
        max_positions=1024, multiway=True, dropout=0.0,
        attention_dropout=0.0), **kw})


def sp_batch(padded: bool):
    """Global tokens (SP_BATCH, 2 * 2 * SP_LS) and segment ids (-1 on a
    right-padded tail of rows 1 and 3 when ``padded``)."""
    rng = np.random.default_rng(5)
    length = 4 * SP_LS
    tokens = rng.integers(4, 89, (SP_BATCH, length)).astype(np.int32)
    seg = np.zeros((SP_BATCH, length), np.int32)
    if padded:
        seg[1, length - 37:] = -1
        seg[3, length - 100:] = -1
        tokens = np.where(seg < 0, 1, tokens).astype(np.int32)
    return tokens, seg


SP_CASES = {
    # name: (schedule, padded, attention dropout through the gathered path)
    "ring": ("ring", False, False),
    "zigzag": ("zigzag", False, False),
    "ring_padded": ("ring", True, False),
    "zigzag_padded": ("zigzag", True, False),
    "zigzag_gathered": ("zigzag", True, True),
}
SP_SEED = 3
SP_LR = 0.1


def train_config(**kw):
    from kosmosx_torch.core.config import MagnetoConfig

    return MagnetoConfig(vocab_size=97, embed_dim=32, ffn_dim=64, layers=2,
                         heads=4, max_positions=64, dropout=0.0,
                         attention_dropout=0.0, **kw)


def train_batches():
    """TRAIN_STEPS global batches of 4 rows x 24 tokens whose rows carry
    different amounts of right padding (the ranks' token counts differ)."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(TRAIN_STEPS):
        ids = rng.integers(2, 97, (4, 24)).astype(np.int32)
        mask = np.ones((4, 24), np.int32)
        for row, keep in enumerate(rng.integers(6, 25, 4)):
            mask[row, keep:] = 0
        out.append({"input_ids": np.where(mask > 0, ids, 1).astype(np.int32),
                    "attention_mask": mask})
    return out


TRAIN_SEED = 4
TRAIN_OPTS = ("lion", "adamw", "adamw8bit")
LORA_RANK = 4


def kosmos_config():
    """A tiny Kosmos (tests/test_torch_port_model.py's ``kosmos_cfg``)."""
    from kosmosx_torch.core.config import (KosmosConfig, ResamplerConfig,
                                           VisionConfig)

    return KosmosConfig(
        decoder=train_config(),
        vision=VisionConfig(image_size=28, patch_size=14, hidden_dim=32,
                            layers=2, heads=4, mlp_dim=64),
        resampler=ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                                  num_latents=8, num_media_embeds=5),
        image_embed_len=8)


def kosmos_batches():
    """TRAIN_STEPS global batches of 4 rows: 16 text tokens, right-padded
    (id 1) by different amounts, and a 28 x 28 image each."""
    rng = np.random.default_rng(13)
    out = []
    for _ in range(TRAIN_STEPS):
        text = rng.integers(2, 97, (4, 16)).astype(np.int32)
        for row, keep in enumerate(rng.integers(5, 17, 4)):
            text[row, keep:] = 1
        out.append({"text_tokens": text, "images": rng.standard_normal(
            (4, 3, 28, 28)).astype(np.float32)})
    return out


def side_runs(mesh=None):
    """The runs beside the main cases, over ``mesh`` or in one process:
    LoRA (``LoraTrainer``, AdamW) on the decoder, and a Kosmos with CLIP
    frozen (AdamW under accumulation 2: the accumulator holds the shards
    too; no warmup, so its one update moves the parameters), then its
    evaluation. name -> {key: array}."""
    import torch

    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.train import checkpoint as ckpt
    from kosmosx_torch.train.lora import LoraTrainer, lora_state_dict
    from kosmosx_torch.train.trainer import (Trainer, kosmos_loss_fn,
                                             lm_loss_fn)

    out = {}
    if mesh is None or "lora" in mesh:
        cfg = train_config()
        t = LoraTrainer(lambda g: KosmosLanguage(cfg, generator=g,
                                                 device="cpu"),
                        lm_loss_fn(cfg), train_cfg("adamw"), LORA_RANK,
                        mesh=None if mesh is None else mesh["lora"],
                        device="cpu")
        logs = {}
        state, _ = t.run(train_batches(), log_fn=logs.__setitem__)
        res = {f"loss{s}": np.float32(m["loss"]) for s, m in logs.items()}
        res.update({f"lora.{n}": _np(x) for n, x in
                    lora_state_dict(state["lora"]).items()})
        out["lora"] = res
    if mesh is None or "kosmos" in mesh:
        kcfg = kosmos_config()
        t = Trainer(lambda g: Kosmos(kcfg, generator=g, device="cpu"),
                    kosmos_loss_fn(kcfg),
                    train_cfg("adamw", freeze=("clip",), grad_accum=2,
                              warmup_steps=0),
                    mesh=None if mesh is None else mesh["kosmos"],
                    device="cpu")
        logs = {}
        state, _ = t.run(kosmos_batches(), log_fn=logs.__setitem__)
        res = {f"loss{s}": np.float32(m["loss"]) for s, m in logs.items()}
        res["eval_loss"] = np.float32(
            t.evaluate(kosmos_batches()[:1])["eval_loss"])
        res.update({f"param.{n}": _np(p) for n, p in
                    ckpt._params_dict(state["params"]).items()})
        out["kosmos"] = res
    return out


def train_cfg(name: str, **kw):
    from kosmosx_torch.train.trainer import TrainConfig

    return TrainConfig(**{**dict(
        optimizer=name, schedule="cosine", learning_rate=1e-2,
        total_steps=10, warmup_steps=1, seed=TRAIN_SEED, log_every=1,
        checkpoint_every=0, prefetch=False), **kw})


# the 8-bit optimizers over leaves sharded four ways, fed the same
# gradients as optax: a shard boundary inside a block (77 and 1000
# elements), an empty shard (3 rows over 4 ranks) and aligned rows
OPT8_SHAPES = {"a.w": (7, 77), "b.b": (1000,), "c.scale": (3,),
               "d.w": (256, 2)}
OPT8_STEPS = 3


def opt8_inputs():
    """(params, [grads by step]) name -> fp32 array; each step's gradient
    norm about 0.5, so the clip at 1.0 stays inactive."""
    rng = np.random.default_rng(12)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in OPT8_SHAPES.items()}
    steps = []
    for _ in range(OPT8_STEPS):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in OPT8_SHAPES.items()}
        norm = np.sqrt(sum(float((x ** 2).sum()) for x in g.values()))
        steps.append({n: (x * (0.5 / norm)).astype(np.float32)
                      for n, x in g.items()})
    return params, steps


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy()


def task_ring(rank: int, out: dict) -> None:
    import torch

    from kosmosx_torch.parallel import ring_attention as ra
    from kosmosx_torch.parallel.mesh import build_mesh
    from kosmosx_torch.parallel.comm import all_gather

    meshes = {4: build_mesh((4,), ("sequence",)),
              2: build_mesh((2, 2), ("data", "sequence"))}
    for name, (schedule, s, causal, segs) in RING_CASES.items():
        group = meshes[s].get_group("sequence")
        i = meshes[s].get_local_rank("sequence")
        q, k, v, g, seg = (torch.from_numpy(x) for x in
                           ring_inputs(s, seed=len(name)))
        if schedule == "zigzag":
            q, k, v, g = (ra.zigzag_permute(t, s, axis=2) for t in (q, k, v, g))
            seg = ra.zigzag_permute(seg, s, axis=1)
        cols = slice(i * LS, (i + 1) * LS)
        qs, ks, vs = (t[:, :, cols].clone().requires_grad_()
                      for t in (q, k, v))
        sg = seg[:, cols] if segs else None
        if schedule == "zigzag":
            o = ra.zigzag_ring_flash_attention(
                qs, ks, vs, group, sm_scale=D ** -0.5, q_segment_ids=sg,
                kv_segment_ids=sg)
        else:
            o = ra.ring_flash_attention(
                qs, ks, vs, group, causal=causal, sm_scale=D ** -0.5,
                q_segment_ids=sg, kv_segment_ids=sg)
        o.backward(g[:, :, cols])
        for key, t in (("o", o), ("dq", qs.grad), ("dk", ks.grad),
                       ("dv", vs.grad)):
            full = all_gather(t.detach(), group, dim=2)
            if schedule == "zigzag":
                full = ra.zigzag_unpermute(full, s, axis=2)
            out[f"{name}.{key}"] = _np(full)


def task_sp(rank: int, out: dict) -> None:
    import torch

    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.parallel.seq_parallel import (
        make_seq_parallel_train_step, make_sp_mesh, shift_labels)

    mesh = make_sp_mesh(data=2, sequence=2)

    class SGD:
        def __init__(self, params):
            self.params = params

        @torch.no_grad()
        def step(self, grads):
            for n, p in self.params.items():
                p.sub_(SP_LR * grads[n])

    for name, (schedule, padded, gathered) in SP_CASES.items():
        cfg = sp_config(sequence_axis="sequence", sequence_schedule=schedule,
                        attention_dropout=1e-9 if gathered else 0.0)
        model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(
            SP_SEED), device="cpu")
        model.set_trainable()
        step = make_seq_parallel_train_step(
            cfg, SGD(dict(model.named_parameters())), mesh)
        tokens, seg = (torch.from_numpy(x) for x in sp_batch(padded))
        labels, weights = shift_labels(tokens, cfg.padding_idx)
        weights = weights * (seg >= 0)
        loss = step(model, tokens, labels, weights, seg,
                    rng=7 if gathered else None)
        out[f"{name}.loss"] = np.float32(loss)
        for n, p in model.named_parameters():
            out[f"{name}.param.{n}"] = _np(p)


def _trainer_run(name, mesh_kw, devices, ckpt_dir=None, resume=False):
    """Two steps (one after a resume from ``ckpt_dir``'s step 1)."""
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.parallel.mesh import make_mesh
    from kosmosx_torch.train import checkpoint as ckpt
    from kosmosx_torch.train.trainer import Trainer, lm_loss_fn

    cfg = train_config()
    mesh = make_mesh(devices=devices, **mesh_kw)
    tc = train_cfg(name, **({} if ckpt_dir is None else
                            dict(checkpoint_every=1, output_dir=ckpt_dir,
                                 resume=resume)))
    trainer = Trainer(lambda g: KosmosLanguage(cfg, generator=g, device="cpu"),
                      lm_loss_fn(cfg), tc, mesh=mesh, device="cpu")
    logs = {}
    state, _ = trainer.run(train_batches(), log_fn=logs.__setitem__)
    res = {f"loss{s}": np.float32(m["loss"]) for s, m in logs.items()}
    res.update({f"grad_norm{s}": np.float32(m["grad_norm"])
                for s, m in logs.items()})
    params = ckpt._params_dict(state["params"])
    res.update({f"param.{n}": _np(p) for n, p in params.items()})
    opt = state["opt_state"].state_dict()
    for slot in ("mu", "nu"):
        for n, t in opt[slot].items():
            if isinstance(t, dict):
                res[f"{slot}.q.{n}"] = t["q"].cpu().numpy()
                res[f"{slot}.scale.{n}"] = t["scale"].cpu().numpy()
    return trainer, res


def task_opt8(rank: int, out: dict) -> None:
    """The 8-bit optimizers on runs of rows of every leaf (FSDP's dim-0
    shards over four ranks), gathered into the single-process state."""
    import torch
    import torch.distributed as dist

    from kosmosx_torch.parallel.sharding import LocalShard
    from kosmosx_torch.train.optim import make_optimizer, make_schedule

    params, steps = opt8_inputs()
    world = dist.get_world_size()

    def local(full, shape):
        rows = shape[0]
        chunk = -(-rows // world)
        lo, hi = min(rank * chunk, rows), min((rank + 1) * chunk, rows)
        inner = int(np.prod(shape[1:]))
        return torch.from_numpy(full[lo:hi].copy()), LocalShard(
            lo * inner, int(np.prod(shape)), tuple(shape), dist.group.WORLD)

    for name in ("adamw8bit", "lion8bit"):
        pieces = {n: local(p, p.shape) for n, p in params.items()}
        opt = make_optimizer(name, make_schedule("cosine", 1e-2, 10, 1),
                             {n: t for n, (t, _) in pieces.items()},
                             shards={n: sh for n, (_, sh) in pieces.items()})
        for g in steps:
            opt.step({n: local(g[n], g[n].shape)[0] for n in g})
        state = opt.state_dict()
        for slot in ("mu", "nu"):
            for n, qs in state[slot].items():
                out[f"{name}.{slot}.q.{n}"] = qs["q"].numpy()
                out[f"{name}.{slot}.scale.{n}"] = qs["scale"].numpy()
        for n, (t, _) in pieces.items():
            out[f"{name}.param.{n}"] = opt.full(n, t).numpy()


def wait_for(path: str, timeout: float = 200.0) -> None:
    """Wait until ``path`` exists (a file another process writes)."""
    import time

    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def task_trainer(rank: int, out: dict) -> None:
    """The sharded 8-bit optimizers; then ranks 0-1 train at data=2 and
    ranks 2-3 at fsdp=2, side by side, and all four at data=2 x fsdp=2.
    The fsdp=2 runs write a checkpoint after each step, from whose step 1
    ranks 2-3 resume at fsdp=2; they resume JAX's step-1 Lion checkpoint
    too (``jax_lion``, which the test writes)."""
    task_opt8(rank, out)
    import torch.distributed as dist

    mine = "data2" if rank < 2 else "fsdp2"
    devices = [0, 1] if rank < 2 else [2, 3]
    for name in TRAIN_OPTS:
        for kind, kw, devs in (("data2", dict(data=2), [0, 1]),
                               ("fsdp2", dict(fsdp=2, data=1), [2, 3])):
            if kind != mine:
                # every process makes every mesh's groups
                from kosmosx_torch.parallel.mesh import make_mesh

                make_mesh(devices=devs, **kw)
                continue
            ckpt_dir = os.path.join(OUT, f"ckpt_{name}") if kind == "fsdp2" \
                else None
            trainer, res = _trainer_run(name, kw, devices, ckpt_dir)
            out.update({f"{kind}.{name}.{k}": v for k, v in res.items()})
        dist.barrier()
    for name in ("lion", "adamw8bit"):
        resume = os.path.join(OUT, f"resume_{name}")
        if rank == 2:
            shutil.copytree(os.path.join(OUT, f"ckpt_{name}", "step_1"),
                            os.path.join(resume, "step_1"))
        dist.barrier()
        from kosmosx_torch.parallel.mesh import make_mesh

        if rank < 2:
            make_mesh(data=1, fsdp=2, devices=[2, 3])
        else:
            _, res = _trainer_run(name, dict(data=1, fsdp=2), [2, 3],
                                  ckpt_dir=resume, resume=True)
            out.update({f"fsdp2_resumed.{name}.{k}": v
                        for k, v in res.items()})
        dist.barrier()
    for name in ("lion", "adamw"):
        _, res = _trainer_run(name, dict(data=2, fsdp=2), None)
        out.update({f"hsdp.{name}.{k}": v for k, v in res.items()})
    # JAX's step-1 Lion checkpoint (orbax, written by the test beside this
    # run) resumed at fsdp=2 on ranks 2-3
    from kosmosx_torch.parallel.mesh import make_mesh

    if rank < 2:
        make_mesh(data=1, fsdp=2, devices=[2, 3])
    else:
        jax_dir = os.path.join(OUT, "jax_lion")
        wait_for(os.path.join(jax_dir, "step_1", "_METADATA"))
        _, res = _trainer_run("lion", dict(data=1, fsdp=2), [2, 3],
                              ckpt_dir=jax_dir, resume=True)
        out.update({f"fsdp2_jax.lion.{k}": v for k, v in res.items()})
    dist.barrier()
    from kosmosx_torch.parallel.mesh import make_hybrid_mesh

    out["hybrid_mesh"] = make_hybrid_mesh(dcn_data=2, fsdp=2).mesh.numpy()
    # LoRA at data=2 on ranks 0-1 beside a Kosmos at fsdp=2 on ranks 2-3
    from kosmosx_torch.parallel.mesh import make_mesh

    meshes = {"lora": make_mesh(data=2, devices=[0, 1]),
              "kosmos": make_mesh(data=1, fsdp=2, devices=[2, 3])}
    mine = "lora" if rank < 2 else "kosmos"
    for name, res in side_runs({mine: meshes[mine]}).items():
        out.update({f"side.{name}.{k}": v for k, v in res.items()})
    dist.barrier()


# ---------------------------------------------------------------------------
# tensor and expert parallelism
# ---------------------------------------------------------------------------


def tp_config(**kw):
    """The tensor-parallel cases' decoder: 4 heads, width 64."""
    from kosmosx_torch.core.config import MagnetoConfig

    return MagnetoConfig(**{**dict(
        vocab_size=97, embed_dim=64, ffn_dim=128, layers=2, heads=4,
        max_positions=64, dropout=0.0, attention_dropout=0.0), **kw})


TP_SEED = 6


def tp_tokens():
    """A global batch of 4 rows x 16 tokens and a prompt of 4 x 6."""
    rng = np.random.default_rng(21)
    return (rng.integers(2, 97, (4, 16)).astype(np.int64),
            rng.integers(4, 97, (4, 6)).astype(np.int64))


GEN_NEW = 5

# the 8-bit optimizers over leaves cut over tensor (a column cut inside
# the 256-element blocks, a row cut, a cut vector) and FSDP runs within
# the cut, fed the same gradients as optax; (shape, dim of the cut)
OPT8_CUT = {"a.w": ((7, 78), 1), "b.w": ((6, 100), 0), "c.b": ((1000,), 0),
            "d.w": ((3, 256), 1)}
OPT8_CUT_STEPS = 3


def opt8_cut_inputs():
    rng = np.random.default_rng(14)
    shapes = {n: s for n, (s, _) in OPT8_CUT.items()}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    steps = []
    for _ in range(OPT8_CUT_STEPS):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        norm = np.sqrt(sum(float((x ** 2).sum()) for x in g.values()))
        steps.append({n: (x * (0.5 / norm)).astype(np.float32)
                      for n, x in g.items()})
    return params, steps


def task_opt8_cut(rank: int, out: dict) -> None:
    """The 8-bit optimizers on pieces cut over ``tensor`` (mesh fsdp=2 x
    tensor=2), each an FSDP run of its cut, gathered into the
    single-process state."""
    import torch

    from kosmosx_torch.parallel.mesh import make_mesh
    from kosmosx_torch.parallel.sharding import LocalShard, local_piece
    from kosmosx_torch.train.optim import make_optimizer, make_schedule

    mesh = make_mesh(data=1, fsdp=2, tensor=2)
    tp, fs = mesh.get_local_rank("tensor"), mesh.get_local_rank("fsdp")
    groups = (mesh.get_group("fsdp"), mesh.get_group("tensor"))
    params, steps = opt8_cut_inputs()

    def shard_of(shape, dim):
        size = shape[dim] // 2
        cut = [size if d == dim else n for d, n in enumerate(shape)]
        rows = cut[0]
        chunk = -(-rows // 2)
        lo = min(fs * chunk, rows)
        inner = int(np.prod(cut[1:]))
        return LocalShard(lo * inner, int(np.prod(shape)), tuple(shape),
                          groups, ((dim, tp * size, size),)), \
            (min((fs + 1) * chunk, rows) - lo, *cut[1:])

    def local(full, name):
        shard, lshape = shard_of(*OPT8_CUT[name])
        return local_piece(torch.from_numpy(full), shard, lshape).clone(), \
            shard

    for name in ("adamw8bit", "lion8bit"):
        pieces = {n: local(p, n) for n, p in params.items()}
        opt = make_optimizer(name, make_schedule("cosine", 1e-2, 10, 1),
                             {n: t for n, (t, _) in pieces.items()},
                             shards={n: sh for n, (_, sh) in pieces.items()})
        for g in steps:
            opt.step({n: local(g[n], n)[0] for n in g})
        state = opt.state_dict()
        for slot in ("mu", "nu"):
            for n, qs in state[slot].items():
                out[f"opt8cut.{name}.{slot}.q.{n}"] = qs["q"].numpy()
                out[f"opt8cut.{name}.{slot}.scale.{n}"] = qs["scale"].numpy()
        for n, (t, _) in pieces.items():
            out[f"opt8cut.{name}.param.{n}"] = opt.full(n, t).numpy()


def _local_shapes(model, prefix: str, out: dict) -> None:
    from torch.distributed.tensor import DTensor

    for n, p in model.named_parameters():
        t = p.to_local() if isinstance(p, DTensor) else p
        out[f"{prefix}.{n}"] = np.array(t.shape, np.int64)


def tp_remat_grads(mesh=None) -> dict:
    """The whole gradients of ``mean(logits ** 2)`` over the global
    tokens under remat "dots" (selective checkpointing recomputes the
    row-parallel all-reduces), of a decoder cut over ``mesh`` or whole."""
    import torch

    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.parallel.sharding import (param_shards, shard_params,
                                                 whole)

    model = KosmosLanguage(tp_config(remat=True, remat_policy="dots"),
                           generator=torch.Generator().manual_seed(TP_SEED),
                           device="cpu")
    model.set_trainable()
    if mesh is not None:
        shard_params(model, mesh)
    model.apply(torch.from_numpy(tp_tokens()[0])).square().mean().backward()
    shards = param_shards(model)
    return {f"remat.{n}": _np(whole(p.grad, shards[n]))
            for n, p in model.named_parameters() if p.grad is not None}


def dpo_run(mesh=None) -> dict:
    """A DPO loss and its gradients (``dpo_loss_fn``, beta 0.5) on a
    4-row preference batch, the policy and the reference (a deep copy of
    a second model) cut over ``mesh`` (its batch rows split over ``data``)
    or whole: the metrics and the policy's whole summed gradients."""
    import copy

    import torch

    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.parallel.comm import all_reduce
    from kosmosx_torch.parallel.sharding import (batch_shards, param_shards,
                                                 shard_batch, shard_params,
                                                 whole)
    from kosmosx_torch.train.dpo import (compute_ref_logprobs, dpo_loss_fn,
                                         preference_batch)
    from kosmosx_torch.train.loss import global_batch
    from kosmosx_torch.train.trainer import value_and_grad

    cfg = train_config()
    rng = np.random.default_rng(2)

    def rows(lo, hi):
        return [list(rng.integers(4, 97, int(rng.integers(lo, hi))))
                for _ in range(4)]

    batch = preference_batch(rows(3, 8), rows(2, 10), rows(2, 10), length=20)
    policy, ref = (KosmosLanguage(cfg, generator=torch.Generator(
        ).manual_seed(seed), device="cpu") for seed in (0, 1))
    group = None
    if mesh is not None:
        shard_params(policy, mesh)
        shard_params(ref, mesh)
        ref = copy.deepcopy(ref)
        group = tuple(mesh.get_group(a) for a in ("data", "fsdp")
                      if mesh[a].size() > 1)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch = shard_batch(compute_ref_logprobs(ref, cfg, batch), mesh)
    with global_batch(group):
        (_, metrics), grads = value_and_grad(dpo_loss_fn(cfg, beta=0.5),
                                             policy, batch)
    names = [n for n, g in grads.items() if g is not None]
    if group:
        grads.update(zip(names, all_reduce([grads[n] for n in names], group)))
    shards = param_shards(policy)
    out = {f"dpo.{k}": np.float32(v) for k, v in metrics.items()}
    out.update({f"dpo.grad.{n}": _np(whole(grads[n], shards[n]))
                for n in names})
    out["dpo.shard"] = np.int64(batch_shards(mesh)[0])
    return out


def task_tensor(rank: int, out: dict) -> None:
    """Meshes with tensor=2; the forward over data=2 x tensor=2 and
    fsdp=2 x tensor=2 (each rank's rows) with every leaf's local shape;
    greedy generation over data=2 x tensor=2; the 8-bit optimizers over
    cut leaves; Trainer over data=2 x tensor=2 (AdamW8bit) and fsdp=2 x
    tensor=2 (Lion, checkpointing each step); LoRA over data=2 x
    tensor=2 and a Kosmos with CLIP frozen over fsdp=2 x tensor=2; a W8
    decoder over data=2 x tensor=2 (``w8_tensor_run``), QLoRA over the
    same mesh, and ``ServeEngine(mesh=)`` at tensor=2 on a W8 model (ranks
    0-1) and with two adapters (ranks 2-3)."""
    import torch

    from kosmosx_torch.generate.sampler import SamplingConfig, generate_text
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.parallel.mesh import make_hybrid_mesh, make_mesh
    from kosmosx_torch.parallel.sharding import (batch_shards, shard_batch,
                                                 shard_params)

    meshes = {"dt": make_mesh(data=2, tensor=2),
              "ft": make_mesh(data=1, fsdp=2, tensor=2)}
    for kind, mesh in meshes.items():
        out[f"mesh.{kind}"] = mesh.mesh.numpy()
    out["mesh.hybrid"] = make_hybrid_mesh(dcn_data=2, tensor=2).mesh.numpy()
    cfg = tp_config()
    tokens, prompt = tp_tokens()
    for kind, mesh in meshes.items():
        model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(
            TP_SEED), device="cpu")
        root = shard_params(model, mesh)
        rows = shard_batch({"t": torch.from_numpy(tokens)}, mesh)["t"]
        with torch.no_grad():
            logits = model.apply(rows) if root is None else \
                root(lambda m, t: m.apply(t), rows)
        out[f"fwd.{kind}"] = _np(logits)
        out[f"fwd.{kind}.shard"] = np.int64(batch_shards(mesh)[0])
        _local_shapes(model, f"shape.{kind}", out)
        if kind == "dt":
            out["gen.dt"] = generate_text(
                model, cfg, torch.from_numpy(prompt),
                SamplingConfig(max_new_tokens=GEN_NEW, greedy=True)).numpy()
    out.update(tp_remat_grads(meshes["dt"]))
    task_opt8_cut(rank, out)
    for kind, name in (("dt", "adamw8bit"), ("ft", "lion")):
        kw = dict(data=2, tensor=2) if kind == "dt" else \
            dict(data=1, fsdp=2, tensor=2)
        ckpt_dir = os.path.join(OUT, f"ckpt_{name}") if kind == "ft" else None
        _, res = _trainer_run(name, kw, None, ckpt_dir)
        out.update({f"{kind}.{name}.{k}": v for k, v in res.items()})
    # the fsdp=2 x tensor=2 run's step-1 checkpoint resumed at data=2 x
    # tensor=2: each rank restores its cut of every leaf and its state
    resume = os.path.join(OUT, "resume_lion")
    if rank == 0:
        shutil.copytree(os.path.join(OUT, "ckpt_lion", "step_1"),
                        os.path.join(resume, "step_1"))
    import torch.distributed as dist

    dist.barrier()
    _, res = _trainer_run("lion", dict(data=2, tensor=2), None,
                          ckpt_dir=resume, resume=True)
    out.update({f"dt_resumed.lion.{k}": v for k, v in res.items()})
    out.update(dpo_run(meshes["dt"]))
    sides = {"lora": make_mesh(data=2, tensor=2),
             "kosmos": make_mesh(data=1, fsdp=2, tensor=2)}
    for name, res in side_runs(sides).items():
        out.update({f"side.{name}.{k}": v for k, v in res.items()})
    # W8 weights and per-row LoRA factors over tensor: the W8 decoder's
    # forward and generation, QLoRA, and the engine on a W8 model (ranks
    # 0-1) beside the engine with two adapters (ranks 2-3)
    w8_tensor_run(meshes["dt"], out)
    out.update({f"qlora.{k}": v for k, v in
                qlora_run(make_mesh(data=2, tensor=2)).items()})
    pairs = {"w8": make_mesh(data=1, tensor=2, devices=[0, 1]),
             "lora": make_mesh(data=1, tensor=2, devices=[2, 3])}
    case = "w8" if rank < 2 else "lora"
    res = serve_run(serve_config(), pairs[case], w8=case == "w8",
                    adapters=serve_adapters() if case == "lora" else None)
    out.update({f"serve.{case}.{k}": v for k, v in res.items()})


MOE_SKEW = 4.0   # the router's weights times this: peaked, uneven routing


def moe_config(**kw):
    return train_config(moe_experts=4, multiway=False, **kw)


def moe_model(generator):
    """The MoE decoder from ``generator`` with its routers scaled by
    ``MOE_SKEW``."""
    import torch

    from kosmosx_torch.models.language import KosmosLanguage

    model = KosmosLanguage(moe_config(), generator=generator,
                           device=generator.device)
    with torch.no_grad():
        for layer in model["layers"]:
            layer["ffn"]["router"]["w"].mul_(MOE_SKEW)
    return model


def _moe_run(name, mesh):
    """Two MoE ``Trainer`` steps over ``mesh``: losses, routing losses,
    gradient norms, whole parameters, and the local shape of every
    leaf."""
    from kosmosx_torch.train.trainer import Trainer, lm_loss_fn

    trainer = Trainer(moe_model, lm_loss_fn(moe_config()), train_cfg(name),
                      mesh=mesh, device="cpu")
    logs = {}
    state, _ = trainer.run(train_batches(), log_fn=logs.__setitem__)
    from kosmosx_torch.train import checkpoint as ckpt

    res = {f"{k}{s}": np.float32(m[k]) for s, m in logs.items()
           for k in ("loss", "moe_aux", "grad_norm")}
    res.update({f"param.{n}": _np(p) for n, p in
                ckpt._params_dict(state["params"]).items()})
    _local_shapes(state["params"], "shape", res)
    return res


SERVE_PROMPTS = ([5, 7, 11, 13], [21, 22], [40, 41, 42, 43, 44])
SERVE_NEW = 6


def serve_config(**kw):
    return tp_config(vocab_size=96, **kw)


def serve_run(cfg, mesh=None, w8=False, adapters=None):
    """The engine over ``SERVE_PROMPTS`` (2 slots): tokens by request and
    the pool's K shape. ``w8``: the model quantized (``W8_MIN``);
    ``adapters`` (``serve_adapters()``): loaded, and request i submitted
    with ``SERVE_ADAPTERS[i]``."""
    import torch

    from kosmosx_torch.generate.sampler import SamplingConfig
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.serve.engine import ServeConfig, ServeEngine
    from kosmosx_torch.utils.quantize import quantize_params_w8

    model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(
        TP_SEED), device="cpu")
    if w8:
        model = quantize_params_w8(model, min_size=W8_MIN)
    eng = ServeEngine(model, cfg, ServeConfig(max_batch=2, max_prompt_len=16,
                                              max_len=48),
                      SamplingConfig(greedy=True), device="cpu", mesh=mesh)
    for name, tree in (adapters or {}).items():
        eng.load_adapter(name, tree)
    hs = [eng.submit(p, max_new_tokens=SERVE_NEW,
                     adapter=SERVE_ADAPTERS[i] if adapters else None)
          for i, p in enumerate(SERVE_PROMPTS)]
    eng.run()
    out = {f"tokens{i}": np.array(h.tokens, np.int64)
           for i, h in enumerate(hs)}
    out["pool_k"] = np.array(eng.caches[0]["k"].shape, np.int64)
    return out


W8_MIN = 16            # quantize every linear and table of the tiny models
SERVE_ADAPTERS = ("a", "b", None)   # the adapter of each SERVE_PROMPTS


def serve_adapters():
    """Two rank-LORA_RANK adapters of the serving decoder (every default
    target), name -> lora tree of numpy arrays: ``a`` and ``b`` drawn from
    numpy seeds (``b`` nonzero, so each adapter moves the tokens)."""
    import torch

    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.train.lora import add_lora, strip_lora

    base = KosmosLanguage(serve_config(), generator=torch.Generator(
        ).manual_seed(TP_SEED), device="cpu")
    template = strip_lora(add_lora(torch.Generator().manual_seed(0), base,
                                   LORA_RANK))[1]

    def fill(node, rng):
        if isinstance(node, dict):
            return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                    * 0.3 if k in ("a", "b") and not isinstance(v, dict)
                    else fill(v, rng) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [fill(v, rng) for v in node]
        return node.numpy()

    return {name: fill(template, np.random.default_rng(30 + i))
            for i, name in enumerate(("a", "b"))}


def qlora_base():
    """The QLoRA cases' frozen base: the training decoder quantized."""
    import torch

    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.utils.quantize import quantize_params_w8

    return quantize_params_w8(KosmosLanguage(
        train_config(), generator=torch.Generator().manual_seed(TRAIN_SEED),
        device="cpu"), min_size=W8_MIN)


def qlora_run(mesh=None) -> dict:
    """Two ``LoraTrainer`` steps (AdamW) over ``qlora_base`` on the
    training batches, over ``mesh`` or in one process: losses and every
    factor."""
    from kosmosx_torch.train.lora import LoraTrainer, lora_state_dict
    from kosmosx_torch.train.trainer import lm_loss_fn

    t = LoraTrainer(None, lm_loss_fn(train_config()), train_cfg("adamw"),
                    LORA_RANK, mesh=mesh, base_params=qlora_base(),
                    device="cpu")
    logs = {}
    state, _ = t.run(train_batches(), log_fn=logs.__setitem__)
    out = {f"loss{s}": np.float32(m["loss"]) for s, m in logs.items()}
    out.update({f"lora.{n}": _np(x) for n, x in
                lora_state_dict(state["lora"]).items()})
    return out


# a stacked W8 decoder's leaves whose cut the layout case records
W8_STACK_LEAVES = ("attn.q.A.w.q", "attn.q.A.w.scale", "attn.out.A.w.q",
                   "attn.out.A.w.scale", "ffn.A.fc1.w.q", "ffn.A.fc2.w.q",
                   "ffn.A.fc2.w.scale")


def w8_tensor_run(mesh, out: dict) -> None:
    """A W8 decoder (list and stacked layouts) cut over ``mesh``: each
    rank's forward of its rows and greedy generation; for the stacked
    layout the local shapes of ``W8_STACK_LEAVES`` and how many distinct
    tensors the layers' markers hold for each (one when held once)."""
    import torch

    from kosmosx_torch.generate.sampler import SamplingConfig, generate_text
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.parallel.sharding import shard_batch, shard_params
    from kosmosx_torch.utils.quantize import quantize_params_w8

    tokens, prompt = tp_tokens()
    for layout, scan in (("list", False), ("stack", True)):
        cfg = tp_config(scan_layers=scan)
        model = quantize_params_w8(KosmosLanguage(
            cfg, generator=torch.Generator().manual_seed(TP_SEED),
            device="cpu"), min_size=W8_MIN)
        shard_params(model, mesh)
        rows = shard_batch({"t": torch.from_numpy(tokens)}, mesh)["t"]
        with torch.no_grad():
            out[f"w8.{layout}.fwd"] = _np(model.apply(rows))
        out[f"w8.{layout}.gen"] = generate_text(
            model, cfg, torch.from_numpy(prompt),
            SamplingConfig(max_new_tokens=GEN_NEW, greedy=True)).numpy()
        if scan:
            for leaf in W8_STACK_LEAVES:
                held = [layer.get_parameter(leaf)
                        for layer in model["layers"]]
                out[f"w8.stack.shape.{leaf}"] = np.array(held[0].shape)
                out[f"w8.stack.held.{leaf}"] = np.int64(
                    len({t.data_ptr() for t in held}))


SERVE_CASES = {"fp32": {}, "int8": dict(kv_cache_dtype="int8",
                                        decode_attn_kernel=True)}


def task_expert(rank: int, out: dict) -> None:
    """MoE ``Trainer`` at data=2 with skewed routers (AdamW on ranks 0-1,
    Lion on 2-3, side by side), at data=2 x expert=2 and at expert=2 x
    tensor=2; then ``ServeEngine(mesh=)`` at tensor=2 (fp32 on ranks 0-1,
    an int8 cache on 2-3) and at fsdp=2 x tensor=2."""
    import torch.distributed as dist

    from kosmosx_torch.parallel.mesh import make_mesh

    pairs = {"adamw": make_mesh(data=2, devices=[0, 1]),
             "lion": make_mesh(data=2, devices=[2, 3])}
    name = "adamw" if rank < 2 else "lion"
    out.update({f"moe.data2.{name}.{k}": v
                for k, v in _moe_run(name, pairs[name]).items()})
    dist.barrier()
    for kind, kw, name in (("de", dict(data=2, expert=2), "adamw"),
                           ("et", dict(data=1, expert=2, tensor=2), "lion")):
        out.update({f"moe.{kind}.{name}.{k}": v
                    for k, v in _moe_run(name, make_mesh(**kw)).items()})
    pairs = {"fp32": make_mesh(data=1, tensor=2, devices=[0, 1]),
             "int8": make_mesh(data=1, tensor=2, devices=[2, 3])}
    case = "fp32" if rank < 2 else "int8"
    res = serve_run(serve_config(**SERVE_CASES[case]), pairs[case])
    out.update({f"serve.t2.{case}.{k}": v for k, v in res.items()})
    dist.barrier()
    res = serve_run(serve_config(), make_mesh(data=1, fsdp=2, tensor=2))
    out.update({f"serve.ft.fp32.{k}": v for k, v in res.items()})


def pp_config(**kw):
    """JAX's pipeline CFG (tests/test_pipeline.py:24-28) as a port config."""
    from kosmosx_torch.core.config import MagnetoConfig

    return MagnetoConfig(**{**dict(
        vocab_size=89, embed_dim=64, ffn_dim=128, layers=4, heads=4,
        max_positions=1024, multiway=True, dropout=0.0,
        attention_dropout=0.0, scan_layers=True), **kw})


PP_SEED = 8
PP_LR = 0.1
# name: (data, pipe, microbatches): M = S beside data, M > S (stash
# reuse), M < S
PP_CASES = {"d2p2m2": (2, 2, 2), "p4m8": (1, 4, 8), "p4m2": (1, 4, 2)}


def pp_batch():
    """8 rows x 128 tokens, labels shifted and weights (the last position
    0)."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(4, 89, (8, 128)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.ones((8, 1), np.int64)], 1)
    weights = np.ones((8, 128), np.float32)
    weights[:, -1] = 0.0
    return tokens, labels, weights


class SGD:
    """``p -= lr * g`` over named parameters, in place."""

    def __init__(self, params, lr):
        self.params, self.lr = params, lr

    def step(self, grads):
        import torch

        with torch.no_grad():
            for n, p in self.params.items():
                p.sub_(self.lr * grads[n])


def task_pipeline(rank: int, out: dict) -> None:
    """GPipe and 1F1B, one SGD step each, for every ``PP_CASES`` mesh:
    the loss, the schedule's ticks and stash, and the stage's parameters
    after the update."""
    import torch

    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.parallel import pipeline as pp

    cfg = pp_config()
    tokens, labels, weights = (torch.from_numpy(x) for x in pp_batch())
    for case, (data, pipe, m) in PP_CASES.items():
        mesh = pp.make_pp_mesh(data=data, pipe=pipe)
        for kind, make in (("gpipe", pp.make_pipeline_train_step),
                           ("1f1b", pp.make_pipeline_train_step_1f1b)):
            model = KosmosLanguage(cfg, generator=torch.Generator(
                ).manual_seed(PP_SEED), device="cpu")
            model.set_trainable()
            pp.pipeline_stage(model, mesh)
            step = make(cfg, SGD(dict(model.named_parameters()), PP_LR),
                        mesh, microbatches=m)
            pre = f"{case}.{kind}."
            out[pre + "loss"] = np.float32(step(model, tokens, labels,
                                                weights))
            out[pre + "ticks"] = np.int64(step.num_ticks)
            out[pre + "slots"] = np.int64(getattr(step, "stash_slots", 0))
            for n, p in model.named_parameters():
                out[pre + "param." + n] = _np(p)


TASKS = {"ring": lambda r, o: (task_ring(r, o), task_sp(r, o)),
         "trainer": task_trainer, "tensor": task_tensor,
         "expert": task_expert, "pipeline": task_pipeline}
OUT = None


def main() -> int:
    global OUT
    task, OUT = sys.argv[1], sys.argv[2]
    import torch

    torch.set_num_threads(1)
    from kosmosx_torch.parallel.mesh import initialize_distributed

    assert initialize_distributed(), "torch_dist_worker needs WORLD_SIZE > 1"
    import torch.distributed as dist

    rank = dist.get_rank()
    out: dict = {}
    TASKS[task](rank, out)
    np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
