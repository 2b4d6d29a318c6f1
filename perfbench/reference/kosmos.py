"""A plain float32 reference of Kosmos-X, for the benchmark's correctness
check.

It follows the published model (kyegomez/Kosmos-X ``kosmosx/model.py``):
a CLIP ViT-L/14 tower (last hidden state, no post-LayerNorm), a
PerceiverResampler to 64 latents, a bias-free projection to the decoder
width, the image block spliced in after the first two text tokens, the
embedding scaled twice (the model scales the token embeddings, and the
decoder scales its input again), learned positions, then a Magneto decoder
(sub-LN, xPos, multiway with every position on expert A) and an untied
head. Everything is plain ``torch`` on float32 with TF32 off; it imports
nothing of the program under test and takes nothing from it: the weights
come from ``perfbench.weights``, and the weight-only int8 codes are worked
out here again from the same bfloat16 weights.

``Lin`` takes the precision of the linear products, and ``prepare`` that
of the weights: ``"fp32"`` (the reference), ``"fp8"`` or ``"int8"``
(every product's operands and the gradient into it rounded under
per-tensor scales: controls of a bfloat16 configuration), ``"w8"`` (the
weights as per-output-channel int8 codes: the weight-only int8
configuration) and ``"int4"`` (the same with 4-bit codes: its control).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("fp32", "fp8", "int8", "w8", "int4")
# the leaf names that take no weight decay
_NO_DECAY = ("scale", "bias", "b", "table", "class_embedding", "latents",
             "media_pos_emb")


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# the parameter tree: dotted paths, shapes and initial distributions
# ---------------------------------------------------------------------------


def _linear(path, i, o, *, bias=True, gain=1.0) -> List[tuple]:
    out = [(f"{path}.w", (i, o), "uniform", gain * math.sqrt(6.0 / (i + o)))]
    if bias:
        out.append((f"{path}.b", (o,), "zeros", 0.0))
    return out


def _ln(path, d) -> List[tuple]:
    return [(f"{path}.scale", (d,), "ones", 0.0),
            (f"{path}.bias", (d,), "zeros", 0.0)]


def _multiway(path, make) -> List[tuple]:
    return make(f"{path}.A") + make(f"{path}.B")


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """``(path, shape, kind, arg)`` of every parameter: ``kind`` is
    ``"uniform"`` (in [-arg, arg]), ``"normal"`` (std ``arg``), ``"zeros"``
    or ``"ones"``; an embedding table's padding row is zeroed after. The
    schemes are the published ones: xavier-uniform projections, q/k/v at
    gain 1/sqrt(2), the Magneto gain sqrt(log(2N)) on v/out/fc1/fc2 of the
    decoder, N(0, d**-0.5) tables and head."""
    v, r, d = cfg["vision"], cfg["resampler"], cfg["decoder"]
    specs: List[tuple] = []
    vd, patch = v["hidden_dim"], 3 * v["patch_size"] ** 2
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    specs += [("clip.class_embedding", (vd,), "normal", vd ** -0.5),
              ("clip.patch_embed.w", (patch, vd), "uniform",
               math.sqrt(6.0 / (patch + vd))),
              ("clip.pos_embed.table", (seq, vd), "normal", vd ** -0.5)]
    specs += _ln("clip.pre_ln", vd)
    for i in range(v["layers"]):
        p = f"clip.layers.{i}"
        specs += _ln(f"{p}.ln1", vd)
        for name in ("q", "k", "v", "out"):
            specs += _linear(f"{p}.attn.{name}", vd, vd)
        specs += _ln(f"{p}.ln2", vd)
        specs += _linear(f"{p}.mlp.fc1", vd, v["mlp_dim"])
        specs += _linear(f"{p}.mlp.fc2", v["mlp_dim"], vd)
    specs += _ln("clip.post_ln", vd)

    rd, inner = r["dim"], r["dim_head"] * r["heads"]
    specs += [("resampler.latents", (r["num_latents"], rd), "normal", 1.0),
              ("resampler.media_pos_emb", (r["num_media_embeds"], rd),
               "normal", 1.0)]
    for i in range(r["depth"]):
        p = f"resampler.layers.{i}"
        specs += _ln(f"{p}.attn.norm_media", rd)
        specs += _ln(f"{p}.attn.norm_latents", rd)
        specs += _linear(f"{p}.attn.to_q", rd, inner, bias=False)
        specs += _linear(f"{p}.attn.to_kv", rd, 2 * inner, bias=False)
        specs += _linear(f"{p}.attn.to_out", inner, rd, bias=False)
        specs += _ln(f"{p}.ff.norm", rd)
        specs += _linear(f"{p}.ff.fc1", rd, r["ff_mult"] * rd, bias=False)
        specs += _linear(f"{p}.ff.fc2", r["ff_mult"] * rd, rd, bias=False)
    specs += _ln("resampler.norm", rd)

    e, f, n = d["embed_dim"], d["ffn_dim"], d["layers"]
    specs.append(("image_proj.w", (rd, e), "normal", rd ** -0.5))
    specs += [("decoder.embed.table", (d["vocab_size"], e), "normal",
               e ** -0.5),
              ("decoder.pos.table", (d["max_positions"], e), "normal",
               e ** -0.5),
              ("decoder.out_proj.w", (e, d["vocab_size"]), "normal",
               e ** -0.5)]
    gamma = math.sqrt(math.log(2.0 * n))
    qk = 1.0 / math.sqrt(2.0)
    for i in range(n):
        p = f"decoder.layers.{i}"
        for name, gain in (("q", qk), ("k", qk), ("v", qk * gamma),
                           ("out", gamma)):
            specs += _multiway(f"{p}.attn.{name}",
                               lambda q, g=gain: _linear(q, e, e, gain=g))
        specs += _multiway(f"{p}.attn.inner_ln", lambda q: _ln(q, e))
        specs += _multiway(f"{p}.attn_ln", lambda q: _ln(q, e))
        specs += _multiway(f"{p}.ffn", lambda q: (
            _linear(f"{q}.fc1", e, f, gain=gamma)
            + _linear(f"{q}.fc2", f, e, gain=gamma) + _ln(f"{q}.ffn_ln", f)))
        specs += _multiway(f"{p}.final_ln", lambda q: _ln(q, e))
    specs += _multiway("decoder.ln", lambda q: _ln(q, e))
    return specs


def padding_rows(cfg: dict) -> Dict[str, int]:
    """The tables whose padding row is zero, and that row."""
    pad = cfg["decoder"]["padding_idx"]
    return {"decoder.embed.table": pad, "decoder.pos.table": pad}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """A flat ``{dotted path: tensor}`` as the nested dict/list tree, a
    numeric path component indexing a list."""
    def slot(node, key: str, make):
        if isinstance(node, list):
            key = int(key)
            node.extend([None] * (key + 1 - len(node)))
        if node[key] is None if isinstance(node, list) else key not in node:
            node[key] = make()
        return node[key]

    root: dict = {}
    for path, value in flat.items():
        parts = path.split(".")
        node = root
        for key, nxt in zip(parts[:-1], parts[1:]):
            node = slot(node, key, list if nxt.isdigit() else dict)
        node[parts[-1]] = value
    return root


# ---------------------------------------------------------------------------
# precision of the linear products
# ---------------------------------------------------------------------------


def quantize_w(w: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-output-channel symmetric codes of a bfloat16 (in, out) weight,
    dequantized to float32: the scale is absmax / levels rounded to
    bfloat16 (1 where a column is all zero), the codes ``w / scale``
    rounded half to even and clipped to +-levels."""
    amax = w.float().abs().amax(dim=-2, keepdim=True)
    scale = (amax / levels).to(torch.bfloat16).float()
    scale = torch.where(amax == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(w.float() / scale), -levels, levels)
    return codes * scale


def quantize_table(t: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-row codes of a bfloat16 (V, D) table, dequantized to float32."""
    return quantize_w(t.t(), levels).t()


def _per_tensor(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """``t`` rounded to ``fmt`` under a per-tensor scale, in float32:
    ``"e4m3"`` and ``"e5m2"`` (fp8), or ``"int8"`` (symmetric, 127
    levels)."""
    t = t.detach()
    amax = t.abs().amax().clamp_min(1e-30)
    if fmt == "int8":
        s = amax / 127.0
        return torch.clamp(torch.round(t / s), -127, 127) * s
    dtype, top = {"e4m3": (torch.float8_e4m3fn, 448.0),
                  "e5m2": (torch.float8_e5m2, 57344.0)}[fmt]
    s = amax / top
    return (t / s).to(dtype).float() * s


class _Round(torch.autograd.Function):
    """Rounds the value in the forward (``fwd``) and the gradient in the
    backward (``bwd``), each to its format (None: left as it is)."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return t if fwd is None else _per_tensor(t, fwd)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.bwd is None else _per_tensor(g, ctx.bwd)), None, None


# the low-precision products of a control: (operands' format, the
# format of the gradient flowing into the product's output)
_LOW = {"fp8": ("e4m3", "e5m2"), "int8": ("int8", "int8")}


def eligible_w8(path: str, shape, layers: int) -> bool:
    """The weight-only int8 recipe's leaves: a "w" or "table" leaf of two
    or more dims and at least 4096 elements, a decoder layer's leaf judged
    as its stack over the ``layers`` layers (the recipe's layout)."""
    last = path.rsplit(".", 1)[-1]
    stack = layers if path.startswith("decoder.layers.") else 1
    return last in ("w", "table") and len(shape) >= 2 and \
        stack * math.prod(shape) >= 4096


def prepare(flat: Dict[str, torch.Tensor], precision: str, layers: int,
            device=None) -> dict:
    """The reference's float32 tree from the benchmark's weights: for
    ``"w8"``/``"int4"`` every eligible weight replaced by its dequantized
    codes (from its bfloat16 value)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    out = {}
    for path, t in flat.items():
        t = t.to(device) if device is not None else t
        if precision in ("w8", "int4") and eligible_w8(path, t.shape, layers):
            levels = 127 if precision == "w8" else 7
            t = t.to(torch.bfloat16)
            t = quantize_table(t, levels) if path.endswith(".table") \
                else quantize_w(t, levels)
        out[path] = t.float()
    return nest(out)


class Lin:
    """The linear product ``x @ w (+ b)`` at one precision: float32, or a
    control's low-precision product (``"fp8"``: e4m3 operands, the
    gradient into it in e5m2; ``"int8"``: int8 operands and gradient;
    per-tensor scales) with float32 accumulation."""

    def __init__(self, precision: str = "fp32"):
        self.low = _LOW.get(precision)

    def __call__(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        w = p["w"]
        if self.low is None:
            y = x @ w
        else:
            fmt, grad = self.low
            y = _Round.apply(_Round.apply(x, fmt, None)
                             @ _Round.apply(w, fmt, None), None, grad)
        return y + p["b"] if "b" in p else y


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def vision(p: dict, cfg: dict, images: torch.Tensor, lin: Lin) -> torch.Tensor:
    """CLIP ViT: (B, 3, H, W) -> last hidden state (B, 257, d)."""
    v = cfg["vision"]
    b, c, hh, ww = images.shape
    ps = v["patch_size"]
    x = images.reshape(b, c, hh // ps, ps, ww // ps, ps).permute(
        0, 2, 4, 1, 3, 5).reshape(b, (hh // ps) * (ww // ps), c * ps * ps)
    x = lin(p["patch_embed"], x)
    cls = p["class_embedding"].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"]["table"][None]
    eps = v["layer_norm_eps"]
    x = layer_norm(p["pre_ln"], x, eps)
    heads = v["heads"]
    hd = v["hidden_dim"] // heads
    for lp in p["layers"]:
        h = layer_norm(lp["ln1"], x, eps)
        a = lp["attn"]

        def split(t):
            return t.reshape(b, -1, heads, hd).transpose(1, 2)

        q = split(lin(a["q"], h) * hd ** -0.5)
        k, vv = split(lin(a["k"], h)), split(lin(a["v"], h))
        o = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ vv
        x = x + lin(a["out"], o.transpose(1, 2).reshape(b, -1, heads * hd))
        h = F.gelu(lin(lp["mlp"]["fc1"], layer_norm(lp["ln2"], x, eps)))
        x = x + lin(lp["mlp"]["fc2"], h)
    return x


def resample(p: dict, cfg: dict, media: torch.Tensor, lin: Lin) -> torch.Tensor:
    """PerceiverResampler, one image a row: (B, 257, d) -> (B, 64, d)."""
    r = cfg["resampler"]
    b = media.shape[0]
    heads, hd = r["heads"], r["dim_head"]
    media = media + p["media_pos_emb"][0]
    lat = p["latents"].expand(b, -1, -1)

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)

    for lp in p["layers"]:
        a = lp["attn"]
        x = layer_norm(a["norm_media"], media)
        ln = layer_norm(a["norm_latents"], lat)
        q = split(lin(a["to_q"], ln)) * hd ** -0.5
        k, vv = lin(a["to_kv"], torch.cat([x, ln], dim=1)).chunk(2, dim=-1)
        o = torch.softmax(q @ split(k).transpose(-1, -2), dim=-1) @ split(vv)
        lat = lat + lin(a["to_out"], o.transpose(1, 2).reshape(b, -1,
                                                               heads * hd))
        f = lp["ff"]
        lat = lat + lin(f["fc2"], F.gelu(lin(f["fc1"],
                                             layer_norm(f["norm"], lat))))
    return layer_norm(p["norm"], lat)


def encode_images(p: dict, cfg: dict, images: torch.Tensor,
                  lin: Lin) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 64, decoder width); the vision tower takes no
    gradient (it is frozen in training)."""
    with torch.no_grad():
        feats = vision(p["clip"], cfg, images, lin)
    return lin(p["image_proj"], resample(p["resampler"], cfg, feats, lin))


def embed(p: dict, cfg: dict, tokens: torch.Tensor,
          image_emb: Optional[torch.Tensor]) -> torch.Tensor:
    """The decoder input: token embeddings times the embedding scale, the
    image block after the first ``splice_index`` tokens, all of it times
    the scale again, plus the learned positions."""
    d = cfg["decoder"]
    scale = math.sqrt(d["embed_dim"]) if d["scale_embedding"] else 1.0
    x = scale * p["decoder"]["embed"]["table"][tokens]
    if image_emb is not None:
        s = cfg["splice_index"]
        x = torch.cat([x[:, :s], image_emb, x[:, s:]], dim=1)
    if cfg["parity_double_scale"]:
        x = scale * x
    rows = d["padding_idx"] + 1 + torch.arange(x.shape[1], device=x.device)
    return x + p["decoder"]["pos"]["table"][rows]


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    return torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).reshape(x.shape)


def xpos(x: torch.Tensor, scale_base: int, *, down: bool) -> torch.Tensor:
    """xPos on (..., L, hd) at positions 0..L-1, the decay centred at
    L // 2 (the centre cancels in q.k)."""
    length, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    pos = torch.arange(length, dtype=torch.float32, device=x.device)
    zeta = (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
            + 0.4 * hd) / (1.4 * hd)
    scale = zeta ** ((pos - length // 2) / scale_base)[:, None]
    if down:
        scale = 1.0 / scale
    inv = 1.0 / 10000.0 ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos[:, None] * inv
    sin = (torch.sin(ang) * scale).repeat_interleave(2, dim=-1)
    cos = (torch.cos(ang) * scale).repeat_interleave(2, dim=-1)
    return x * cos + _rotate_every_two(x) * sin


def decoder_layer(lp: dict, cfg: dict, x: torch.Tensor, lin: Lin) -> torch.Tensor:
    d = cfg["decoder"]
    heads = d["heads"]
    hd = d["embed_dim"] // heads
    b, length, e = x.shape
    a = lp["attn"]

    def split(t):
        return t.reshape(b, length, heads, hd).transpose(1, 2)

    h = layer_norm(lp["attn_ln"]["A"], x)
    q = split(lin(a["q"]["A"], h) * hd ** -0.5)
    k, v = split(lin(a["k"]["A"], h)), split(lin(a["v"]["A"], h))
    if d["xpos_rel_pos"]:
        q = xpos(q, d["xpos_scale_base"], down=False)
        k = xpos(k, d["xpos_scale_base"], down=True)
    s = q @ k.transpose(-1, -2)
    causal = torch.ones(length, length, dtype=torch.bool,
                        device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, length, e)
    o = layer_norm(a["inner_ln"]["A"], o)
    x = x + lin(a["out"]["A"], o)
    f = lp["ffn"]["A"]
    h = F.gelu(lin(f["fc1"], layer_norm(lp["final_ln"]["A"], x)))
    return x + lin(f["fc2"], layer_norm(f["ffn_ln"], h))


def hidden(p: dict, cfg: dict, x: torch.Tensor, lin: Lin, *,
           remat: bool = False) -> torch.Tensor:
    """The decoder layers and the final LayerNorm; ``remat`` recomputes
    each layer in the backward (memory only: the arithmetic is the same)."""
    for lp in p["decoder"]["layers"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(decoder_layer, lp, cfg, x, lin, use_reentrant=False)
        else:
            x = decoder_layer(lp, cfg, x, lin)
    return layer_norm(p["decoder"]["ln"]["A"], x)


def logits(p: dict, cfg: dict, tokens: torch.Tensor,
           images: Optional[torch.Tensor], lin: Lin, *,
           remat: bool = False) -> torch.Tensor:
    """(B, Lt) tokens and one image a row (or none) -> (B, L, vocab)."""
    img = None if images is None else encode_images(p, cfg, images, lin)
    h = hidden(p, cfg, embed(p, cfg, tokens, img), lin, remat=remat)
    return lin(p["decoder"]["out_proj"], h)


def text_nll(logits_: torch.Tensor, tokens: torch.Tensor, cfg: dict
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of next-token negative log-likelihoods over the text targets,
    their count): the image block's logits and the ``<image>`` token's are
    no predictions of text; padding tokens are no targets."""
    s, k = cfg["splice_index"], cfg["image_embed_len"]
    text = torch.cat([logits_[:, :s - 1], logits_[:, s + k - 1:]], dim=1)
    targets = tokens[:, 1:]
    mask = (targets != cfg["decoder"]["padding_idx"]).float()
    logp = torch.log_softmax(text[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return (nll * mask).sum(), mask.sum()


# ---------------------------------------------------------------------------
# training: the loss, its gradients and Lion
# ---------------------------------------------------------------------------


def trainable_paths(p: dict, frozen=("clip",)) -> Dict[str, torch.Tensor]:
    """``{dotted path: leaf}`` of the leaves outside the frozen subtrees."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            path = f"{prefix}{k}"
            if isinstance(v, torch.Tensor):
                out[path] = v
            else:
                walk(v, path + ".")

    for key, sub in p.items():
        if key not in frozen:
            walk(sub, key + ".")
    return out


def loss_and_grads(p: dict, cfg: dict, batch: dict, lin: Lin,
                   leaves: Dict[str, torch.Tensor]):
    """The batch's mean next-token loss and its gradients on ``leaves``,
    a row at a time (each row's share of the mean), layers recomputed in
    the backward to fit."""
    tokens, images = batch["text_tokens"], batch["images"]
    count = (tokens[:, 1:] != cfg["decoder"]["padding_idx"]).sum().float()
    for t in leaves.values():
        t.requires_grad_(True)
    grads = {k: torch.zeros_like(t) for k, t in leaves.items()}
    total = 0.0
    for r in range(tokens.shape[0]):
        out = logits(p, cfg, tokens[r:r + 1], images[r:r + 1], lin, remat=True)
        nll, _ = text_nll(out, tokens[r:r + 1], cfg)
        del out
        part = nll / count
        gs = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
        for (k, _), g in zip(leaves.items(), gs):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
        del part, gs
    for t in leaves.values():
        t.requires_grad_(False)
    return total, grads


def decays(path: str, t: torch.Tensor) -> bool:
    return path.rsplit(".", 1)[-1] not in _NO_DECAY and t.ndim >= 2


class Lion:
    """Global-norm clipping, then Lion with decoupled weight decay on the
    matmul weights and a constant learning rate."""

    def __init__(self, leaves: Dict[str, torch.Tensor], *, lr: float,
                 beta1: float, beta2: float, weight_decay: float,
                 clip: float):
        self.leaves = leaves
        self.lr, self.b1, self.b2 = lr, beta1, beta2
        self.wd, self.clip = weight_decay, clip
        self.m = {k: torch.zeros_like(t) for k, t in leaves.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update the leaves in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        factor = 1.0 if float(norm) < self.clip else self.clip / norm
        clipped = {}
        for k, p in self.leaves.items():
            g = grads[k] * factor
            clipped[k] = g
            u = torch.sign(self.b1 * self.m[k] + (1 - self.b1) * g)
            self.m[k] = self.b2 * self.m[k] + (1 - self.b2) * g
            if decays(k, p):
                u = u + self.wd * p
            p.sub_(self.lr * u)
        return clipped
