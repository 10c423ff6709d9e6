"""The plain reference of the benchmark's models: float32 PyTorch (TF32
off), no kernels, no cache, written from the models' equations as the
configuration files state them (``port``). It imports nothing of the
program, and takes only what the benchmark makes: the weights drawn
again from the seed (:mod:`perfbench.weights`) and the traffic's tokens.

It works a layer or a repeat unit at a time so that it fits beside what
is left on the card: weights stay in their served type and are widened
to float32 at each use, training checkpoints each block, attention runs
a sequence at a time.

:class:`Precision` with ``fp8`` is the control: every product of the
forward and backward rounds its operands to float8 e4m3 (one scale per
tensor), the Mamba2 scan's inputs too. It is the step below the
configuration's bfloat16.

Semantics (each a departure of the program from the published model is
noted in the configuration file and followed here):
- RMS norm ``x * rsqrt(mean(x^2) + eps) * w``; RoPE on rotated halves,
  angles ``pos / theta^(2i/d)``; attention scale ``1/sqrt(D)``, causal.
- Mamba2: z, x, B|C and dt projections; depthwise causal conv + SiLU on x
  and on B|C; ``dt = softplus(dt_raw + dt_bias)``, ``A = -exp(A_log)``;
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = C_t h_t + D x_t``
  (one B/C group); ``rms(y * silu(z)) @ out_proj``.
- MLA (deepseek, no q LoRA): ``c_kv = rms(x W_dkv[:r])``, rotated
  ``k_rope`` from ``W_dkv[r:]``, per head ``k = [c_kv W_uk, k_rope]``,
  ``v = c_kv W_uv``, ``q = [q_nope, rope(q_rope)]``.
- MoE: float32 router, top-k, gates a softmax over the k chosen logits
  (the softmax over all experts, its chosen k renormalised); every
  (token, choice) pair is computed, none dropped; shared experts as one
  SwiGLU MLP of ``n_shared * expert_d_ff``.
- AdamW: float32 master weights, from which each step computes in the
  configuration's dtype; linear warm-up, global-norm clip, bias-corrected
  moments, ``p -= lr (mh / (sqrt(vh) + eps) + wd p)``; with compressed
  gradients
  each leaf's gradient plus its carried error is quantised to int8 in
  blocks of 256 (scale absmax / 127, round half to even), and the error
  carried to the next step.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0
#: positions of the Mamba2 scan's chunks here (the program's differ)
SCAN_CHUNK = 32
QUANT_BLOCK = 256


@contextmanager
def exact_float32():
    """TF32 off for the reference's products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ----------------------------------------------------------- precision
def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale (absmax / 448), in t's
    dtype."""
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands in e4m3, and each product of the
    backward with its operands in e4m3 too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2 and qa.dim() > 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


class Precision:
    """Where the reference rounds: nowhere (float32), or e4m3 in every
    product (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b

    def round(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundSTE.apply(t) if self.fp8 else t


F32 = Precision()
FP8 = Precision(fp8=True)


# ------------------------------------------------------------- weights
class Weights:
    """Leaves by path, widened to float32 where they are used."""

    def __init__(self, flat: Dict[str, torch.Tensor]):
        self.flat = flat

    def __call__(self, path: str, r: Optional[int] = None) -> torch.Tensor:
        t = self.flat[path]
        return (t if r is None else t[r]).float()


# -------------------------------------------------------------- pieces
def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, d) at positions 0..S-1: the two halves rotated."""
    S, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (np.arange(0, d, 2) / d)
    inv = torch.as_tensor(inv, dtype=torch.float32, device=x.device)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v, P: Precision) -> torch.Tensor:
    """Causal attention, a sequence at a time. q, k (B, S, H, D), v (B, S,
    H, Dv) -> (B, S, H * Dv)."""
    B, S, H, D = q.shape
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    outs = []
    for b in range(B):
        qb = q[b].transpose(0, 1) / math.sqrt(D)         # (H, S, D)
        kb = k[b].transpose(0, 1)
        vb = v[b].transpose(0, 1)
        s = P.mm(qb, kb.transpose(-1, -2)).masked_fill(~keep, float("-inf"))
        o = P.mm(torch.softmax(s, dim=-1), vb)           # (H, S, Dv)
        outs.append(o.transpose(0, 1).reshape(S, -1))
    return torch.stack(outs)


def swiglu(x, W, prefix: str, r, P: Precision) -> torch.Tensor:
    h = F.silu(P.mm(x, W(f"{prefix}.gate", r))) * P.mm(x, W(f"{prefix}.up", r))
    return P.mm(h, W(f"{prefix}.down", r))


def causal_conv_silu(u: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence: u (B, S, C), w (W, C)."""
    W, S = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, W - 1, 0))
    out = b + sum(up[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out)


def ssd(x, dt, A, Bm, Cm, L: int = SCAN_CHUNK) -> torch.Tensor:
    """The Mamba2 recurrence over the sequence, y without the D skip.
    x (b, s, h, p), dt (b, s, h), A (h,), Bm / Cm (b, s, n) -> (b, s, h, p).
    Within a chunk of L steps, the quadratic form; between chunks, the
    state h carried one chunk at a time."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-s) % L
    if pad:         # steps with dt 0 neither decay nor feed the state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    c = x.shape[1] // L
    X = x.reshape(b, c, L, h, p)
    T = dt.reshape(b, c, L, h)
    Bc = Bm.reshape(b, c, L, n)
    Cc = Cm.reshape(b, c, L, n)
    acum = torch.cumsum(T * A, dim=2)                    # (b, c, L, h)
    lower = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    seg = (acum[:, :, :, None, :] - acum[:, :, None, :, :]).masked_fill(
        ~lower[None, None, :, :, None], float("-inf"))   # (b, c, i, j, h)
    M = (torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
         * torch.exp(seg) * T[:, :, None, :, :])
    y = torch.einsum("bcijh,bcjhp->bcihp", M, X)
    w_end = torch.exp(acum[:, :, -1:, :] - acum) * T      # (b, c, L, h)
    local = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w_end, Bc, X)
    state = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    carried = []
    for k in range(c):
        carried.append(torch.einsum("bin,bhpn->bihp", Cc[:, k], state)
                       * torch.exp(acum[:, k])[..., None])
        state = torch.exp(acum[:, k, -1])[:, :, None, None] * state + local[:, k]
    y = y + torch.stack(carried, dim=1)
    return y.reshape(b, c * L, h, p)[:, :s]


# -------------------------------------------------------------- blocks
def mamba_block(x, W, pre: str, r, port: Dict, P: Precision):
    eps, n = port["norm_eps"], port["ssm_state"]
    hd = port["mamba_headdim"]
    m = f"{pre}.mamba"
    u = rms(x, W(f"{pre}.ln1", r), eps)
    z = P.mm(u, W(f"{m}.in_z", r))
    xi = causal_conv_silu(P.mm(u, W(f"{m}.in_x", r)), W(f"{m}.conv_x_w", r),
                          W(f"{m}.conv_x_b", r))
    bc = causal_conv_silu(P.mm(u, W(f"{m}.in_bc", r)),
                          W(f"{m}.conv_bc_w", r), W(f"{m}.conv_bc_b", r))
    dt_raw = P.mm(u, W(f"{m}.in_dt", r)) + W(f"{m}.dt_bias", r)
    dt = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))      # softplus
    A = -torch.exp(W(f"{m}.A_log", r))
    B, S, _ = x.shape
    xs = xi.reshape(B, S, -1, hd)
    y = ssd(P.round(xs), dt, A, P.round(bc[..., :n]), P.round(bc[..., n:]))
    y = y + xs * W(f"{m}.D", r)[:, None]
    g = rms(y.reshape(B, S, -1) * F.silu(z), W(f"{m}.gate_norm", r), eps)
    return x + P.mm(g, W(f"{m}.out_proj", r))


def moe(u, W, pre: str, r, port: Dict, P: Precision) -> torch.Tensor:
    """u (B, S, d) -> (B, S, d): the routed experts, every (token, choice)
    pair kept, plus the shared experts."""
    B, S, d = u.shape
    T, E, k = B * S, port["n_experts"], port["top_k"]
    xt = u.reshape(T, d)
    topv, topi = torch.topk(P.mm(xt, W(f"{pre}.router", r)), k, dim=-1)
    gates = torch.softmax(topv, dim=-1)
    y = torch.zeros_like(xt)
    wg, wu, wd = (W(f"{pre}.experts_{n}", r) for n in ("gate", "up", "down"))
    for ex in range(E):
        tok, slot = torch.nonzero(topi == ex, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        h = F.silu(P.mm(xe, wg[ex])) * P.mm(xe, wu[ex])
        y = y.index_add(0, tok, P.mm(h, wd[ex]) * gates[tok, slot, None])
    if port.get("n_shared_experts", 0) > 0:
        y = y + swiglu(xt, W, f"{pre}.shared", r, P)
    return y.reshape(B, S, d)


def mla_block(x, W, pre: str, r, port: Dict, P: Precision, dense: bool):
    eps, theta = port["norm_eps"], port["rope_theta"]
    H, R = port["n_heads"], port["kv_lora_rank"]
    nope, rp, dv = port["qk_nope_dim"], port["qk_rope_dim"], port["v_head_dim"]
    a = f"{pre}.attn"
    B, S, _ = x.shape
    u = rms(x, W(f"{pre}.ln1", r), eps)
    q = P.mm(u, W(f"{a}.wq", r)).reshape(B, S, H, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    dkv = P.mm(u, W(f"{a}.w_dkv", r))
    ckv = rms(dkv[..., :R], W(f"{a}.kv_norm", r), eps)
    k_rope = rope(dkv[..., None, R:], theta).expand(B, S, H, rp)
    k = torch.cat([P.mm(ckv, W(f"{a}.w_uk", r)).reshape(B, S, H, nope),
                   k_rope], dim=-1)
    v = P.mm(ckv, W(f"{a}.w_uv", r)).reshape(B, S, H, dv)
    x = x + P.mm(attention(q, k, v, P), W(f"{a}.wo", r))
    u = rms(x, W(f"{pre}.ln2", r), eps)
    if dense:
        return x + swiglu(u, W, f"{pre}.mlp", r, P)
    return x + moe(u, W, f"{pre}.moe", r, port, P)


def block(kind: str, x, W, pre: str, r, port: Dict, P: Precision):
    if kind == "mamba":
        return mamba_block(x, W, pre, r, port, P)
    if kind in ("mla_dense", "mla_moe"):
        return mla_block(x, W, pre, r, port, P, dense=kind == "mla_dense")
    raise ValueError(kind)


def units(port: Dict) -> Iterator[Tuple[int, int, Sequence[str]]]:
    """(stage, repeat, unit kinds) in the order they run."""
    for s, st in enumerate(port["stages"]):
        for r in range(st["repeats"]):
            yield s, r, st["unit"]


def hidden(W, port: Dict, tokens: torch.Tensor, P: Precision,
           remat: bool = False) -> torch.Tensor:
    """The final norm's input (B, S, d) for tokens (B, S); with ``remat``
    each block is one checkpoint."""
    x = W.flat["embed"][tokens].float()
    for s, r, unit in units(port):
        for j, kind in enumerate(unit):
            args = (kind, x, W, f"stages.{s}.{j}", r, port, P)
            x = (checkpoint(block, *args, use_reentrant=False) if remat
                 else block(*args))
    return x


def head_weight(W, port: Dict) -> torch.Tensor:
    """(d, V) of the output head: the embedding's transpose when tied."""
    return W("embed").T if port["tie_embeddings"] else W("lm_head")


def logits(x, W, port: Dict, P: Precision) -> torch.Tensor:
    return P.mm(rms(x, W("final_norm"), port["norm_eps"]), head_weight(W, port))


# ------------------------------------------------------------- prefill
@torch.no_grad()
def forward(flat: Dict[str, torch.Tensor], port: Dict, tokens: np.ndarray,
            P: Precision = F32) -> torch.Tensor:
    """The logits (B, S, V) over prompts ``tokens`` (B, S)."""
    with exact_float32():
        W = Weights(flat)
        dev = flat["embed"].device
        x = hidden(W, port, torch.as_tensor(tokens, device=dev).long(), P)
        return torch.stack([logits(x[b], W, port, P) for b in range(len(x))])


@torch.no_grad()
def prefill(flat: Dict[str, torch.Tensor], port: Dict, tokens: np.ndarray,
            chosen: Sequence[torch.Tensor], P: Precision = F32,
            ) -> Tuple[List[Tuple[float, float]], torch.Tensor]:
    """(for each (B, S) tensor of token ids in ``chosen``, the widest and
    the mean over positions of the gap by which the chosen token's logit
    lies below the best logit at its position; the argmax (B, S) of this
    precision's own logits), over prompts ``tokens`` (B, S)."""
    with exact_float32():
        W = Weights(flat)
        dev = flat["embed"].device
        x = hidden(W, port, torch.as_tensor(tokens, device=dev).long(), P)
        widest = [0.0] * len(chosen)
        total = [0.0] * len(chosen)
        top = torch.empty(x.shape[:2], dtype=torch.long, device=dev)
        for b in range(x.shape[0]):
            lg = logits(x[b], W, port, P)
            best, top[b] = lg.max(dim=-1)
            for i, c in enumerate(chosen):
                got = lg.gather(-1, c[b].to(dev).long()[:, None])[:, 0]
                widest[i] = max(widest[i], float((best - got).max()))
                total[i] += float((best - got).sum())
            del lg
        n = x.shape[0] * x.shape[1]
        return [(w, t / n) for w, t in zip(widest, total)], top


# ------------------------------------------------------------ training
def quantised(g: torch.Tensor, err: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8-quantised g + err, dequantised, in g's shape; new error)."""
    n = g.numel()
    pad = (-n) % QUANT_BLOCK
    carried = F.pad(g.reshape(-1) + err.reshape(-1), (0, pad))
    blocks = carried.reshape(-1, QUANT_BLOCK)
    scale = blocks.abs().amax(dim=1).clamp_min(1e-12) / torch.tensor(
        127.0, device=g.device)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    deq = (q * scale[:, None]).reshape(-1)
    return deq[:n].reshape(g.shape), (carried - deq)[:n].reshape(g.shape)


def loss(W, port: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         P: Precision) -> torch.Tensor:
    """Mean next-token NLL over the positions with labels >= 0."""
    x = hidden(W, port, tokens, P, remat=True)
    lg = logits(x, W, port, P)
    nll = -torch.log_softmax(lg, dim=-1).gather(
        -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


class Trainer:
    """AdamW steps of the reference from the weights ``flat``, one batch
    of (rows, seq + 1) tokens a step. The master weights are float32;
    each step after the first computes with them rounded to the
    configuration's dtype (every leaf, as the stated bfloat16-compute,
    float32-master discipline rounds them), widened to float32. ``m`` and
    ``master`` are the first moments and the master weights by leaf."""

    def __init__(self, flat: Dict[str, torch.Tensor], port: Dict,
                 adamw: Dict, compressed: bool, P: Precision = F32):
        self.flat, self.port, self.adamw = flat, port, adamw
        self.compressed, self.P, self.t = compressed, P, 0
        self.names = list(flat)
        self.served = {"bfloat16": torch.bfloat16,
                       "float32": torch.float32}[port["dtype"]]
        self.master = {k: flat[k].detach().to(torch.float32, copy=True)
                       for k in self.names}
        zeros = lambda: {k: torch.zeros_like(self.master[k])
                         for k in self.names}
        self.m, self.v, self.err = zeros(), zeros(), zeros()

    def step(self, rows: np.ndarray) -> float:
        """One step on ``rows``; its loss."""
        self.t += 1
        t, adamw, names = self.t, self.adamw, self.names
        dev = self.flat[names[0]].device
        b1, b2, eps = adamw["b1"], adamw["b2"], adamw["eps"]
        with exact_float32():
            live = {k: (self.master[k] if t == 1
                        else self.master[k].to(self.served))
                    .to(torch.float32, copy=True).requires_grad_()
                    for k in names}
            rows = torch.as_tensor(np.asarray(rows), device=dev).long()
            L = loss(Weights(live), self.port, rows[:, :-1], rows[:, 1:],
                     self.P)
            grads = torch.autograd.grad(L, [live[k] for k in names],
                                        allow_unused=True)
            del live
            value = float(L.detach())
            del L
            with torch.no_grad():
                g = {}
                for k, gk in zip(names, grads):
                    gk = torch.zeros_like(self.master[k]) if gk is None else gk
                    if self.compressed:
                        gk, self.err[k] = quantised(gk, self.err[k])
                    g[k] = gk
                del grads
                gnorm = torch.sqrt(sum(torch.dot(x.reshape(-1), x.reshape(-1))
                                       for x in g.values()))
                scale = torch.clamp_max(adamw["grad_clip"] / (gnorm + 1e-9),
                                        1.0)
                lr = adamw["lr"] * min(t / max(adamw["warmup_steps"], 1), 1.0)
                for k in names:
                    gk = g.pop(k) * scale
                    m, v, p = self.m[k], self.v[k], self.master[k]
                    m.mul_(b1).add_((1 - b1) * gk)
                    v.mul_(b2).add_((1 - b2) * gk * gk)
                    mh = m / (1 - b1 ** t)
                    vh = v / (1 - b2 ** t)
                    p.sub_(lr * (mh / (torch.sqrt(vh) + eps)
                                 + adamw["weight_decay"] * p))
        return value


def train(flat: Dict[str, torch.Tensor], port: Dict,
          batches: Sequence[np.ndarray], adamw: Dict, compressed: bool,
          P: Precision = F32) -> Dict:
    """Follow len(batches) steps of :class:`Trainer`. Returns {"loss":
    [each step's], "grad": {leaf: the norm of its first gradient as AdamW
    takes it (clipped), from the first moment after step 1}, "change":
    {leaf: the norm of its master's change over the steps}}."""
    tr = Trainer(flat, port, adamw, compressed, P)
    out: Dict = {"loss": [], "grad": {}, "change": {}}
    for rows in batches:
        out["loss"].append(tr.step(rows))
        if tr.t == 1:
            out["grad"] = {k: float(torch.linalg.vector_norm(tr.m[k]))
                           / (1 - adamw["b1"]) for k in tr.names}
    out["change"] = {k: float(torch.linalg.vector_norm(
        tr.master[k] - flat[k].float())) for k in tr.names}
    return out
