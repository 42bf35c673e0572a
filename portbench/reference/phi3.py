"""Phi-3-medium's decoder in plain PyTorch, float32, for the
`phi3-medium-14b` configuration as the program runs it (the published
sizes, with the program's `departures` that the configuration file lists
in place of the published values): token embeddings (times the embedding
scale among the departures), then per layer a pre-norm grouped-query
attention with rotary positions (the half-split form, theta from the
configuration) and a pre-norm SwiGLU MLP, each added to the residual,
then the final norm and the untied output head.

It imports nothing of the program.  The weights are the harness's own, in
the stacked layout it hands the program (one tensor per kind of weight,
layers first); each layer's weights are read in float32 one layer at a
time, and every sequence passes a layer before the next layer is read, so
the float32 copy of the model never exists at once.
"""
from __future__ import annotations

import math

import torch

from . import lowp


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D): rotate the two halves of each head by position."""
    s, _, d = x.shape
    half = d // 2
    freq = theta ** (-torch.arange(half, device=x.device, dtype=torch.float32) / half)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal attention; q (S, Hq, D), k and v (S, Hkv, D) -> (S, Hq * D)."""
    s, hq, d = q.shape
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(s, hq * d)


def as_run(cfg: dict) -> dict:
    """The configuration as the program runs it: the published keys, with
    the program's departures from them in their place."""
    return {**cfg, **cfg.get("departures", {})}


def _layer(cfg: dict, w: dict, x: torch.Tensor, mm) -> torch.Tensor:
    hq, hkv, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    s = x.shape[0]
    h = _rms(x, w["ln1"], eps)
    q = _rope(mm(h, w["wq"]).reshape(s, hq, d), theta)
    k = _rope(mm(h, w["wk"]).reshape(s, hkv, d), theta)
    v = mm(h, w["wv"]).reshape(s, hkv, d)
    x = x + mm(_attention(q, k, v), w["wo"])
    h = _rms(x, w["ln2"], eps)
    return x + mm(torch.nn.functional.silu(mm(h, w["wg"])) * mm(h, w["wu"]), w["wd"])


def layer_weights(params: dict, i: int) -> dict:
    """Layer i's weights, in float32, from the stacked layout."""
    b = params["blocks"]["sub0"]
    out = {"ln1": b["ln1"][i], "ln2": b["ln2"][i]}
    out.update(b["attn"])
    out.update(b["mlp"])
    return {k: (v if k in ("ln1", "ln2") else v[i]).float() for k, v in out.items()}


def logits_at(cfg: dict, params: dict, seqs: list[list[int]], starts: list[int],
              precision: str = "float32") -> list[torch.Tensor]:
    """For each sequence, the logits (float32) at positions start - 1 ..
    len - 2: those that predict its tokens from `start` on.  `precision`
    "float8_e4m3fn" runs every linear layer and the output head in e4m3
    (the control)."""
    cfg = as_run(cfg)
    mm = lowp.fp8_matmul if precision == "float8_e4m3fn" else (lambda a, b: a @ b)
    dev = params["embed"].device
    scale = math.sqrt(cfg["hidden_size"]) \
        if cfg.get("embedding_scale") == "sqrt(hidden_size)" else 1.0
    xs = [params["embed"][torch.tensor(s, device=dev)].float() * scale for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        w = layer_weights(params, i)
        xs = [_layer(cfg, w, x, mm) for x in xs]
        del w
    g = params["final_norm"].float()
    head = params["unembed"].float()
    out = []
    for x, start in zip(xs, starts):
        h = _rms(x[start - 1:-1], g, cfg["rms_norm_eps"])
        out.append(mm(h, head.t()))
    return out


def gaps(ref: list[torch.Tensor], seqs: list[list[int]], starts: list[int],
         picks: list[torch.Tensor] | None = None) -> torch.Tensor:
    """Each token's gap below the reference's best logit at its position:
    the served tokens (seqs[start:]), or with `picks` the tokens another
    computation put first; all sequences' gaps in one tensor."""
    out = []
    for i, (lg, seq, start) in enumerate(zip(ref, seqs, starts)):
        tok = picks[i] if picks is not None else torch.tensor(seq[start:], device=lg.device)
        out.append(lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0])
    return torch.cat(out)


def widest_gap(ref: list[torch.Tensor], seqs: list[list[int]], starts: list[int],
               picks: list[torch.Tensor] | None = None) -> float:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position (`gaps`)."""
    return float(gaps(ref, seqs, starts, picks).max())
