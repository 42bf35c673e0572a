"""The paper's five challenge applications as operator graphs (Table 1),
ported from the reference package's `benchmarks/apps.py` builders.

Dims follow the papers cited in SS3 (NeRF: original 256-hidden config, the
paper's footnote 3).  `APPS` builds each at its published size;
`tiny_instances()` gives small, numerically executable instances with feeds
made from numpy under a seed.  (The reference's backward-graph synthesizer
waits for the training slice.)
"""
from __future__ import annotations

import numpy as np
import torch

from .core.graph import Graph, Node, TensorSpec

BATCH = 8192  # default inference batch ("production scenarios", paper SS6.5)


def mlp_chain(g: Graph, x: str, dims: list[int], prefix: str,
              act: str = "relu", last_act: bool = False) -> str:
    cur = x
    for i, d in enumerate(dims):
        cur = g.linear(f"{prefix}_fc{i}", cur, d).name
        if i < len(dims) - 1 or last_act:
            cur = g.elementwise(f"{prefix}_act{i}", [cur], act,
                                flop_per_elem=4).name
    return cur


def dlrm(batch: int = BATCH, emb_rows: int = 1_000_000) -> Graph:
    """DLRM: sparse embedding gathers (excluded ops) + bottom MLP +
    pairwise feature interaction + top MLP."""
    g = Graph("dlrm")
    g.input("dense_x", (batch, 13), "bfloat16")
    g.input("sparse_ids", (batch, 8), "int32")
    bot = mlp_chain(g, "dense_x", [512, 256, 64], "bot", last_act=True)
    emb = g.gather("emb", (emb_rows, 64), "sparse_ids").name    # excluded
    # stack dense + sparse features: (B, 1+8, 64)
    botf = g.add(Node("bot_feat", "reshape", [bot],
                      TensorSpec((batch, 1, 64), "bfloat16"))).name
    cat = g.concat("cat_feats", [botf, emb], axis=1).name
    # feature interaction: per-sample pairwise dots == batched GEMM
    inter = g.matmul("interact", cat, cat, transpose_b=True).name
    flat = g.add(Node("inter_flat", "reshape", [inter],
                      TensorSpec((batch, 9 * 9), "bfloat16"))).name
    cat2 = g.concat("cat2", [bot, flat], axis=-1).name
    top = mlp_chain(g, cat2, [512, 256, 1], "top")
    g.output("out", top)
    return g


def meshgraphnets(batch: int = 32768, steps: int = 5) -> Graph:
    """MGN: encode -> message-passing steps (edge MLP + node MLP with
    gather/scatter between) -> decode."""
    g = Graph("mgn")
    g.input("nodes", (batch, 128), "bfloat16")
    g.input("edges", (batch * 3, 128), "bfloat16")
    g.input("edge_idx", (batch * 3,), "int32")
    n = mlp_chain(g, "nodes", [128, 128], "enc_n", last_act=True)
    e = mlp_chain(g, "edges", [128, 128], "enc_e", last_act=True)
    for s in range(steps):
        gat = g.gather(f"gat{s}", (batch, 128), "edge_idx").name  # excluded
        e2 = g.elementwise(f"msg{s}", [e, gat], "add").name
        e = mlp_chain(g, e2, [128, 128], f"edge{s}", last_act=True)
        agg = g.reduce(f"agg{s}", e, axis=0, keepdims=True).name
        n2 = g.elementwise(f"upd{s}", [n], "add").name
        n = mlp_chain(g, n2, [128, 128], f"node{s}", last_act=True)
    dec = mlp_chain(g, n, [128, 3], "dec")
    g.output("out", dec)
    return g


def nerf(rays: int = 4096, samples: int = 128) -> Graph:
    """NeRF MLP: 8x256-hidden with a skip concat at layer 5 + view head
    (original config, hidden=256 -- paper footnote 3)."""
    g = Graph("nerf")
    b = rays * samples
    g.input("pts", (b, 60), "bfloat16")    # positional encoding (precomp)
    g.input("view", (b, 24), "bfloat16")
    cur = "pts"
    for i in range(5):
        cur = g.linear(f"fc{i}", cur, 256).name
        cur = g.elementwise(f"act{i}", [cur], "relu", flop_per_elem=1).name
    cur = g.concat("skip", [cur, "pts"], axis=-1).name
    for i in range(5, 8):
        cur = g.linear(f"fc{i}", cur, 256).name
        cur = g.elementwise(f"act{i}", [cur], "relu", flop_per_elem=1).name
    sigma = g.linear("sigma", cur, 1).name
    feat = g.linear("feat", cur, 256).name
    vcat = g.concat("vcat", [feat, "view"], axis=-1).name
    rgb0 = g.linear("rgb_fc", vcat, 128).name
    rgb1 = g.elementwise("rgb_act", [rgb0], "relu").name
    rgb = g.linear("rgb", rgb1, 3).name
    g.output("out_rgb", rgb)
    g.output("out_sigma", sigma)
    return g


def graphcast(nodes: int = 40962, hidden: int = 512, steps: int = 4) -> Graph:
    g = Graph("graphcast")
    g.input("x", (nodes, 256), "bfloat16")
    g.input("mesh_idx", (nodes,), "int32")
    cur = mlp_chain(g, "x", [hidden, hidden], "enc", last_act=True)
    for s in range(steps):
        gat = g.gather(f"gat{s}", (nodes, hidden), "mesh_idx").name
        m = g.elementwise(f"mix{s}", [cur, gat], "add").name
        cur = mlp_chain(g, m, [hidden, hidden], f"gnn{s}", last_act=True)
        cur = g.norm(f"ln{s}", cur).name
    out = mlp_chain(g, cur, [hidden, 83], "dec")
    g.output("out", out)
    return g


def llama3_8b(seq: int = 2048, batch: int = 4, n_layers: int = 2,
              decode: bool = False, *, d: int = 4096, ff: int = 14336,
              hq: int = 32, hkv: int = 8, hd: int = 128,
              vocab: int = 128256) -> Graph:
    """Two representative llama3-8B layers + LM head.  decode=True models
    the token-generation phase (seq=1 against a KV cache).  The dimension
    keywords default to the real 8B config; tests shrink them (with hkv=hq,
    since the GQA head-expansion is modeled, not materialized) to execute
    the graph numerically."""
    g = Graph("llama_tok" if decode else "llama_ctx")
    sq = 1 if decode else seq
    g.input("ids", (batch, sq), "int32")
    cur = g.gather("emb", (vocab, d), "ids").name             # excluded

    def reshape(name, src, shape):
        return g.add(Node(name, "reshape", [src],
                          TensorSpec(shape, "bfloat16"))).name

    for i in range(n_layers):
        n1 = g.norm(f"ln1_{i}", cur).name
        q = g.linear(f"wq_{i}", n1, hq * hd).name
        k = g.linear(f"wk_{i}", n1, hkv * hd).name
        v = g.linear(f"wv_{i}", n1, hkv * hd).name
        qr = reshape(f"q4_{i}", q, (batch, hq, sq, hd))
        kr = reshape(f"k4_{i}", k, (batch, hq, seq, hd))
        vr = reshape(f"v4_{i}", v, (batch, hq, seq, hd))
        at = g.attention(f"attn_{i}", qr, kr, vr).name
        ar = reshape(f"a2_{i}", at, (batch * sq, hq * hd))
        o = g.linear(f"wo_{i}", ar, d).name
        o3 = reshape(f"o3_{i}", o, (batch, sq, d))
        r1 = g.elementwise(f"res1_{i}", [cur, o3], "add", flop_per_elem=1).name
        n2 = g.norm(f"ln2_{i}", r1).name
        gate = g.linear(f"wg_{i}", n2, ff).name
        up = g.linear(f"wu_{i}", n2, ff).name
        act = g.elementwise(f"silu_{i}", [gate, up], "mul", flop_per_elem=6).name
        dn = g.linear(f"wd_{i}", act, d).name
        cur = g.elementwise(f"res2_{i}", [r1, dn], "add", flop_per_elem=1).name
    fin = g.norm("final_ln", cur).name
    head = g.linear("lm_head", fin, vocab).name
    g.output("out", head)
    return g


APPS = {
    "dlrm": dlrm,
    "mgn": meshgraphnets,
    "nerf": nerf,
    "graphcast": graphcast,
    "llama_ctx": llama3_8b,
    "llama_tok": lambda: llama3_8b(decode=True),
}


def tiny_instances(device="cuda", seed: int = 0) -> dict:
    """Small instances of the five challenge apps with matching feeds (the
    shapes of the reference package's tiny instances), float32 features and
    int64 ids drawn from numpy under `seed`, as tensors on `device`."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    def ids(high, *shape):
        return torch.from_numpy(rng.integers(0, high, shape)).to(device)

    return {
        "dlrm": (dlrm(batch=16, emb_rows=64), {
            "dense_x": normal(16, 13), "sparse_ids": ids(64, 16, 8)}),
        "mgn": (meshgraphnets(batch=16, steps=1), {
            "nodes": normal(16, 128), "edges": normal(48, 128),
            "edge_idx": ids(16, 48)}),
        "nerf": (nerf(rays=4, samples=4), {
            "pts": normal(16, 60), "view": normal(16, 24)}),
        "graphcast": (graphcast(nodes=16, hidden=16, steps=1), {
            "x": normal(16, 256), "mesh_idx": ids(16, 16)}),
        # hkv == hq: the GQA head expansion is modeled, not materialized
        "llama": (llama3_8b(seq=4, batch=2, n_layers=1, d=16, ff=32,
                            hq=2, hkv=2, hd=8, vocab=32), {
            "ids": ids(32, 2, 4)}),
    }
