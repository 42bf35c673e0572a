"""The port's sharding rules (`repro_torch.distributed.sharding`) held against
the reference's (`repro.distributed.sharding`) in one process, with no
process group: a port `Sharder` resolves specs on a plain {name: size}
mesh, the reference's on a `jax.sharding.AbstractMesh`.

  * every parameter leaf of all ten configs at full width (the reference's
    tree from `jax.eval_shape`, the port's on meta tensors) on (16, 16),
    (2, 16, 16), (2, 4), (4, 2) and (1, 8);
  * every `constrain` kind at shapes that take each fallback branch, the
    reference's spec read from a constrained output compiled on 512 forced
    host devices in a subprocess, and `cache_sharding` /
    `data_sharding` / `replicated`;
  * specs as DTensor placements on small meshes;
  * `NULL` bitwise the call without `sharder=` on the model, train and
    serve entry points;
  * the queue model's `queue_bandwidth` equal to the reference's in float64.

Specs are compared after JAX's normal form: a one-axis tuple is that axis,
trailing Nones dropped.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.core import queue as j_queue
from repro.distributed.sharding import Sharder as JSharder
from repro.models import get_model as j_get_model

from repro_torch.configs import get_config
from repro_torch.core import queue
from repro_torch.distributed.sharding import (NULL, Sharder, flatten_shardings,
                                               to_placements)
from repro_torch.models import encdec, get_model, lm
from repro_torch.optim import adamw
from repro_torch.serve.engine import serve_step
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.tree import flatten, leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(J_ARCHS)
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 8), ("data", "model"))]


def norm(spec, sizes: dict | None = None) -> tuple:
    """A spec (a PartitionSpec or the port's tuple) in one normal form;
    with the mesh's `sizes`, axes of size 1 (a compiled sharding drops
    them) are dropped too."""
    def entry(e):
        axes = tuple(e) if isinstance(e, tuple) else (e,) if e is not None else ()
        if sizes is not None:
            axes = tuple(a for a in axes if sizes[a] > 1)
        return None if not axes else axes[0] if len(axes) == 1 else axes
    out = [entry(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jax_paths(tree) -> dict[str, tuple]:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): v.shape
            for kp, v in flat}


@pytest.mark.parametrize("arch", NAMES)
def test_param_specs_match_reference(arch):
    """Every parameter leaf's spec, full width, on all five meshes."""
    jshapes = _jax_paths(jax.eval_shape(
        lambda: j_get_model(j_get_config(arch)).init(jax.random.PRNGKey(0))))
    meta = get_model(get_config(arch)).init(0, "meta")
    assert {p: tuple(t.shape) for p, t in flatten(meta)} == \
        {p: tuple(s) for p, s in jshapes.items()}
    for shape, axes in MESHES:
        jsh = JSharder(AbstractMesh(shape, axes))
        sh = Sharder(dict(zip(axes, shape)))
        got = {p: norm(s.spec) for p, s in flatten_shardings(sh.params_shardings(meta))}
        want = {p: norm(jsh.param_spec(p, s).spec) for p, s in jshapes.items()}
        assert got == want, (arch, shape)


# -- constrain kinds ------------------------------------------------------

# (mesh index, attn_sharding, kind, shape): each kind, each fallback branch
CONSTRAIN_CASES = [
    (0, "seq", "act_resid", (32, 64, 5120)),
    (0, "seq", "act_resid", (32, 1, 5120)),                # decode: seq = 1
    (1, "seq", "act_resid", (64, 64, 5120)),
    (1, "seq", "act_resid", (2, 64, 5120)),                 # batch fits pod only
    (0, "seq", "act_heads", (32, 64, 40, 128)),             # qwen 40 H: seq
    (0, "heads", "act_heads", (32, 64, 40, 128)),           # heads don't divide
    (0, "seq", "act_heads", (32, 1, 40, 128)),              # neither
    (0, "seq", "act_heads", (32, 1, 32, 128)),              # decode: heads
    (0, "heads", "act_heads", (32, 64, 32, 128)),           # heads (Megatron)
    (0, "seq", "act_kv_heads", (32, 64, 25, 64)),           # hymba 25 H
    (0, "seq", "act_kv_heads", (32, 1, 25, 64)),
    (0, "seq", "act_kv_heads", (32, 1, 8, 128)),
    (0, "seq", "act_heads", (32, 64, 5120)),                # not 4-D: untouched
    (1, "seq", "act_heads", (64, 64, 48, 128)),
    (0, "seq", "act_mlp", (32, 64, 13824)),
    (0, "seq", "act_mlp", (32, 64, 100)),
    (0, "seq", "act_experts", (8, 128, 6144)),              # grok 8 experts
    (0, "seq", "act_experts", (128, 16, 5120)),
    (0, "seq", "act_grouped_experts", (64, 8, 16, 6144)),
    (0, "seq", "act_grouped_experts", (64, 128, 16, 5120)),
    (1, "seq", "act_grouped_experts", (64, 128, 16, 5120)),
    (0, "seq", "act_expert_hidden", (64, 8, 16, 32768)),    # F -> model
    (0, "seq", "act_expert_hidden", (64, 128, 16, 8192)),   # E -> model
    (0, "seq", "act_expert_hidden_flat", (8, 1024, 32768)),
    (0, "seq", "act_expert_hidden_flat", (128, 1024, 8192)),
    (0, "seq", "expert_weights", (8, 6144, 32768)),
    (0, "seq", "expert_weights", (128, 5120, 8192)),
    (0, "seq", "logits", (32, 64, 262144)),
    (0, "seq", "logits", (32, 1, 32001)),                   # hymba vocab
    (1, "seq", "logits", (64, 64, 152064)),
    (2, "seq", "act_heads", (4, 32, 4, 16)),
    (2, "seq", "act_kv_heads", (4, 32, 1, 16)),
    (3, "seq", "act_resid", (4, 16, 64)),
    (4, "seq", "logits", (2, 16, 256)),
    (0, "seq", "unknown_kind", (32, 64, 5120)),             # no rule: untouched
]
CACHE_CASES = [(0, 128, 8), (0, 128, 16), (0, 128, 32), (1, 128, 10), (2, 4, 2), (2, 4, 4)]

REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import _axis_types_kw
from repro.distributed.sharding import Sharder
cases, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
devs = np.array(jax.devices())
built = []
for shape, axes in meshes:
    n = int(np.prod(shape))
    built.append(jax.sharding.Mesh(devs[:n].reshape(shape), tuple(axes),
                                   **_axis_types_kw(len(axes))))
out = []
for m, attn, kind, shape in cases:
    sh = Sharder(built[m], attn_sharding=attn)
    f = jax.jit(lambda x: sh.constrain(x, kind))
    c = f.lower(jax.ShapeDtypeStruct(tuple(shape), jnp.float32)).compile()
    # an unconstrained output has no NamedSharding: no spec, replicated
    out.append([list(e) if isinstance(e, tuple) else e
                for e in getattr(c.output_shardings, "spec", ())])
print("SPECS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_constrain_specs():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
                        json.dumps(CONSTRAIN_CASES), json.dumps(MESHES)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("SPECS"))
    return [tuple(tuple(e) if isinstance(e, list) else e for e in spec)
            for spec in json.loads(line[len("SPECS"):])]


def _port_sharder(m: int, attn: str = "seq") -> Sharder:
    shape, axes = MESHES[m]
    return Sharder(dict(zip(axes, shape)), attn_sharding=attn)


@pytest.mark.parametrize("i", range(len(CONSTRAIN_CASES)))
def test_constrain_specs_match_reference(i, ref_constrain_specs):
    m, attn, kind, shape = CONSTRAIN_CASES[i]
    sh = _port_sharder(m, attn)
    got = sh.constrain_spec(torch.empty(shape, device="meta"), kind)
    assert norm(got or (), sh.shape) == norm(ref_constrain_specs[i], sh.shape), \
        CONSTRAIN_CASES[i]


@pytest.mark.parametrize("m,batch,n_kv", CACHE_CASES)
def test_cache_data_replicated_specs_match_reference(m, batch, n_kv):
    shape, axes = MESHES[m]
    jsh, sh = JSharder(AbstractMesh(shape, axes)), _port_sharder(m)
    assert norm(sh.cache_sharding(batch, n_kv).spec) == \
        norm(jsh.cache_sharding(batch, n_kv).spec)
    for nd in (2, 3):
        assert norm(sh.data_sharding(nd).spec) == norm(jsh.data_sharding(nd).spec)
    assert norm(sh.replicated().spec) == norm(jsh.replicated().spec) == ()


# -- placements -------------------------------------------------------------

def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    r = Replicate()
    dm = {"data": 2, "model": 4}
    assert to_placements(("data", "model"), dm) == (Shard(0), Shard(1))
    assert to_placements(("model", "data"), dm) == (Shard(1), Shard(0))
    assert to_placements((None, None, "model"), dm) == (r, Shard(2))
    assert to_placements((), dm) == (r, r)
    pdm = {"pod": 2, "data": 2, "model": 4}
    # a tuple on one dim shards it on every named mesh dim, in mesh order
    assert to_placements((("pod", "data"), None, "model"), pdm) == (Shard(0), Shard(0), Shard(2))
    assert to_placements((None, ("pod", "data")), pdm) == (Shard(1), Shard(1), r)
    sh = Sharder(dm)
    assert sh.param_spec("blocks/sub0/mlp/wg", (2, 64, 128)).placements == (Shard(1), Shard(2))
    assert sh.param_spec("blocks/sub0/mlp/wd", (2, 128, 64)).placements == (Shard(2), Shard(1))
    assert sh.param_spec("final_norm", (64,)).placements == (r, r)
    # an axis of size 1 splits nothing
    assert to_placements(("data", "model"), {"data": 1, "model": 4}) == (r, Shard(1))
    assert to_placements(("data", "model"), {"data": 1, "model": 1}) == (r, r)


# -- NULL is the call without sharder= -----------------------------------------

def _gemma():
    cfg = get_config("gemma3-1b").reduced()
    return cfg, get_model(cfg).init(0, "cpu")


def _tokens(shape, seed=1, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, shape))


def _bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_null_is_bitwise_no_sharder_lm():
    cfg, params = _gemma()
    tok = _tokens((2, 12))
    _bitwise(lm.forward(params, tok, cfg), lm.forward(params, tok, cfg, sharder=NULL))
    _bitwise(lm.prefill(params, tok, cfg, max_len=16),
             lm.prefill(params, tok, cfg, max_len=16, sharder=NULL))
    c1, c2 = lm.init_cache(cfg, 2, 16, device="cpu"), lm.init_cache(cfg, 2, 16, device="cpu")
    for t in range(3):
        a, _ = lm.decode_step(params, tok[:, t], t, c1, cfg)
        b, _ = lm.decode_step(params, tok[:, t], t, c2, cfg, sharder=NULL)
        _bitwise(a, b)
    _bitwise(c1, c2)


def test_null_is_bitwise_no_sharder_encdec():
    cfg = get_config("whisper-small").reduced()
    params = get_model(cfg).init(0, "cpu")
    frames = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 16, cfg.d_model),
                                                                      dtype=np.float32))
    tok = _tokens((2, 8))
    _bitwise(encdec.forward(params, frames, tok, cfg),
             encdec.forward(params, frames, tok, cfg, sharder=NULL))


def test_null_is_bitwise_no_sharder_train_and_serve():
    cfg, params = _gemma()
    opt = adamw(1e-3)
    batch = {"tokens": _tokens((2, 16))}
    out = []
    for kw in ({}, {"sharder": NULL}):
        step = make_train_step(cfg, opt, TrainConfig(remat=False), **kw)
        state = {"params": params, "opt": opt.init(params)}
        for _ in range(2):
            state, m = step(state, batch)
        out.append((state, m))
    _bitwise(out[0], out[1])
    served = []
    for kw in ({}, {"sharder": NULL}):
        state = {"tokens": _tokens((2,)), "pos": 0,
                 "cache": lm.init_cache(cfg, 2, 8, device="cpu")}
        for _ in range(3):
            state = serve_step(params, state, cfg, **kw)
        served.append(state)
    _bitwise(served[0], served[1])


# -- the queue model --------------------------------------------------------------

def test_queue_bandwidth_matches_reference():
    """The reference's three levels' constants through both functions, a
    payload sweep 1 KB - 64 MB, 1 / 4 / 16 queues, with and without sync:
    equal in float64."""
    payloads = [float(2 ** k) for k in range(10, 27)]
    for jl in (j_queue.VMEM_QUEUE, j_queue.ICI_QUEUE, j_queue.L2_QUEUE_A100):
        level = queue.QueueLevel(jl.name, jl.raw_bw, jl.sync_overhead_s, jl.capacity,
                                 jl.spill_bw)
        for n in (1, 4, 16):
            for sync in (True, False):
                got = [queue.queue_bandwidth(level, p, n, sync) for p in payloads]
                want = [j_queue.queue_bandwidth(jl, p, n, sync) for p in payloads]
                assert got == want
    assert queue.L2_QUEUE_A100 == queue.QueueLevel(*(
        getattr(j_queue.L2_QUEUE_A100, f) for f in
        ("name", "raw_bw", "sync_overhead_s", "capacity", "spill_bw")))
    # the card's levels: L2 spills past 50 MB, NVLink never spills
    assert queue.queue_bandwidth(queue.L2_QUEUE_H100, 2 ** 26, sync=False) < \
        queue.queue_bandwidth(queue.L2_QUEUE_H100, 2 ** 20, sync=False)
    assert queue.queue_bandwidth(queue.NVLINK_QUEUE, 2 ** 26, sync=False) == 900e9
