"""The port's distributed layer on torch.distributed, every rank a gloo
process on the CPU, each test mirroring one of `tests/test_distributed.py`'s:

  * `ring_push` rotates (4 ranks);
  * the spatial pipeline, 4 stages x 6 microbatches x d 16, against the
    reference's `make_spatial_pipeline` and the sequential result (2e-5);
  * the pipelined layer stack, 8 layers over 4 stages, against the
    reference's `run_pipelined` (3e-5);
  * `error_feedback_allreduce` over 8 ranks on the reference's g: the
    reduced mean and the residuals against the reference's `shard_map`
    result (2e-4), the int8 codes equal;
  * elastic restore: reduced gemma3-1b saved from a (4, 2) mesh, restored
    with `restore_with_resharding` onto (2, 4), every leaf bitwise, and the
    forward under the new sharder against the reference's (2e-4);
  * the launcher under `torch.distributed.run` on a (2, 2) mesh, and a
    mismatched world size refused;
  * `restore_with_resharding(..., shardings=None)` as the reference's
    checkpoint test asserts it.

The reference's multi-device results come from one subprocess with 8
forced host devices (`REF_SCRIPT`), computed once for the module and read
back as .npz.  The ranks run this file as a script (`_rank_main`): each is
a `python` process joined by a FileStore under the test's tmp_path (no TCP
port), one thread each, under a timeout of its own, so a hung rank fails
its test and is killed.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
SEED = 0


# ---------------------------------------------------------------------------
# the rank harness
# ---------------------------------------------------------------------------

def run_ranks(case: str, world: int, tmp_path, timeout: float = 240, script: str = __file__,
              **kw) -> list:
    """Run CASES[case](rank, world, **kw) of `script` (a test file whose
    main is `_rank_main(CASES)`) in `world` gloo processes; returns each
    rank's result.  A rank that fails or outlives `timeout` fails the test
    (every rank is killed)."""
    out = tmp_path / case
    out.mkdir()
    logs = [open(out / f"log{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), case, str(r),
                               str(world), str(out), json.dumps(kw)],
                              cwd=ROOT, env=ENV, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{case}: a rank was still running after {timeout} s\n" + _tail(out, world))
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()
    if any(p.returncode for p in procs):
        pytest.fail(f"{case}: rank exit codes {[p.returncode for p in procs]}\n"
                    + _tail(out, world))
    return [torch.load(out / f"result{r}.pt", weights_only=False) for r in range(world)]


def _tail(out, world: int) -> str:
    return "\n".join(f"--- rank {r}:\n" + (out / f"log{r}.txt").read_text()[-3000:]
                     for r in range(world))


def _rank_main(cases: dict) -> None:
    import torch.distributed as dist
    case, rank, world, out, kw = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store", rank=rank,
                            world_size=world)
    try:
        res = cases[case](rank, world, **json.loads(kw))
        torch.save(res, f"{out}/result{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference, once per module
# ---------------------------------------------------------------------------

REF_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
from repro.launch.mesh import _axis_types_kw
from repro.core.queue import make_spatial_pipeline
from repro.distributed.pipeline import run_pipelined
from repro.distributed.sharding import Sharder
from repro.optim.compression import error_feedback_allreduce
from repro.optim.quantized_state import quantize_blockwise
from repro.configs import get_config
from repro.models import get_model

out, seed = sys.argv[1], int(sys.argv[2])
rng = np.random.default_rng(seed)
res = {}

def mesh(shape, axes):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), axes,
                             **_axis_types_kw(len(axes)))

# spatial pipeline: 4 stages x 6 microbatches x d 16
w = (rng.standard_normal((4, 16, 16)) * 0.5).astype(np.float32)
xs = rng.standard_normal((6, 8, 16)).astype(np.float32)
pipe = make_spatial_pipeline(mesh((4,), ("stage",)), lambda p, x: jnp.tanh(x @ p["w"]), 4)
res.update(pipe_w=w, pipe_xs=xs, pipe_got=np.asarray(jax.jit(pipe)({"w": w}, xs)))

# pipelined stack: 8 layers over 4 stages, d 32
w = (rng.standard_normal((8, 32, 32)) * 0.3).astype(np.float32)
xs = rng.standard_normal((6, 4, 32)).astype(np.float32)
layer = lambda p, x: x + jnp.tanh(x @ p["w"]) * 0.5
got = jax.jit(lambda p, x: run_pipelined(mesh((4,), ("stage",)), layer, p, x, 4))({"w": w}, xs)
res.update(stack_w=w, stack_xs=xs, stack_got=np.asarray(got))

# compressed all-reduce over 8 shards
g = rng.standard_normal((8, 64)).astype(np.float32)
def f(gl, rl):
    red, new_r = error_feedback_allreduce({"w": gl[0]}, {"w": rl[0]}, "data")
    return red["w"][None], new_r["w"][None]
sm = shard_map(f, mesh=mesh((8,), ("data",)), in_specs=(P("data"), P("data")),
               out_specs=(P("data"), P("data")))
red, resid = jax.jit(sm)(g, jnp.zeros((8, 64)))
codes = np.stack([np.asarray(quantize_blockwise(jnp.asarray(g[i]), 256).codes) for i in range(8)])
res.update(ef_g=g, ef_red=np.asarray(red), ef_resid=np.asarray(resid), ef_codes=codes)

# elastic: gemma3-1b reduced, the forward under a (2, 4) sharder
cfg = get_config("gemma3-1b").reduced()
model = get_model(cfg)
params = model.init(jax.random.PRNGKey(0))
tok = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
s2 = Sharder(mesh((2, 4), ("data", "model")))
logits = jax.jit(lambda p, t: model.forward(p, {"tokens": t}, sharder=s2))(params, tok)
res.update(el_tok=tok, el_logits=np.asarray(logits))
flat = jax.tree_util.tree_flatten_with_path(params)[0]
for kp, v in flat:
    res["el_param/" + "/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(v)
np.savez(out, **res)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(out), str(SEED)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(out))


def _ref_params(ref: dict, prefix: str) -> dict:
    """The reference's parameter tree (saved flat under `prefix`) as tensors."""
    tree: dict = {}
    for k, v in ref.items():
        if k.startswith(prefix + "/"):
            node = tree
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(np.array(v))
    return tree


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def case_ring(rank, world):
    from repro_torch.core.queue import ring_push
    return ring_push(torch.arange(world, dtype=torch.float32)[rank:rank + 1])


def _stage_mesh(world):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((world,), ("stage",), "cpu")


def case_pipe(rank, world, npz):
    from repro_torch.core.queue import make_spatial_pipeline
    d = np.load(npz)
    pipe = make_spatial_pipeline(_stage_mesh(world), lambda p, x: torch.tanh(x @ p["w"]), world)
    return pipe({"w": torch.from_numpy(d["pipe_w"])}, torch.from_numpy(d["pipe_xs"]))


def case_stack(rank, world, npz):
    from repro_torch.distributed.pipeline import run_pipelined
    d = np.load(npz)
    return run_pipelined(_stage_mesh(world), lambda p, x: x + torch.tanh(x @ p["w"]) * 0.5,
                         {"w": torch.from_numpy(d["stack_w"])},
                         torch.from_numpy(d["stack_xs"]), world)


def case_ef(rank, world, npz):
    from repro_torch.optim import compress_int8, error_feedback_allreduce, init_residuals
    g = {"w": torch.from_numpy(np.load(npz)["ef_g"][rank])}
    red, resid = error_feedback_allreduce(g, init_residuals(g))
    return red["w"], resid["w"], compress_int8(g["w"]).codes


def case_elastic(rank, world, npz, ckpt):
    from repro_torch.checkpoint import Checkpointer, restore_with_resharding
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Sharder, flatten_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.tree import flatten
    ref = dict(np.load(npz))
    cfg = get_config("gemma3-1b").reduced()
    params = _ref_params(ref, "el_param")
    s1 = Sharder(make_mesh((4, 2), ("data", "model"), "cpu"))
    Checkpointer(ckpt).save(5, {"params": s1.distribute(params)})
    s2 = Sharder(make_mesh((2, 4), ("data", "model"), "cpu"))
    step, out = restore_with_resharding(ckpt, {"params": params},
                                        {"params": s2.params_shardings(params)})
    leaves = {p: (t.full_tensor(), tuple(t.to_local().shape), tuple(t.placements))
              for p, t in flatten(out["params"])}
    logits = lm.forward(out["params"], torch.from_numpy(ref["el_tok"]).long(), cfg,
                        sharder=s2).full_tensor()
    return {"step": step, "leaves": leaves, "logits": logits,
            "want": {p: (tuple(s.placements)) for p, s in
                     flatten_shardings(s2.params_shardings(params))}}


CASES = {"ring": case_ring, "pipe": case_pipe, "stack": case_stack, "ef": case_ef,
         "elastic": case_elastic}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _npz(ref, tmp_path) -> str:
    path = tmp_path / "ref.npz"
    np.savez(path, **ref)
    return str(path)


def test_ring_push_rotates(tmp_path):
    got = run_ranks("ring", 4, tmp_path)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.roll(np.arange(4.0), 1))


def test_spatial_pipeline_matches_reference_and_sequential(ref, tmp_path):
    got = run_ranks("pipe", 4, tmp_path, npz=_npz(ref, tmp_path))
    want = torch.from_numpy(ref["pipe_xs"])
    for i in range(4):
        want = torch.tanh(want @ torch.from_numpy(ref["pipe_w"][i]))
    for g in got:          # every rank returns the same value
        np.testing.assert_allclose(g.numpy(), ref["pipe_got"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_pipelined_layer_stack_matches_reference(ref, tmp_path):
    got = run_ranks("stack", 4, tmp_path, npz=_npz(ref, tmp_path))
    want = torch.from_numpy(ref["stack_xs"])
    for i in range(8):
        want = want + torch.tanh(want @ torch.from_numpy(ref["stack_w"][i])) * 0.5
    for g in got:
        np.testing.assert_allclose(g.numpy(), ref["stack_got"], rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=3e-5, atol=3e-5)


def test_error_feedback_allreduce_matches_reference(ref, tmp_path):
    got = run_ranks("ef", 8, tmp_path, npz=_npz(ref, tmp_path))
    for r, (red, resid, codes) in enumerate(got):
        np.testing.assert_allclose(red.numpy(), ref["ef_red"][r], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(resid.numpy(), ref["ef_resid"][r], rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(codes.numpy(), ref["ef_codes"][r])
    # every rank holds the same reduced value, close to the true mean
    assert all(torch.equal(got[0][0], g[0]) for g in got)
    assert float((got[0][0] - torch.from_numpy(ref["ef_g"]).mean(0)).abs().max()) < 0.1
    assert float(got[0][1].abs().max()) > 0


def test_elastic_restore_across_mesh_shapes(ref, tmp_path):
    from repro_torch.distributed.sharding import Sharder, to_placements
    ckpt = tmp_path / "ck"
    got = run_ranks("elastic", 8, tmp_path, npz=_npz(ref, tmp_path), ckpt=str(ckpt))
    params = _ref_params(ref, "el_param")
    from repro_torch.tree import flatten
    want = dict(flatten(params))
    sh = Sharder({"data": 2, "model": 4})
    for r, res in enumerate(got):
        assert res["step"] == 5
        assert set(res["leaves"]) == set(want)
        for p, (full, local, placements) in res["leaves"].items():
            assert torch.equal(full, want[p]), p          # bitwise
            assert placements == res["want"][p], p        # on the new mesh
            assert placements == to_placements(sh.param_spec(p, tuple(full.shape)).spec,
                                               sh.mesh)
        np.testing.assert_allclose(res["logits"].numpy(), ref["el_logits"], rtol=2e-4,
                                   atol=2e-4)
    w = got[0]["leaves"]["blocks/sub0/mlp/wg"]
    assert w[1] != tuple(w[0].shape)                       # really sharded


def test_launcher_trains_on_a_mesh_under_torchrun(tmp_path):
    ck = tmp_path / "ck"
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
                        "--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                        "--mesh-data", "2", "--mesh-model", "2", "--steps", "3",
                        "--ckpt", str(ck)],
                       cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("finished:") == 1            # rank 0 alone prints
    from repro_torch.checkpoint import Checkpointer
    assert Checkpointer(str(ck)).latest_step() == 2


def test_launcher_refuses_a_mismatched_world_size(monkeypatch, tmp_path):
    from repro_torch.launch import train
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="world size of 4"):
        train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                    "--mesh-data", "2", "--mesh-model", "2", "--ckpt", str(tmp_path)])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit, match="single-device"):
        train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                    "--mesh-data", "2", "--mesh-model", "2", "--compile-mode", "kitsune",
                    "--ckpt", str(tmp_path)])


def test_restore_with_resharding_without_shardings(tmp_path):
    """As the reference's checkpoint test asserts of its own."""
    from repro_torch.checkpoint import Checkpointer, restore_with_resharding

    def tree(v):
        return {"params": {"w": torch.full((4, 4), v)},
                "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    Checkpointer(str(tmp_path)).save(2, tree(7.0))
    step, out = restore_with_resharding(str(tmp_path), tree(0.0), None)
    assert step == 2 and float(out["params"]["w"][0, 0]) == 7.0
    with pytest.raises(FileNotFoundError):
        restore_with_resharding(str(tmp_path / "empty"), tree(0.0), None)


if __name__ == "__main__":
    _rank_main(CASES)
