"""Atomic, restartable checkpointing of parameter and optimizer trees, the
counterpart of `repro/checkpoint/checkpointer.py`.

Layout:  <dir>/step_<N>/
            manifest.json          # leaf paths, shapes, dtypes, step, extra
            <leaf-path>.npy        # one file per tensor leaf
            COMMITTED              # atomic commit marker (written last)

Fault-tolerance contract (runtime/supervisor.py):
  * a checkpoint without COMMITTED is ignored (a crash mid-save is safe);
  * `latest_step` finds the newest committed step;
  * `restore` puts every leaf on the device and dtype of the matching leaf
    of `like`, laid out by its target sharding where `shardings` gives one
    (a DTensor `like` leaf keeps its own placements otherwise);
    `restore_with_resharding` restores the latest step onto another mesh
    (elastic restart);
  * async mode copies the tree to host memory at once (so the caller may
    go on and replace its tensors) and writes the files on a worker
    thread; `wait()` barriers.
bfloat16 leaves are stored as their uint16 bits (numpy has no bfloat16),
with the dtype in the manifest.

Under torch.distributed every rank calls `save` and `wait` at the same
steps: a DTensor leaf's full value is gathered (`full_tensor()`, a
collective) on every rank's calling thread before the writer takes over,
a barrier follows, and only rank 0 writes.  `wait()` ends with a barrier,
so a step that one rank sees committed is committed for all; every rank
restores by reading the files itself.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..distributed.sharding import flatten_shardings, full_tensor, is_dtensor, place
from ..tree import flatten, unflatten_like

# A published checkpoint dir is exactly step_<digits>; anything else -- a
# step_N.tmp staging dir, which briefly holds its own COMMITTED marker
# before the publishing rename -- is crash debris, never committed.
_STEP_DIR = re.compile(r"^step_(\d+)$")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _place(t: torch.Tensor, sharding, like: torch.Tensor) -> torch.Tensor:
    """t (the full value, on every rank) laid out by `sharding` (a
    distributed.sharding.NamedSharding), or by `like`'s own placements
    where `like` is a DTensor and no sharding is given."""
    if sharding is not None:
        return place(t, sharding)
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)
    return t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending = False     # a save whose end the ranks have not met at
        self.last_save_s: float | None = None   # host copy to publish, seconds
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        self.wait()
        t0 = time.perf_counter()
        # stage to host synchronously: the caller may replace its tensors;
        # a DTensor's full value is gathered here, on the calling thread
        staged = {k: (_to_numpy(full_tensor(v)), str(v.dtype).split(".")[-1])
                  for k, v in flatten(tree)}
        path = os.path.join(self.dir, f"step_{step:08d}")
        if _distributed():
            torch.distributed.barrier()     # every rank has staged the step
            self._pending = True
            if torch.distributed.get_rank() != 0:
                if not self.async_save:
                    self.wait()     # meets rank 0's barrier after its write
                return path

        def write():
            # Everything -- leaves, manifest and the COMMITTED marker -- is
            # staged into a temp dir, each file written to a .part name and
            # os.replace'd into place, and the directory is published by one
            # atomic rename.  A crash leaves either the previous committed
            # step intact or a *.tmp orphan that restore ignores.
            tmp = path + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)

            def atomic_write(name, writer):
                part = os.path.join(tmp, name + ".part")
                with open(part, "wb") as f:
                    writer(f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(part, os.path.join(tmp, name))

            manifest = {"step": step, "extra": extra or {}, "leaves": {}}
            for k, (v, dtype) in staged.items():
                fn = k.replace("/", "__") + ".npy"
                atomic_write(fn, lambda f, v=v: np.save(f, v))
                manifest["leaves"][k] = {"file": fn, "shape": list(v.shape), "dtype": dtype}
            atomic_write("manifest.json", lambda f: f.write(json.dumps(manifest).encode()))
            atomic_write("COMMITTED", lambda f: f.write(b"ok"))
            if os.path.exists(path):
                # same-step overwrite: drop the old marker before the rmtree,
                # so a crash mid-rmtree never leaves a torn committed dir
                marker = os.path.join(path, "COMMITTED")
                if os.path.exists(marker):
                    os.remove(marker)
                shutil.rmtree(path)
            os.replace(tmp, path)
            self._gc()
            self.last_save_s = time.perf_counter() - t0

        if self.async_save:
            def run():
                try:
                    write()
                except BaseException as e:  # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()
            if self._pending:
                self.wait()
        return path

    def wait(self):
        """Block until an async save has finished; raise its error, if any.
        Under torch.distributed every rank then meets at a barrier."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.committed_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def committed_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            m = _STEP_DIR.match(d)
            if m and os.path.exists(os.path.join(self.dir, d, "COMMITTED")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of `like` (shapes must match), each
        leaf on its `like` leaf's device and dtype; `shardings`: an optional
        matching tree of NamedShardings (elastic: each leaf laid out on its
        target mesh)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.exists(os.path.join(path, "COMMITTED")):
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_sh = dict(flatten_shardings(shardings)) if shardings is not None else {}
        out = {}
        for k, ref in flatten(like):
            meta = manifest["leaves"][k]
            arr = np.load(os.path.join(path, meta["file"]))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {tuple(ref.shape)}")
            out[k] = _place(_from_numpy(arr, meta["dtype"], ref), flat_sh.get(k), ref)
        return unflatten_like(like, out)

    def extra(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)["extra"]


def restore_with_resharding(directory: str, like: Any, shardings: Any,
                            step: int | None = None) -> tuple[int, Any]:
    """Elastic restore: latest committed step onto a (possibly different)
    mesh via the target shardings."""
    ck = Checkpointer(directory)
    step = step if step is not None else ck.latest_step()
    if step is None:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    return step, ck.restore(step, like, shardings)
