"""Logical-axis sharding rules (MaxText-style) with divisibility fallbacks,
the counterpart of `repro/distributed/sharding.py` on `torch.distributed`.

Mesh axes: ("pod",)? + ("data", "model").  Policy:
  * weights: one tensor dim -> "model" (TP), the other -> "data" (FSDP
    storage; DTensor all-gathers on demand).
  * activations: batch -> ("pod","data"); the residual stream's *sequence*
    dim -> "model" between layers (Megatron-style sequence parallelism).
  * every rule silently skips a mesh axis the dim doesn't divide -- this is
    the fallback chain that handles qwen's 40 heads / yi's 56 heads / hymba's
    32001 vocab on a 16-wide model axis.

The rules read only the mesh's axis names and sizes, so a `Sharder` is built
on a `DeviceMesh` (with `mesh_dim_names`) or on a plain `{name: size}` dict,
which has no process group behind it (the counterpart of jax's
`AbstractMesh`: resolving specs needs no devices).  A spec is a tuple with
one entry per tensor dim: None, an axis name, or a tuple of axis names
(split major to minor in that order, as a `PartitionSpec` entry is).  On a
`DeviceMesh` a spec becomes DTensor placements (`to_placements`):
`Shard(d)` on each mesh dim whose axis sits on tensor dim d (and is wider
than 1), `Replicate()` on the others.  `constrain` is `redistribute` to the kind's placements, the
counterpart of `with_sharding_constraint`.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any

import torch

from ..tree import flatten, tree_map, unflatten_like


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} in mesh order, of a `DeviceMesh` or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a Sharder's DeviceMesh needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def _axis_size(shape: dict[str, int], axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape[a]
    return n


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of `spec` over the mesh's dims, in mesh order.  An
    axis of size 1 splits nothing: it is `Replicate()`, as a compiled XLA
    sharding drops it (and DTensor then has no shard to keep whole through
    a reshape)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, size in mesh_shape(mesh).items():
        dim = None
        for d, entry in enumerate(spec):
            if entry == name or (isinstance(entry, tuple) and name in entry):
                dim = d
        out.append(Replicate() if dim is None or size == 1 else Shard(dim))
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the counterpart of `jax.sharding.NamedSharding`."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def place(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """x (the same full tensor on every rank) as a DTensor laid out by
    `sharding`: each rank keeps its own slice, nothing crosses the wire.  A
    DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor
    if is_dtensor(x):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x.detach(), sharding.mesh, sharding.placements,
                             src_data_rank=None).requires_grad_(x.requires_grad)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@dataclass
class Sharder:
    """Resolves logical dim specs to specs (and placements) on a mesh."""
    mesh: Any
    # attention activation sharding: "seq" (sequence/context parallel,
    # default) or "heads" (Megatron TP).  With a seq-sharded residual
    # stream, head-sharded attention re-gathers the sequence every layer.
    # Decode (seq=1) falls back to head sharding automatically.
    attn_sharding: str = "seq"

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def batch_axes(self):
        return tuple(a for a in ("pod", "data") if a in self.shape)

    def _fit(self, dim: int, axes):
        """Return axes if dim divides their product, else None."""
        if axes is None:
            return None
        if dim % _axis_size(self.shape, axes) == 0:
            return axes if not (isinstance(axes, tuple) and len(axes) == 1) else axes[0]
        # single-axis fallback within a multi-axis spec
        if isinstance(axes, tuple):
            for a in axes:
                if dim % _axis_size(self.shape, a) == 0:
                    return a
        return None

    def spec(self, dims: list[tuple[int, Any]]) -> tuple:
        """dims: [(size, requested_axes_or_None), ...] -> spec."""
        used: set[str] = set()
        out = []
        for size, want in dims:
            got = self._fit(size, want)
            flat = got if isinstance(got, tuple) else (got,) if got else ()
            if got is not None and not (set(flat) & used):
                out.append(got)
                used.update(flat)
            else:
                out.append(None)
        return tuple(out)

    def named(self, dims) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(dims))

    def _heads_dims(self, x):
        if x.ndim != 4:
            return None
        b = self.batch_axes
        m = self.shape["model"]
        heads_ok = x.shape[2] % m == 0
        seq_ok = x.shape[1] % m == 0
        if seq_ok and (self.attn_sharding == "seq" or not heads_ok):
            return [(x.shape[0], b), (x.shape[1], "model"),
                    (x.shape[2], None), (x.shape[3], None)]
        if heads_ok:
            return [(x.shape[0], b), (x.shape[1], None),
                    (x.shape[2], "model"), (x.shape[3], None)]
        return [(x.shape[0], b), (x.shape[1], None),
                (x.shape[2], None), (x.shape[3], None)]

    # -- activation constraint kinds (called from model code) -------------
    def constrain_spec(self, x, kind: str) -> tuple | None:
        """The spec `constrain` pins x (anything with .shape / .ndim) to, or
        None where the kind leaves x as it is."""
        b = self.batch_axes
        m = "model"
        table = {
            # (B, S, D): sequence-parallel residual stream
            "act_resid": [(x.shape[0], b), (x.shape[1], m), (x.shape[2], None)],
            # (B, S, H, hd): heads -> model; fallback to sequence sharding
            # when the head count doesn't divide (qwen 40H / yi 56H / hymba
            # 25H on a 16-wide axis)
            "act_heads": self._heads_dims(x),
            "act_kv_heads": self._heads_dims(x),
            # (B, S, F) mlp hidden
            "act_mlp": [(x.shape[0], b), (x.shape[1], None), (x.shape[2], m)],
            # (E, C, D) dispatched expert tokens
            "act_experts": [(x.shape[0], m), (x.shape[1], None),
                            (x.shape[2], None)],
            # (G, E, C, D): groups with batch, experts -> model (EP)
            "act_grouped_experts": [(x.shape[0], b), (x.shape[1], m),
                                    (x.shape[2], None), (x.shape[3], None)]
            if x.ndim == 4 else None,
            # (G, E, C, F) expert hidden: experts -> model when divisible,
            # else the wide FFN dim -> model
            "act_expert_hidden": [(x.shape[0], b), (x.shape[1], m),
                                  (x.shape[2], None), (x.shape[3], m)]
            if x.ndim == 4 else None,
            # (E, G*C, F) flattened expert hidden
            "act_expert_hidden_flat": [(x.shape[0], m), (x.shape[1], b),
                                       (x.shape[2], m)]
            if x.ndim == 3 else None,
            # (E, din, dout): pin the compute layout of expert weights
            "expert_weights": [(x.shape[0], m), (x.shape[1], None),
                               (x.shape[2], m)]
            if x.ndim == 3 else None,
            # (B, S, V)
            "logits": [(x.shape[0], b), (x.shape[1], None), (x.shape[2], m)],
        }
        dims = table.get(kind)
        return None if dims is None else self.spec(dims)

    def constrain(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """x redistributed to the kind's placements (differentiable).  x
        must be a DTensor on this sharder's mesh: only `NULL` passes a
        plain tensor through."""
        spec = self.constrain_spec(x, kind)
        if spec is None:
            return x
        if not is_dtensor(x):
            raise TypeError(f"constrain({kind!r}) under a Sharder got a plain "
                            f"{type(x).__name__}; the model's tensors must be "
                            "DTensors on the sharder's mesh")
        return x.redistribute(self.mesh, to_placements(spec, self.mesh))

    # -- parameter shardings ----------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...]) -> NamedSharding:
        """Sharding for a parameter leaf, keyed on its tree path.

        Stacked-layer leading dims are never sharded.  The last two
        meaningful dims get (fsdp="data", tp="model") in an orientation that
        puts "model" on the *contraction-free* dim of each projection.
        """
        b = "data" if "data" in self.shape else None
        m = "model"
        name = path.split("/")[-1]
        nd = len(shape)

        def lead(n):
            return [(shape[i], None) for i in range(n)]

        if name in ("embed", "unembed", "table"):
            # (V, D): vocab -> model, embed -> data(FSDP)
            return self.named(lead(nd - 2) + [(shape[-2], m), (shape[-1], b)])
        if name in ("wq", "wk", "wv", "in_x", "in_z", "wg", "wu", "w1", "up",
                    "skip_g", "w_gates"):
            # (D, out): out -> model, D -> data
            return self.named(lead(nd - 2) + [(shape[-2], b), (shape[-1], m)])
        if name in ("wo", "wd", "w2", "down", "out"):
            # (in, D): in -> model, D -> data
            return self.named(lead(nd - 2) + [(shape[-2], m), (shape[-1], b)])
        if name in ("router", "w_bcdt", "wif"):
            return self.named(lead(nd - 2) + [(shape[-2], b), (shape[-1], None)])
        if name in ("bq", "bk", "bv"):
            return self.named(lead(nd - 1) + [(shape[-1], m)])
        if nd >= 3 and "experts" in path:
            # (E, din, dout): experts -> model (EP) when divisible, else dout
            e_axes = self._fit(shape[-3], m)
            if e_axes is not None:
                return self.named(lead(nd - 3) + [(shape[-3], m),
                                                  (shape[-2], b), (shape[-1], None)])
            return self.named(lead(nd - 3) + [(shape[-3], None),
                                              (shape[-2], b), (shape[-1], m)])
        # norms / scalars / gates: replicate
        return self.named([(s, None) for s in shape])

    def params_shardings(self, params) -> Any:
        """Tree of NamedShardings matching a parameter tree (tensors, meta
        tensors included)."""
        specs = {path: self.param_spec(path, tuple(v.shape))
                 for path, v in flatten(params)}
        return unflatten_like(params, specs)

    def data_sharding(self, ndim: int = 2) -> NamedSharding:
        """(B, S, ...) batch over (pod, data)."""
        return NamedSharding(self.mesh, (self.batch_axes, *([None] * (ndim - 1))))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, ())

    def cache_sharding(self, batch: int, n_kv: int) -> NamedSharding:
        """KV cache (L, B, Hkv, S, D): batch -> (pod,data); heads -> model
        when divisible, else sequence-shard (distributed flash-decode)."""
        if n_kv % self.shape["model"] == 0:
            return NamedSharding(self.mesh, (None, self.batch_axes, "model", None, None))
        return NamedSharding(self.mesh, (None, self.batch_axes, None, "model", None))

    # -- placing tensors ----------------------------------------------------
    def distribute(self, tree, shardings=None) -> Any:
        """Every tensor leaf placed by its sharding (by default
        `params_shardings(tree)`), the counterpart of
        `jax.tree.map(jax.device_put, params, shardings)`."""
        shardings = self.params_shardings(tree) if shardings is None else shardings
        return tree_map(place, tree, shardings)

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        return place(x, self.replicated())


class NullSharder:
    """No-mesh stand-in: every constraint is the identity (single-device)."""

    def constrain(self, x, kind):
        return x

    def params_shardings(self, params):
        return None


NULL = NullSharder()


def is_sharded(sharder) -> bool:
    """True for a Sharder on a DeviceMesh (its tensors are DTensors)."""
    return isinstance(sharder, Sharder) and not isinstance(sharder.mesh, dict)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a collective over its mesh); a plain tensor
    as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def dispatch_context(sharder):
    """The context a model body runs in under `sharder`: on a DeviceMesh,
    DTensor's implicit replication, so that the tensors the body makes
    itself (positions, masks, rope tables, zeros) meet the DTensors as
    replicated ones; under NULL nothing."""
    if not is_sharded(sharder):
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    if DTensor._op_dispatcher._allow_implicit_replication:
        # already on: `implicit_replication()` does not nest (its exit
        # turns the flag off whatever it was)
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def sharded_entry(fn):
    """A model entry point's body under `dispatch_context(sharder)`; the
    entry point takes `sharder=` (default NULL) as a keyword."""
    @functools.wraps(fn)
    def wrapped(*args, sharder=NULL, **kwargs):
        with dispatch_context(sharder):
            return fn(*args, sharder=sharder, **kwargs)
    return wrapped


def split_local(tree) -> tuple[Any, Any]:
    """(each DTensor leaf's local shard, its layout): the plain tensors a
    captured graph reads in place, and what `join_local` needs to wrap them
    again.  A plain leaf is its own local tensor, with layout None."""
    def layout(t):
        if not is_dtensor(t):
            return None
        return (t.device_mesh, tuple(t.placements), tuple(t.shape), tuple(t.stride()))
    return tree_map(lambda t: t.to_local() if is_dtensor(t) else t, tree), \
        {path: layout(t) for path, t in flatten(tree)}


def join_local(local, layouts: dict) -> Any:
    """`split_local`'s inverse: DTensors over the very local tensors (no
    copy, no collective), so that writes through them land in the locals."""
    from torch.distributed.tensor import DTensor

    def wrap(path, t):
        lay = layouts.get(path)
        if not lay:
            return t
        mesh, placements, shape, stride = lay
        return DTensor.from_local(t, mesh, placements, run_check=False, shape=shape,
                                  stride=stride)
    return unflatten_like(local, {p: wrap(p, t) for p, t in flatten(local)})


def replicated_view(sharder, t: torch.Tensor) -> torch.Tensor:
    """t as a replicated DTensor on `sharder`'s mesh over the very same
    tensor (no copy: writes through it land in t); t itself under NULL."""
    if not is_sharded(sharder):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = sharder.mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def cache_placement(sharder, t: torch.Tensor) -> NamedSharding:
    """A dense KV cache leaf (..., B, Hkv, S, D) as an engine keeps it under
    `sharder`: the batch over the batch axes and the KV heads over "model"
    where they divide (as `cache_sharding`).  Where the heads do not divide
    the cache stays whole on "model": its in-place position writes cannot
    go to a sequence-sharded cache, the reference's fallback."""
    nd = t.ndim
    return sharder.named([(s, None) for s in t.shape[:nd - 4]]
                         + [(t.shape[nd - 4], sharder.batch_axes),
                            (t.shape[nd - 3], "model"), (t.shape[nd - 2], None),
                            (t.shape[nd - 1], None)])


def pool_placement(sharder, t: torch.Tensor) -> NamedSharding:
    """A page pool (P, G, A, Hkv, D): the KV heads over "model" where they
    divide; the pages, which every slot's tables index, stay whole."""
    return sharder.named([(s, None) for s in t.shape[:-2]]
                         + [(t.shape[-2], "model"), (t.shape[-1], None)])


def split_dim(t: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """t with dim `dim` reshaped into `sizes`.  A DTensor sharded on that
    dim over a mesh dim that does not divide sizes[0] is first gathered on
    that mesh dim: DTensor cannot split an uneven shard (grok's 2 KV heads
    on a 4-wide model axis)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
              and sizes[0] % t.device_mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def groupwise(fn, n_out: int, *args):
    """fn(*args), each tensor argument and each of the n_out outputs led by
    a group dim, independent groups.  On DTensors it runs on every rank's
    local groups (`local_map`): the groups split over the mesh's batch axes
    wider than 1 where they divide, whole on the others -- the reference's
    vmap over groups sharded with the batch.  For ops DTensor has no rule
    for (the MoE dispatch's scatter, gather and cumsum)."""
    lead = next(a for a in args if torch.is_tensor(a))
    if not is_dtensor(lead):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree
    mesh, g = lead.device_mesh, lead.shape[0]
    pl = tuple(Shard(0) if name in ("pod", "data") and mesh.size(i) > 1
               and g % mesh.size(i) == 0 else Replicate()
               for i, name in enumerate(mesh.mesh_dim_names))
    flat = pytree.tree_leaves(args)
    in_pl = tuple(pl if torch.is_tensor(a) else None for a in flat)
    return local_map(fn, out_placements=(pl,) * n_out, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def flatten_shardings(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, sharding) for every non-container leaf of a shardings tree,
    with the paths `tree.flatten` gives the matching tensor tree."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_shardings(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "mesh"):
        names = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
        out = []
        for k, v in zip(names, tree):
            out += flatten_shardings(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def pad(t: torch.Tensor, widths: tuple[int, ...], value: float = 0.0) -> torch.Tensor:
    """`F.pad(t, widths, value=value)`; a DTensor is padded on every rank's
    local shard (`local_map`), gathered first on a dim the padding widens:
    DTensor's own pad rule differs between torch releases (2.11's returns
    placements of the wrong length on a 2-D mesh)."""
    import torch.nn.functional as F
    if not is_dtensor(t):
        return F.pad(t, widths, value=value)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    widened = {t.ndim - 1 - i for i in range(len(widths) // 2)
               if widths[2 * i] or widths[2 * i + 1]}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in widened else p
               for p in t.placements)
    return local_map(lambda x: F.pad(x, widths, value=value), out_placements=(pl,),
                     in_placements=(pl,), device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t)
