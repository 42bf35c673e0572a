"""Model-level spatial pipelining: transformer layer groups as Kitsune
pipeline stages across cards (inter-card dataflow), the counterpart of
`repro/distributed/pipeline.py`.

Wraps core.queue.spatial_pipeline (a ring queue of point-to-point sends +
a GPipe schedule) for a stack of residual blocks: stage s holds layers
[s*L/S, (s+1)*L/S); a microbatch tile finishes stage s and moves over the
ring to stage s+1 while stage s starts the next tile -- operators
co-executing across space.  One process per rank: each runs its own
stage's layers.
"""
from __future__ import annotations

from ..core.queue import make_spatial_pipeline
from ..tree import leaves, tree_map


def stack_stage_params(layer_params, n_stages: int):
    """Regroup per-layer stacked params (leading dim L) into per-stage
    params (leading dim n_stages, each holding L/S layers)."""
    def regroup(x):
        n = x.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return tree_map(regroup, layer_params)


def make_pipelined_stack(mesh, layer_fn, n_layers: int, n_stages: int,
                         axis_name: str = "stage"):
    """layer_fn(p, x) -> x applies ONE layer.  Returns
    fn(stage_params, xs) running the depth-n_layers stack as an
    n_stages-deep spatial pipeline over microbatches xs (n_micro, ...)."""
    per_stage = n_layers // n_stages

    def stage_fn(params, x):
        # this stage's layer slice, applied in order
        for i in range(per_stage):
            x = layer_fn(tree_map(lambda t: t[i], params), x)
        return x

    return make_spatial_pipeline(mesh, stage_fn, n_stages, axis_name)


def run_pipelined(mesh, layer_fn, layer_params, xs, n_stages: int,
                  axis_name: str = "stage"):
    """Convenience wrapper: the pipelined stack over `axis_name` of `mesh`.

    layer_params: tree with leading layer dim L (the same on every rank);
    xs: (n_micro, *tile)."""
    n_layers = leaves(layer_params)[0].shape[0]
    stage_params = stack_stage_params(layer_params, n_stages)
    pipe = make_pipelined_stack(mesh, layer_fn, n_layers, n_stages, axis_name)
    return pipe(stage_params, xs)
