"""Pipeline parallelism: microbatched stage execution (port of
``repro.dist.pipeline``).

``pipeline_apply`` threads M microbatches through S stacked stages.  The
schedule is the reference's synchronous pipeline on one device: each
microbatch traverses the stages in order, and the microbatches run in
order, so the result is the stages applied back to back to each
microbatch.  The cross-stage ring (stages placed over ``axis``) waits,
as in the reference, for sweeps that shard over real meshes.
"""

from __future__ import annotations

import torch

from ..optim._tree import leaves, tree_map


def pipeline_apply(stage, params, xs, mesh, *, n_stages: int,
                   axis: str = "pod"):
    """Apply ``n_stages`` stacked stages to M microbatches.

    Args:
      stage:    ``stage(stage_params, x) -> y`` with y shaped like x.
      params:   stage-stacked tree (dicts, lists, tuples of tensors);
                every leaf's leading dim is S.
      xs:       [M, ...] microbatches.
      mesh:     mesh owning ``axis`` (stage placement; unused for S=1).
                Its ``mesh_dim_names`` are checked; an object without
                names passes, as in the reference.
      n_stages: S; must match the params stacking.
      axis:     mesh axis the stages live on.

    Returns [M, ...] outputs, equal to running the stages back-to-back
    on each microbatch.
    """
    leading = {x.shape[0] for x in leaves(params)}
    if leading != {n_stages}:
        raise ValueError(
            f"params leading dims {leading} != n_stages {n_stages}")
    if axis not in (getattr(mesh, "mesh_dim_names", None) or (axis,)):
        raise ValueError(f"mesh has no axis {axis!r}")
    stages = [tree_map(lambda p, s=s: p[s], params) for s in range(n_stages)]

    def through_stages(x):
        for p in stages:
            x = stage(p, x)
        return x

    return torch.stack([through_stages(x) for x in xs.unbind(0)])
