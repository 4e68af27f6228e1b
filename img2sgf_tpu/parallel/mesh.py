"""Data-parallel scale-out over a device mesh.

The reference is a single-process desktop app with zero parallelism
(SURVEY §2.3); the only parallel axis in this domain is the image batch.
We shard [B, H, W, 3] batches over a 1-D "data" mesh with shard_map: every
per-image result is independent, so no collectives are needed beyond
optional metric reductions — the layout keeps all communication off the
wire entirely, and multi-chip means a proportionally bigger batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DetectionConfig
from ..pipeline.detect import detect_board_batch


def data_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = jax.devices() if devices is None else devices
    import numpy as np

    return Mesh(np.asarray(devices), (axis,))


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Place a [B, ...] batch with B sharded over the mesh axis."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(batch, sharding)


def make_sharded_detector(mesh: Mesh, cfg: DetectionConfig, axis: str = "data",
                          bucketed: bool = False):
    """Jitted batched detector with inputs/outputs sharded over the batch.

    Images: [B, H, W, 3] uint8, thresholds: [B] — B must divide by the mesh
    size. Per-image work is embarrassingly parallel: XLA partitions the
    vmapped program with zero cross-chip collectives.

    bucketed=True returns the serving-path variant over fixed canvases
    with per-image content dims: run(canvases, thresholds, hs, ws) —
    mixed native sizes share the one compiled program, and hs/ws (and
    with them every content-dependent branch: saturation-gated overflow,
    grid validity, bucketed scan bounds) diverge freely across shards.
    """
    spec = P(axis)

    # shard_map (not plain GSPMD partitioning) so each chip runs the
    # batched pipeline on its LOCAL shard: the candidate pool and its
    # skip-dead-chunks scan stay chip-local instead of being sequenced
    # over the global batch, and no cross-chip gathers can appear.
    if bucketed:
        from ..pipeline.detect import _detect_batch_impl

        def local_b(canvases, thresholds, hs, ws):
            return _detect_batch_impl(canvases, cfg, thresholds, hs, ws)

        sharded = jax.shard_map(
            local_b, mesh=mesh, in_specs=(spec, spec, spec, spec),
            out_specs=spec, check_vma=False,
        )
        return jax.jit(sharded)

    def local(images, thresholds):
        return detect_board_batch(images, cfg, thresholds)

    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False,
    )
    return jax.jit(sharded)


def aggregate_metrics(result) -> dict:
    """Cross-batch summary (the only reduction in the system): detection
    rate and stone counts. With a sharded batch these reductions are the
    single psum-like collective the framework ever issues."""
    return {
        "boards_ready": jnp.sum(result.board_ready.astype(jnp.int32)),
        "total_black": jnp.sum(result.num_black),
        "total_white": jnp.sum(result.num_white),
    }
