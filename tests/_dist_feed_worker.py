"""Worker for tests/test_parallel.py::test_multihost_feed_two_processes.

Runs as one of two real OS processes under jax.distributed (CPU backend,
4 virtual devices per process = one 8-device global mesh). Executes the
full multi-host feed path — local_file_slice -> native decode of ONLY
this host's slice -> make_array_from_process_local_data -> sharded
detection — and prints per-ADDRESSABLE-shard checksums that the parent
test reassembles and compares against the single-process run.

Deliberately NO cross-process collectives: the detection pipeline is
embarrassingly data-parallel (zero collectives by design), and reading
only addressable shards keeps the test off the gloo backend, whose
30-second context-initialization handshake is flaky when one worker's
compile outpaces the other's under host load (observed: DEADLINE_EXCEEDED
in GetKeyValue for the gloo context key).

Usage: python tests/_dist_feed_worker.py <pid> <port> <listfile> <h> <w>
"""

import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
listfile, h, w = sys.argv[3], int(sys.argv[4]), int(sys.argv[5])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from img2sgf_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid,
                           initialization_timeout=300)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from img2sgf_tpu.config import DetectionConfig  # noqa: E402
from img2sgf_tpu.parallel import (  # noqa: E402
    data_mesh, feed_and_detect, local_file_slice, make_sharded_detector,
)

assert jax.process_count() == 2, "distributed init degenerated"
assert len(jax.devices()) == 8

files = [line.strip() for line in open(listfile) if line.strip()]

# executes the pad/slice math for real: 7 files over 2 hosts -> per=4,
# host 1's slice ends with the padded repeat of the last file
padded = files + [files[-1]] * ((-len(files)) % 2)
mine = local_file_slice(padded, pid, 2)
assert len(mine) == len(padded) // 2
print(f"worker {pid}: slice={[os.path.basename(f) for f in mine]}",
      flush=True)

cfg = DetectionConfig(
    maxblur=1,  # 4 unique planes: keeps the two CPU compiles ~2x cheaper
    max_center_candidates=32,
    overflow_center_candidates=0,
    max_circles_per_variant=16,
    max_lines=128,
    hysteresis_iters=4,
)
mesh = data_mesh(jax.devices())
run = make_sharded_detector(mesh, cfg)
res = feed_and_detect(mesh, run, files, h, w)
jax.block_until_ready(res.full_board)

# per-ADDRESSABLE-shard, index-weighted checksums (shard ORDER matters:
# a slice/pad mix-up cannot cancel out); no collectives are issued
for fb_shard, it_shard, br_shard in zip(
        res.full_board.addressable_shards,
        res.intensities.addressable_shards,
        res.board_ready.addressable_shards):
    gidx = fb_shard.index[0].start or 0
    nloc = fb_shard.data.shape[0]
    wgt = jnp.arange(gidx, gidx + nloc, dtype=jnp.float32) + 1.0
    ck = float(jnp.sum(
        jnp.asarray(fb_shard.data).astype(jnp.float32)
        * wgt[:, None, None]))
    isum = float(jnp.sum(
        jnp.asarray(it_shard.data).astype(jnp.float32)
        * wgt[:, None, None]))
    nr = int(jnp.sum(jnp.asarray(br_shard.data)))
    print(f"worker {pid}: SHARD idx={gidx} n={nloc} ready={nr} "
          f"checksum={ck:.1f} intsum={isum:.3f}", flush=True)
print(f"worker {pid}: OK", flush=True)
