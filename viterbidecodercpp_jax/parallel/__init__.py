"""Mesh-parallel decode: frame data-parallelism and time-block sharding.

The reference's only parallelism is a host thread pool running independent
(code, decode, simd) tasks (utility/thread_pool.h, SURVEY.md section 2.4).
The mesh equivalents:

  * frame_dp - shard independent frames across a 'data' mesh axis
    (embarrassingly parallel; psum for aggregate BER/error reductions).
  * block_sp - split one long stream's *time* axis across a 'time' mesh
    axis with overlap warm-up regions and ppermute halo exchange: the
    sequence-parallel capability the reference lacks (SURVEY.md section 5
    "long-context / sequence parallelism").
  * launch - multi-process / multi-host scaffolding: per-process
    jax.distributed setup, across-host-outer / within-host-inner hybrid
    meshes, global array assembly, and the spawned-process dryrun used by
    CI.
"""

from . import frame_dp, block_sp, launch  # noqa: F401
