"""Multi-chip scaling via jax.sharding / shard_map over a device Mesh.

The reference is single-threaded (SURVEY.md §2.3); this package is the
multi-device scaling layer: bodies are sharded across devices, candidate-pair
generation / narrowphase / constraint assembly run device-local over the
shard's rows, and the impulse solver reduces velocity deltas with psum over
the device mesh.
"""

from mgf_tpu.parallel.sharded import make_sharded_step, shard_world
from mgf_tpu.parallel.spatial import (init_spatial_bp_cache,
                                      make_spatial_step,
                                      shard_world_spatial)
