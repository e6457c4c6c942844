"""Multi-device scaling: meshes, channel and Doppler sharding, and
multi-process runs (port of :mod:`gnsslib_tpu.parallel`).

Reference parallelism -> the port's mapping (SURVEY.md §2.4):

* one pthread per satellite channel -> the channel axis split into
  contiguous shards, each running the single-device engine (and, on a
  card, its own block programs: one CUDA graph replay per shard and
  block);
* serial Doppler-bin loop -> batched on the device, shardable across
  shards when there are fewer channels than shards;
* one process -> optionally several (``torch.distributed``, gloo), each
  running its shards, the telemetry all-gathered on the host and process
  0 writing the output (:mod:`.distributed`).
"""
from .mesh import Mesh, make_mesh
from .sharded import ShardedAcquirer, ShardedFastTracker, ShardedTracker

__all__ = ["Mesh", "make_mesh", "ShardedAcquirer", "ShardedFastTracker",
           "ShardedTracker"]
