"""Multi-device parallelism: device meshes, sharded encode, the ordered gather.

Port of pyrecode_tpu/parallel/.  The reference scales by forking N host
processes that each encode a contiguous frame slice and write their own
part file (recode_server.py:350-363).  Here, as in the JAX package, that
data parallelism lives on a device mesh:

* frames are sharded over the ``data`` axis (the analogue of the
  reference's ``num_threads`` processes);
* very large frames can additionally shard rows over a ``space`` axis;
* the dark/calibration threshold is copied once to every device;
* variable-length compressed blocks are gathered to one rank in
  acquisition order, reproducing ``merge_parts`` semantics
  (:mod:`.multihost`, over ``torch.distributed``).

JAX's ``Mesh``, ``NamedSharding`` and ``shard_map`` become an explicit grid
of ``torch.device``s (:class:`CodecMesh`), functions that place shards
(:func:`shard_frames`, :func:`shard_batch`, :func:`replicate`; the
counterparts of ``frame_sharding`` and ``replicated_sharding``) and one
launch per shard on its device's current stream.
"""

from .dryrun import dryrun_multidevice
from .mesh import CodecMesh, Sharded, make_codec_mesh, replicate, shard_batch, shard_frames
from .shard_encode import encode_frames_sharded, make_sharded_encode_step

__all__ = [
    "CodecMesh",
    "Sharded",
    "make_codec_mesh",
    "shard_frames",
    "shard_batch",
    "replicate",
    "encode_frames_sharded",
    "make_sharded_encode_step",
    "dryrun_multidevice",
]
