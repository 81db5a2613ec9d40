"""Parallelism over the processes of a ``torch.distributed`` group.

The counterpart of ``tensorflowonspark_tpu/parallel/``, whose meshes lay
devices out for XLA/GSPMD; here each process is one rank of the mesh and
calls the collectives its part of the work needs.

- ``mesh``        — the six axes (data/fsdp/pipeline/expert/sequence/
                    tensor), a rank's coordinates and a group per set of
                    axes
- ``sharding``    — the logical rules, the train step and the fused K-step
                    loop, on one card or over a mesh
- ``collectives`` — all-reduce, all-gather, reduce-scatter, ring permute
                    and all-to-all over an axis's group, their autograd
                    conjugates, and ``shard_map_fn``
- ``ring_attention`` — sequence parallelism on the flash kernels
- ``expert_parallel`` — MoE layers with their experts cut over ``expert``
- ``pipeline_parallel`` — GPipe and 1F1B stage parallelism over
                    ``pipeline``
- ``runner``      — the independent-parallel barrier runner
- ``groups``      — elastic multi-group training: groups that sync their
                    weights every few steps over the rendezvous plane,
                    survive a group's loss, resize, and reshard their
                    checkpoints across group counts
- ``serving_group`` — the ranks an executor starts to decode a serving
                    bundle over its ``MeshSpec``
"""

from tensorflowonspark_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec, build_mesh, AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_SEQUENCE,
    AXIS_PIPELINE, AXIS_EXPERT,
)
from tensorflowonspark_tpu_torch.parallel.groups import (  # noqa: F401
    GroupEvicted, GroupSet, GroupSyncClient, SyncPlane, TrainGroup,
    attach_sync_plane, merge_payloads, pack_tree, unpack_tree,
)
