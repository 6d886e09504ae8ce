"""Data parallelism and ZeRO-3 across processes, on torch.distributed.

Port of aod_meh_hua_tpu/parallel/ (the same exported names): the
reference's MMDataParallel/DDP over NCCL, coalesced all-reduce and
rank-sliced eval with pickle gathers (SURVEY.md sections 2.10, 5.8). The
port runs one device per process: a DeviceMesh of ranks in place of the
JAX mesh of devices.
"""

from .mesh import (make_mesh, make_local_mesh, mesh_is_multiprocess,
                   shard_batch, replicate, data_sharding,
                   make_mesh_2d, fsdp_spec, shard_params_fsdp,
                   gather_to_host)
from .dist import rank_indices, allgather_sum, barrier, collect_objects
from .launch import detect_launch_env, init_distributed
