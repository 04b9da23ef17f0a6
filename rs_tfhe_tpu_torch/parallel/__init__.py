"""Multi-device parallelism: device meshes, sharded gates, the tensor-parallel
bootstrap (rs_tfhe_tpu/parallel, with the same exports).

One process drives a grid of torch devices (parallel/mesh.py); the reference's
"Railgun" thread-pool abstraction (rs-tfhe parallel/mod.rs:42-76) becomes data
parallelism over the mesh's batch axis and tensor parallelism over its model
axis (parallel/sharded.py).
"""

from .mesh import (  # noqa: F401
    BATCH_AXIS,
    MODEL_AXIS,
    Mesh,
    all_reduce_sum,
    batch_spec,
    make_mesh,
    make_multihost_mesh,
    pad_to_multiple,
    reduce_sum,
    replicate,
    shard_batch,
)
from .sharded import (  # noqa: F401
    ShardedKey,
    data_parallel_gate,
    data_parallel_lut_bootstrap,
    data_parallel_mux,
    shard_key,
    tensor_parallel_bootstrap,
    tensor_parallel_lut_bootstrap,
    tensor_parallel_gate,
)
