"""Data parallelism across ranks and devices.

Port of ``imagined_speech_translation_tpu.parallel``'s data axes: training
runs one process a rank under ``torch.distributed`` (``distributed``), the
batch splits over the mesh's ``data`` and ``dcn`` axes (``mesh``) and the step
computes the single-device function of the global micro-batch
(``data_parallel``); serving holds one model replica a device.  The JAX
package's ``context_mesh``, ``get_context_mesh`` and ``ring_attention``
(sequence sharding) and tensor parallelism over ``model`` are ROADMAP item
1.7b and are not exported.
"""

from .distributed import (  # noqa: F401
    host_barrier,
    initialize_distributed,
    is_primary,
    sync_hosts,
)
from .mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate,
    shard_train_state,
    state_sharding_tree,
)
