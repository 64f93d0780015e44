"""Data, tensor and context parallelism across ranks and devices.

Port of ``imagined_speech_translation_tpu.parallel``: training runs one
process a rank under ``torch.distributed`` (``distributed``) over a mesh of
``(dcn, data, model)`` axes (``mesh``).  The batch splits over the ``data``
and ``dcn`` axes and the step computes the single-device function of the
global micro-batch (``data_parallel``); the ``model`` axis shards the JAX
``_TP_RULES`` tensors, Megatron-style (``tensor_parallel``); a ``seq`` axis
runs ring attention over the region encoder's tokens (``context``).
Serving holds one model replica a device.
"""

from .context import (  # noqa: F401
    context_mesh,
    get_context_mesh,
    ring_attention,
)
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
