"""Multi-GPU training and extraction (port of the JAX package's
``parallel`` package): one process per GPU on ``torch.distributed``."""

from speakerverification_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from speakerverification_tpu_torch.parallel.dp import (  # noqa: F401
    make_dp_train_step,
    replicate_state,
    shard_batch,
)
from speakerverification_tpu_torch.parallel.tp import (  # noqa: F401
    make_dp_tp_train_step,
    shard_state_tp,
    tp_state_specs,
)
from speakerverification_tpu_torch.parallel.multihost import (  # noqa: F401
    global_batch,
    is_multiprocess,
    maybe_initialize_distributed,
    process_allgather,
    replicate_global,
)
