from xpt_mde_tpu_torch.parallel.mesh import Mesh, make_mesh
from xpt_mde_tpu_torch.parallel.multihost import (
    barrier,
    initialize,
    is_main_process,
    local_view,
    make_multihost_mesh,
    process_count,
    process_index,
)
from xpt_mde_tpu_torch.parallel.sharding import (
    local_rows,
    make_parallel_train_step,
    rank_rows,
    replicate_state,
    shard_batch,
)
