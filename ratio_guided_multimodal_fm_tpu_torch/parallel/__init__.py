from ratio_guided_multimodal_fm_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_to_multiple,
    shard_batch,
)
from ratio_guided_multimodal_fm_tpu_torch.parallel.sharded_guidance import (
    make_distributed_guided_sampler,
    make_distributed_guided_sampler_p,
)
