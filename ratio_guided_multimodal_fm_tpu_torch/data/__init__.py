"""numpy copies of the JAX package's data modules that the port reads
(the JAX package's `__init__` imports jax, so the port keeps its own)."""
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    get_classifier_dataloader,
    get_flow_dataloader,
    get_ratio_dataloader,
)
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_svhn import (
    get_mnist32_flow_dataloader,
    get_mnist_svhn_dataloader,
    get_mnist_svhn_ratio_dataloader,
    get_svhn_flow_dataloader,
)
from ratio_guided_multimodal_fm_tpu_torch.data.natural import (
    generate_natural,
    load_natural,
)
from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import (
    Pairing,
    flow_batches,
    paired_batches,
    ratio_batches,
    to_unit_range,
)
from ratio_guided_multimodal_fm_tpu_torch.data.sources import (
    load_mnist,
    load_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.data.transforms import (
    TRANSFORM_NAMES,
    apply_transform,
    inverse_transform,
)

__all__ = ["Pairing", "TRANSFORM_NAMES", "apply_transform", "flow_batches",
           "generate_natural", "get_classifier_dataloader",
           "get_flow_dataloader", "get_mnist32_flow_dataloader",
           "get_mnist_svhn_dataloader", "get_mnist_svhn_ratio_dataloader",
           "get_ratio_dataloader", "get_svhn_flow_dataloader",
           "inverse_transform", "load_mnist", "load_natural", "load_svhn",
           "paired_batches", "ratio_batches", "to_unit_range"]
