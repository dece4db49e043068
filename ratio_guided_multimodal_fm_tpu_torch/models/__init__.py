from ratio_guided_multimodal_fm_tpu_torch.models.ratio import (
    RatioEstimatorMNISTSVHN,
    log_ratio_from_scores,
)
from ratio_guided_multimodal_fm_tpu_torch.models.unet import (
    FlexibleUNet,
    FlowMatchingUNet,
    FlowMatchingUNet64,
    FlowMatchingUNetMNIST,
    FlowMatchingUNetSVHN,
)

__all__ = [
    "FlexibleUNet", "FlowMatchingUNet", "FlowMatchingUNet64",
    "FlowMatchingUNetMNIST", "FlowMatchingUNetSVHN",
    "RatioEstimatorMNISTSVHN", "log_ratio_from_scores",
]
