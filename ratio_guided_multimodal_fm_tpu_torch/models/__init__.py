from ratio_guided_multimodal_fm_tpu_torch.models.classifiers import (
    MNISTClassifier,
    MNISTClassifier32,
    SVHNClassifier,
)
from ratio_guided_multimodal_fm_tpu_torch.models.ratio import (
    FlexibleRatioEstimator,
    RatioEstimator,
    RatioEstimatorMNIST,
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
    "FlexibleRatioEstimator", "FlexibleUNet", "FlowMatchingUNet",
    "FlowMatchingUNet64", "FlowMatchingUNetMNIST", "FlowMatchingUNetSVHN",
    "MNISTClassifier", "MNISTClassifier32", "SVHNClassifier",
    "RatioEstimator", "RatioEstimatorMNIST", "RatioEstimatorMNISTSVHN",
    "log_ratio_from_scores",
]
