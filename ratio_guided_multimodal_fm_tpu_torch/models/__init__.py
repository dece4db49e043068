from ratio_guided_multimodal_fm_tpu_torch.models.classifiers import (
    Classifier64,
    MNISTClassifier,
    MNISTClassifier32,
    SVHNClassifier,
)
from ratio_guided_multimodal_fm_tpu_torch.models.flow_matching import (
    FlowMatchingModel,
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
    "Classifier64", "FlexibleRatioEstimator", "FlexibleUNet",
    "FlowMatchingModel", "FlowMatchingUNet",
    "FlowMatchingUNet64", "FlowMatchingUNetMNIST", "FlowMatchingUNetSVHN",
    "MNISTClassifier", "MNISTClassifier32", "SVHNClassifier",
    "RatioEstimator", "RatioEstimatorMNIST", "RatioEstimatorMNISTSVHN",
    "log_ratio_from_scores",
]
