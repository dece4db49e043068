"""Coherence, FID and pair grids (port of eval/)."""
from ratio_guided_multimodal_fm_tpu_torch.eval.coherence import (
    evaluate_coherence,
    evaluate_coherence_dual,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.fid import (
    compute_fid,
    fid_from_features,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.viz import (
    visualize_pairs,
    visualize_pairs_mnist_svhn,
)

__all__ = ["compute_fid", "evaluate_coherence", "evaluate_coherence_dual",
           "fid_from_features", "visualize_pairs",
           "visualize_pairs_mnist_svhn"]
