from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    state_dict_from_jax,
)

__all__ = ["state_dict_from_jax"]
