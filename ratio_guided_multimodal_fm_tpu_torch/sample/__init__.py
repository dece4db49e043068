from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    GuidedSamplerConfig,
    generate_mc_set,
    make_guided_sampler_p,
    mc_feng_guidance,
    safe_exp_log_r,
    sample_bimodal_guided,
)

__all__ = ["GuidedSamplerConfig", "generate_mc_set", "make_guided_sampler_p",
           "mc_feng_guidance", "safe_exp_log_r", "sample_bimodal_guided"]
