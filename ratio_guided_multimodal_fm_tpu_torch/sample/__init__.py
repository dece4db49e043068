from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    GuidedSamplerConfig,
    generate_mc_set,
    make_guided_sampler,
    make_guided_sampler_p,
    mc_feng_guidance,
    safe_exp_log_r,
    sample_bimodal_guided,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.smc import (
    SMCSamplerConfig,
    flow_score,
    make_smc_sampler,
    make_smc_sampler_p,
    sample_bimodal_smc,
    systematic_resample_idx,
)

__all__ = ["GuidedSamplerConfig", "SMCSamplerConfig", "flow_score",
           "generate_mc_set", "make_guided_sampler", "make_guided_sampler_p",
           "make_smc_sampler", "make_smc_sampler_p", "mc_feng_guidance",
           "safe_exp_log_r",
           "sample_bimodal_guided", "sample_bimodal_smc",
           "systematic_resample_idx"]
