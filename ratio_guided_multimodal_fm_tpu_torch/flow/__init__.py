from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import (
    SOLVERS,
    TIME_GRIDS,
    cfm_loss,
    euler_sample,
    euler_scan,
    euler_scan_pair,
    interpolate,
    make_time_grid,
    ode_scan,
    ode_scan_pair,
)
from ratio_guided_multimodal_fm_tpu_torch.flow.losses import (
    disc_loss,
    get_ratio_loss,
    masked_ratio_loss,
    rulsif_loss,
)
from ratio_guided_multimodal_fm_tpu_torch.flow.reflow import (
    generate_couplings,
    make_reflow_train_step,
    reflow_loss,
)

__all__ = ["SOLVERS", "TIME_GRIDS", "cfm_loss", "disc_loss", "euler_sample",
           "euler_scan", "euler_scan_pair", "generate_couplings",
           "get_ratio_loss", "interpolate", "make_reflow_train_step",
           "make_time_grid", "masked_ratio_loss", "ode_scan",
           "ode_scan_pair", "reflow_loss", "rulsif_loss"]
