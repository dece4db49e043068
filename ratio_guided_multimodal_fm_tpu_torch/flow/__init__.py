from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import (
    SOLVERS,
    TIME_GRIDS,
    cfm_loss,
    euler_sample,
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

__all__ = ["SOLVERS", "TIME_GRIDS", "cfm_loss", "disc_loss", "euler_sample",
           "get_ratio_loss", "interpolate", "make_time_grid",
           "masked_ratio_loss", "ode_scan", "ode_scan_pair",
           "rulsif_loss"]
