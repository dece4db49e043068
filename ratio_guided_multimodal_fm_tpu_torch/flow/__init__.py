from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import (
    SOLVERS,
    TIME_GRIDS,
    cfm_loss,
    euler_sample,
    interpolate,
    make_time_grid,
    ode_scan,
)

__all__ = ["SOLVERS", "TIME_GRIDS", "cfm_loss", "euler_sample",
           "interpolate", "make_time_grid", "ode_scan"]
