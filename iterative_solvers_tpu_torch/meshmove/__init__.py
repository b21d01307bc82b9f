from .pma import PMAParams, solve_pma, loop_pma, pma_dqdt, mesh_steady_state  # noqa: F401
from .monitor import smooth_and_regularise, smooth_pass  # noqa: F401
