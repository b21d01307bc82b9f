from .gmres import gmres, GmresResult  # noqa: F401
from .lgmres import lgmres, LgmresRecycle, init_recycle  # noqa: F401
from .newton import NewtonKrylov, newton_krylov, NewtonResult  # noqa: F401
from .cg import cg, CGResult  # noqa: F401
from .bdf import BDF, BDFResult  # noqa: F401
from .tridiag import trilu, trisolve, tridiag_solve  # noqa: F401
from .adaptive import step_with_backoff, evolve_with_backoff  # noqa: F401
