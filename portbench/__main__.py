"""``python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``"""
import os
import sys

# one process with few threads: the eager host loops run on one core, and
# idle BLAS or OpenMP workers spinning beside them make the step time swing
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

from portbench.run import main  # noqa: E402

sys.exit(main())
