"""One run of one cell of the benchmark of obvi_slam_tpu_torch on the GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints the result as the last line of its
standard output (one JSON object) and the numbers compared with the plain
reference, each beside its limit, as the last lines of its standard error.
Exits non-zero, with no result, where the cell's CUDA devices are missing.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import run

    sys.exit(run(sys.argv[1:], t_start=T_START))
