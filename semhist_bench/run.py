"""Run one cell of the benchmark on the card:

    python3 semhist_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared, each with its limit, are the
last lines of standard error and the result's last key. Exits non-zero,
with no result, without enough CUDA devices, or if the process loaded JAX
or the JAX package.
"""

import os
import sys
import time

T_START = time.perf_counter()    # set-up is timed from here

# one BLAS thread a planner thread: many sessions plan at once
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
# the pruned probe gathers buffers of every size up to 0.9 of the store:
# segments that grow and shrink keep them from fragmenting the card
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

if __name__ == "__main__":
    from semhist_bench.harness import main

    sys.exit(main(T_START))
