"""The benchmark's command: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output and the check's
numbers beside their limits as the last lines of standard error; exits
non-zero without a result where the card or the port is missing, or
where JAX or the JAX package was loaded (``benchmark/harness.py``).
"""

import os
import sys
import time

T_START = time.perf_counter()
# the checkout's root, not this folder, heads the import path
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
