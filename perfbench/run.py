"""The benchmark of smore_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA cards the cell
asks for (BENCHMARK.json). The last line of standard output is the result
(JSON); the compared numbers of the output check are the last lines of
standard error. Without a card, or in a checkout that holds only the
benchmark, the run fails and prints no result.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.harness.main import configure_caches, main  # noqa: E402

if __name__ == "__main__":
    configure_caches(ROOT)
    sys.exit(main(sys.argv[1:], T_START))
