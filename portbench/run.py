"""Run one cell of the port's benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root; the cells are ``BENCHMARK.json``'s. Without
as many CUDA devices as the cell needs it exits non-zero and prints no
result.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
