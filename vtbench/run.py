"""The port's benchmark, one run of one cell:

    python3 vtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
last line of standard output is the result's JSON object; everything
else goes to standard error. Without the cards it exits 2 and prints no
result.
"""

import sys
import time

T0 = time.monotonic()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from vtbench import bench

    sys.exit(bench.main(sys.argv[1:], T0))
