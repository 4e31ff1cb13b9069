"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/README.md``.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T0))
