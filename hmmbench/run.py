"""The port's benchmark: one run of one cell.

    python3 hmmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on stdout (see
hmmbench/README.md) and the numbers its check compared, each beside its
limit, last on stderr.  Needs a CUDA device.
"""

import time

STARTED = time.time()

import sys  # noqa: E402

from hb.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], STARTED))
