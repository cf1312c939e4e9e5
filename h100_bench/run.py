"""Run one cell of the benchmark once on the card and print its result.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device; with --trace 1 also
breakdown); the numbers the correctness check compared, each beside its
limit, are the last lines of standard error and the line's last key.  With
--trace 0 the metrics are the cell's end-to-end metrics, with --trace 1 its
per-layer metrics from a torch.profiler trace of the window.  It exits
with a code other than 0, and prints no result, without enough CUDA cards
or when the process holds the JAX package or JAX once the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell: workloads/<cell>.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.pin_cores()
    harness.set_cache_dirs()
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
