"""Readings for setting a cell's limits: the program, its control and its
planted faults on many seeds, in one process.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--variants program,control,fault:state] [--seconds 2] [--mix JSON]

Prints one JSON line a run (variant, seed, every reading of the check, the
end-to-end metrics) and, last, the largest and smallest of each reading by
variant.  The program's largest readings over a dozen seeds are a limit's
lower end, the control's smallest its upper end (PERF.md).  Not part of
the benchmark's runs.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mix", default="{}", help="JSON: traffic parameters to override")
    args = ap.parse_args(argv)
    harness.pin_cores()
    harness.set_cache_dirs()
    import torch

    summary = {}
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            run = harness.make_run(args.workload, seed, args.seconds, False, args.device,
                                   variant=None if variant == "program" else variant,
                                   mix_overrides=json.loads(args.mix))
            t0 = time.perf_counter()
            try:
                out = harness.generator(run.mix).run(run)
            except Exception as e:  # a variant that crashes has failed: report, go on
                print(json.dumps({"variant": variant, "seed": seed, "error": repr(e)}),
                      flush=True)
                continue
            rec = {"variant": variant, "seed": seed, "correct": out.correct,
                   "readings": out.readings, "metrics": out.metrics,
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(rec), flush=True)
            agg = summary.setdefault(variant, {})
            for k, v in out.readings.items():
                lo, hi = agg.get(k, (v, v))
                agg[k] = (min(lo, v), max(hi, v))
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
