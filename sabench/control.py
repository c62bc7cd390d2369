"""The control of a build cell at its own size: the reference, with the
guarantee the configuration states broken, put in the program's place,
judged as a run's outputs are. Its readings are the upper ends of the
limits; the benchmark's own runs never run it.

    python3 sabench/control.py --workload <cell> --seeds 1 2 3

It needs no window: the builds it judges are the window's first
`CHECK_BUILDS`, each in the order the window would give it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from sabench import corpus, harness
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell, driver = harness.resolve(args.workload, seed, 0.0, False,
                                       args.device)
        state = {"cell": cell,
                 "corpus": corpus.make_corpus(cell.config, seed, cell.device),
                 "kept": [(k, None) for k in range(driver.CHECK_BUILDS)]}
        checks = driver.control(state)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": {n: v for n, v, _ in checks},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
