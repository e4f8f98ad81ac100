"""Readings for a cell's limits, on the card (the benchmark's runs do not
run this):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3,... \
        --control-seeds 1,2,3 --fault-seeds 1,2,3 [--out <file.jsonl>]

One JSON line per reading: the compared numbers of the program (the lower
readings), of the control (the reference at the next precision below the
configuration's) and of each planted fault.  ``bench/workloads/<cell>.json``
keeps the limits set from them; ``PERF.md`` keeps the readings.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness.calibrate import main
    sys.exit(main())
