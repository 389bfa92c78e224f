"""One run of one benchmark cell.

    python3 vosbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's pieces by name (BENCHMARK.json, vosbench/workloads/<cell>.json,
its configuration and driver, and with --trace 1 its per-layer metric
readers), sets up, warms up, measures, checks the output against the plain
reference and prints one JSON line. Needs as many CUDA cards as the cell
asks for; without them it exits 2 and prints no result.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vosbench.harness import common  # noqa: E402


def main(argv=None) -> int:
    args = common.parse_args(argv)
    try:
        common.set_environment()
        cell = common.Cell(args.workload)
        device = common.check_device(cell.chips)
    except common.Refused as e:
        print(f'refused: {e}', file=sys.stderr, flush=True)
        return 2
    result, checks = cell.driver().run(cell, args, device, PROCESS_START)
    common.stop_helper_processes()
    found = common.forbidden_modules()
    if found:
        print(f'refused: the run loaded {found}', file=sys.stderr, flush=True)
        return 3
    common.emit(result, checks)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
