"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 benchmark_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It needs as many CUDA cards as the cell
asks for, and exits with 2 and no result without them; it never falls back
to the CPU.  The last line of standard output is the result object; the
set-up split and the run's detail go to standard error, whose last lines
are the numbers that decided `correct`, each beside its limit.
"""

import time

T_START = time.time()  # setup_s counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seed < 0 or a.seconds <= 0:
        p.error("--seed must be >= 0 and --seconds > 0")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark_torch import harness, registry

    cell = registry.cell(registry.load_manifest(ROOT), a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {cell.chips} CUDA card(s); {n} visible", file=sys.stderr)
        return 2
    out, _ = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), T_START)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit as exc:
        rc = exc.code if isinstance(exc.code, int) else 1
    except BaseException:  # noqa: BLE001 -- reported, then the process ends with 1
        import traceback

        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # The server's threads were joined; skip interpreter teardown, which
    # can stall on the CUDA context of a process that served (main.py's
    # run_server ends the same way).
    os._exit(rc)
