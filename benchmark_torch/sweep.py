"""The sweep that fixes an open-loop cell's rate: the cell run at each
offered rate, one line each (offered and answered searches per second,
p50/p99, how late the generator ran, correct).

    python3 benchmark_torch/sweep.py --workload fp10m.open --rates 4000,8000 --seconds 8 --seed 1

It takes the cells of pending/ as well as those of BENCHMARK.json.

The knee is the highest rate whose answered rate keeps up with the offered
one and whose generator did not fall behind; the cell's traffic file then
takes four fifths of it.  Needs a card, as run.py.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--period", type=float, default=0.0, help="the writes' period in s (default: the traffic file's)")
    p.add_argument("--conns", type=int, default=0, help="connections (default: the traffic file's)")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark_torch import harness, registry

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(registry.with_pending(registry.load_manifest(ROOT)), a.workload)
    if a.period:
        cell.traffic["writes"]["period_s"] = a.period
    if a.conns:
        cell.traffic["connections"] = a.conns
    for i, rate in enumerate(float(r) for r in a.rates.split(",")):
        cell.traffic["rate"] = rate
        out, detail = harness.run_cell(cell, a.seed + i, a.seconds, False, time.time())
        print(json.dumps({"rate": rate, "correct": out["correct"], "attempted": out["attempted"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "period_s": (cell.traffic.get("writes") or {}).get("period_s"),
                          "search": detail["search"], "writer": detail["writer"], "counters": detail["counters"],
                          "search_p50_ms": detail["search_p50_ms"], "update_p50_ms": detail.get("update_p50_ms")}),
              flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
