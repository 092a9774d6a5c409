"""The control's readings at a cell's own size: the reference computed
with one guarantee broken (exact answers: it answers from the first half
of each query's distinct hashes, as a narrower query bucket would) put in
the program's place, and compared as a run compares the program's
answers.  The benchmark's runs never run it.

    python3 benchmark_torch/control.py --workload fp10m.search --seeds 1,2,3

One line per seed: the numbers a run compares (wrong_answers over the
run's sample size; with writes also wrong_readbacks), which a sound run
holds at 0.  Uses the card, when there is one, to make the corpus.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, dev) -> dict:
    import msgpack
    import torch

    from benchmark_torch import corpus as corpus_mod
    from benchmark_torch import harness, reference, traffic

    cfg, tr = cell.config, cell.traffic
    t = time.time()
    c = corpus_mod.make(cfg["corpus"], seed)
    if hasattr(c, "_host"):
        for _ in c.sorted_chunks(dev):
            pass
    q = traffic.make_queries(c, cfg["query"], int(tr["pool"]), seed, device=dev)
    sample = harness._sample(seed, range(int(tr["pool"])), int(tr["check_sample"]))

    def wrong(sources, hashes, limit, min_score, pct):
        want = reference.search(sources, hashes, limit, min_score, pct)
        got = reference.search(sources, hashes, limit, min_score, pct, control=True)
        records = {i: (200, msgpack.packb({"r": [{"i": d, "s": s} for d, s in a]})) for i, a in enumerate(got)}
        return harness.compare(records, range(len(want)), want)

    out = {"cell": cell.name, "seed": seed, "checked": int(sample.numel()),
           "wrong_answers": wrong([c], q.hashes[sample], q.limit, q.min_score, q.pct)}
    w = tr.get("writes")
    if w:
        lo, hi = c.docs_range()
        upd = traffic.Updates(hi + 1, int(w["window"]), int(w["docs"]), int(w["hashes_per_doc"]), seed)
        ids, newest, prev = upd.final(2 * upd.window // upd.docs)
        written = reference.Postings(newest.reshape(-1), ids[:, None].expand_as(newest).reshape(-1))
        out["wrong_readbacks"] = wrong([c, written], torch.cat([newest, prev]), 10, 1, 10)
        out["readbacks"] = 2 * int(ids.numel())
    out["s"] = time.time() - t
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark_torch import registry

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cell = registry.cell(registry.load_manifest(ROOT), a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(readings(cell, seed, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
