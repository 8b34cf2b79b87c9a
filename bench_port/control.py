"""Readings that the check's limits are set from.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out <file.json>]

For each of ``--seeds`` it takes the program's readings of the cell's
check (as a run's set-up does) and the reference's, and prints the
compared numbers: sound runs of the program, whose largest reading is a
limit's lower end.  For each of ``--control-seeds`` it also puts the
reference in the program's place, once with its products in TF32 (the
nearest precision below the configurations' float32: the control) and
once with half of every batch left out and the mean taken over the rest
(a fault), and prints their numbers: the smallest control reading is a
limit's upper end.  A step that returns its state unchanged reads 1 by
``change_gap`` and needs no run.  No window is measured; the study,
initial parameters and seeds are a run's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import run  # noqa: E402


def readings(workload: str, seeds, control_seeds, root: str = ROOT,
             device=None, log=sys.stderr) -> dict:
    import torch

    from bench_port import data, judge, window
    from bench_port.reference import common

    here = os.path.join(root, "bench_port")
    manifest = run.read_json(os.path.join(root, "BENCHMARK.json"))
    work, conf, _, _ = run.cell_of(manifest, workload)
    doc = run.read_json(os.path.join(root, conf["file"]))
    traffic = run.read_json(os.path.join(here, "traffic",
                                         work["traffic"] + ".json"))
    entry = run.load_module(os.path.join(here, "entries",
                                         traffic["entry"] + ".py"),
                            "bench_entry_" + traffic["entry"])
    dev = torch.device(device or ("cuda:0" if torch.cuda.is_available()
                                  else "cpu"))
    common.f32_products()
    out = {"workload": workload, "program": {}, "control": {},
           "half_batch": {}, "detail": {}}

    def detail(got, ref):
        """Each statistic's worst bucket: (value, bucket)."""
        loss = "obj" if "obj" in ref[0] else "loss"
        best = {}
        for b, p, r in zip(session.buckets, got, ref):
            for k, v in judge.variants(p, r, loss).items():
                if k not in best or v > best[k][0]:
                    best[k] = (v, b["name"])
        return best
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.time()
        sd = window.Seeds(seed)
        study = data.make_study(sd.seed, doc["data"])
        session = entry.open_session(doc, traffic, study, dev, sd)
        ref = session.reference("f32")
        if seed in seeds:
            got = session.readings()
            out["program"][seed] = session.numbers(got, ref)
            out["detail"][f"program {seed}"] = detail(got, ref)
        if seed in control_seeds:
            got = session.reference("tf32")
            out["control"][seed] = session.numbers(got, ref)
            out["detail"][f"control {seed}"] = detail(got, ref)
            got = session.reference("f32", "half_batch")
            out["half_batch"][seed] = session.numbers(got, ref)
            out["detail"][f"half_batch {seed}"] = detail(got, ref)
        got = {k: out[k].get(seed) for k in ("program", "control",
                                             "half_batch")}
        print(f"seed {seed}: {time.time() - t0:.1f} s {json.dumps(got)}",
              file=log, flush=True)
        del session
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    res = readings(args.workload, ints(args.seeds), ints(args.control_seeds))
    text = json.dumps(res, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
