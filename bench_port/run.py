"""Run one cell of the port's benchmark and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cell's chips.  The cell
is found by name in ``BENCHMARK.json``; its configuration, traffic and
limits, its entry adapter and its metrics' readers are files under
``bench_port/`` found by the names there.  The run makes its study and
initial parameters from ``--seed``, takes the program's readings for the
check (the warm-up of every bucket shape), measures whole passes over the
cell's buckets for at least ``--seconds`` (traced with ``--trace 1``),
then runs the plain reference and prints each compared number beside its
limit on standard error and, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), then ``window`` and
``check``.  It exits with 2, printing no result, without the cell's CUDA
devices, and with 3 if JAX was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def cache_env(root: str) -> None:
    """Every build and kernel cache of the run at a fixed path inside the
    checkout (the program builds its libraries under its own package)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str):
    """(workload, configuration entry, end-to-end metrics, per-layer
    metrics) of the cell ``name``."""
    work = [w for w in manifest["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in manifest["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    return w, conf, e2e, layer


def read_metrics(here: str, specs, ctx) -> dict:
    """Each metric's value from its reader ``metrics/<name>.py``; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in specs:
        reader = load_module(os.path.join(here, "metrics", m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: str = ROOT, device=None,
         require_cuda: bool = True, out=None, err=None) -> int:
    """One run; ``device`` and ``require_cuda`` let the CPU tests drive
    the rest of a run without a card."""
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)
    here = os.path.join(root, "bench_port")
    cache_env(root)
    manifest = read_json(os.path.join(root, "BENCHMARK.json"))
    work, conf, e2e, layer = cell_of(manifest, args.workload)
    doc = read_json(os.path.join(root, conf["file"]))
    traffic = read_json(os.path.join(here, "traffic",
                                     work["traffic"] + ".json"))
    limits = read_json(os.path.join(here, "limits",
                                    work["name"] + ".json"))["numbers"]

    import torch

    from bench_port import data, judge, nojax, trace, window
    from bench_port.reference import common

    chips = int(work["chips"])
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        print(f"bench_port: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=err)
        return 2
    dev = torch.device(device or "cuda:0")
    on_card = dev.type == "cuda"
    common.f32_products()
    # one process with one host thread: the program's small host ops
    # between calls wait on thread start-up and on neighbours otherwise
    torch.set_num_threads(1)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    seeds = window.Seeds(args.seed)
    study = data.make_study(seeds.seed, doc["data"])
    entry = load_module(os.path.join(here, "entries",
                                     traffic["entry"] + ".py"),
                        "bench_entry_" + traffic["entry"])
    session = entry.open_session(doc, traffic, study, dev, seeds)
    prog = session.readings()
    sync()
    setup_s = time.perf_counter() - T0

    tracer = trace.Tracer() if args.trace else None
    if tracer is None:
        res = window.run_window(session, seeds, args.seconds, sync=sync)
    else:
        with tracer:
            with tracer.span(trace.WINDOW):
                res = window.run_window(session, seeds, args.seconds,
                                        sync=sync, span=tracer.span)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    result = {"correct": False, "attempted": len(res["calls"]),
              "failed": res["failed"]}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": chips, "memory_peak_bytes": int(peak)}
    if tracer is None:
        ctx = {"calls": res["calls"], "window_s": res["window_s"],
               "inst_steps": res["inst_steps"], "setup_s": setup_s}
        metrics = read_metrics(here, e2e, ctx)
        breakdown = None
    else:
        ctx = trace.context(*tracer.events())
        ctx["calls"] = res["calls"]
        metrics = read_metrics(here, layer, ctx)
        breakdown = trace.breakdown(ctx)
        device_info["busy_s"] = ctx["busy_s"]
        device_info["window_s"] = ctx["window_s"]
        del tracer
    session.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = session.reference("f32")
    numbers = session.numbers(prog, ref)
    ok, shown = judge.verdict(numbers, limits)
    bad = nojax.forbidden_loaded()
    if bad:
        print(f"bench_port: JAX was loaded in this process: {bad}", file=err)
        return 3
    result["correct"] = bool(ok and res["failed"] == 0)
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"passes": res["passes"], "calls": len(res["calls"]),
                        "inst_steps": res["inst_steps"],
                        "window_s": res["window_s"],
                        "inst_steps_per_s": (res["inst_steps"]
                                             / res["window_s"]),
                        "setup_s": setup_s}
    result["check"] = shown
    for line in judge.report_lines(shown):
        print(line, file=err)
    err.flush()
    print(json.dumps(result, allow_nan=False), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
