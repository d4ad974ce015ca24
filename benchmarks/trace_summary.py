"""Summarize a jax.profiler capture: top device kernels by total time.

Usage:
    BPT_PROFILE=/tmp/bpt_prof python bench.py     # capture
    python benchmarks/trace_summary.py /tmp/bpt_prof [top_n]

Reads the trace-viewer JSON dump (plugins/profile/<ts>/*.trace.json.gz)
that jax.profiler.trace writes, sums event durations per kernel name on
the GPU device tracks (`/device:GPU:*`), and prints a ranked table — the
per-kernel view the bench's telescoping stage attribution can't give
(SURVEY.md §5 "JAX profiler traces + per-kernel timing").
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from collections import defaultdict


def load_trace(root):
    paths = sorted(glob.glob(
        os.path.join(root, "**", "*.trace.json.gz"), recursive=True))
    if not paths:
        raise SystemExit(f"no *.trace.json.gz under {root}")
    with gzip.open(paths[-1], "rt") as f:
        return json.load(f), paths[-1]


def summarize(trace, top_n=30):
    events = trace.get("traceEvents", [])
    # Map pid -> process name so host python threads can be excluded.
    pid_name = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_name[e["pid"]] = e.get("args", {}).get("name", "")

    def is_device(pid):
        n = pid_name.get(pid, "").lower()
        return n.startswith("/device:gpu")

    total = defaultdict(float)
    count = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if not is_device(e.get("pid")):
            continue
        name = e.get("name", "?")
        total[name] += e["dur"]
        count[name] += 1

    rows = sorted(total.items(), key=lambda kv: -kv[1])[:top_n]
    grand = sum(total.values())
    out = []
    for name, us in rows:
        out.append({
            "kernel": name[:100],
            "total_ms": round(us / 1e3, 3),
            "calls": count[name],
            "pct": round(100.0 * us / max(grand, 1e-9), 1),
        })
    return out, grand / 1e3, sorted(set(pid_name.values()))


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/bpt_prof"
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    trace, path = load_trace(root)
    rows, grand_ms, procs = summarize(trace, top_n)
    print(json.dumps({"trace": path, "device_total_ms": round(grand_ms, 1),
                      "processes": procs}, indent=None))
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
