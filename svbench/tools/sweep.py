#!/usr/bin/env python3
"""Find a serving cell's knee: one set-up, then an open-loop window at
each offered rate, in turns from the lowest.

    python3 svbench/tools/sweep.py --workload raw3_ecapa-serve-poisson \
        --seed 7 --seconds 8 --rates 50 60 70 80 85 90 95 100 110

Prints one JSON line per rate (offered and completed rate, median
latency of the first and last quarter of requests, p50, p95) and last
the knee (``harness/knee.py``). The cell's traffic file then fixes its
rate at a fraction of the knee."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--warm-seconds", type=float, default=0.0,
                   help="load the card this long first (at --warm-rate)")
    p.add_argument("--warm-rate", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from svbench.run import _cache_dirs
    _cache_dirs()
    import numpy as np
    import torch
    from svbench.drivers import serve
    from svbench.harness import cells, core, knee
    if not torch.cuda.is_available():
        core.log("[sweep] no CUDA device")
        return 3
    cell = cells.load_cell(args.workload)
    run = core.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                   trace=False)
    server = serve.Server(run, serve.hparams(run))
    server.warm()
    if args.warm_seconds > 0:
        server.drive(server.window(args.warm_rate, args.warm_seconds,
                                  np.random.default_rng([args.seed, 4])))
        core.log(f"[sweep] card loaded {args.warm_seconds} s at "
                 f"{args.warm_rate}/s: {core.card_state()}")
    points = []
    for i, rate in enumerate(sorted(args.rates)):
        w = server.window(rate, args.seconds,
                          np.random.default_rng([args.seed, 3, i]))
        server.drive(w)
        lat = w.latency_ms()
        came = np.isfinite(lat)
        # answers per second between the first and the last to come back
        span = np.nanmax(w.done) - np.nanmin(w.done)
        first, last = knee.quarter_medians(np.where(came, lat, np.inf))
        pt = knee.SweepPoint(rate, float((came.sum() - 1) / span), first,
                             last)
        points.append(pt)
        core.log(f"[sweep] {rate}/s: {core.card_state()}")
        print(json.dumps({"offered_per_s": rate,
                          "completed_per_s": pt.completed_per_s,
                          "first_quarter_ms": first, "last_quarter_ms": last,
                          "p50_ms": float(np.percentile(lat[came], 50)),
                          "p95_ms": float(np.percentile(lat[came], 95)),
                          "requests": int(len(lat)),
                          "sustained": knee.sustained(pt)}), flush=True)
    server.close()
    print(json.dumps({"knee_per_s": knee.find_knee(points)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
