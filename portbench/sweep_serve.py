"""Find the highest request rate a serving cell's traffic sustains: one
process sets the program up as the cell's driver does, then plays the
cell's open-loop schedule at each rate in turn and prints, per rate, the
completed requests per second, the latency median and 95th percentile, and
the 95th percentile of the last quarter of the requests against the first
(a growing backlog shows as the later tail running away).

    python -m portbench.sweep_serve --workload w48_dark.serve_poisson \
        --seed 1 --seconds 8 --rates 40,60,80,100,120

The cell's rate is then set, by hand, to about four fifths of the knee.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import inputs, program, run as harness, weights
from portbench.drivers import serve_open
from portbench.reference import pipeline as ref_pipe


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from rsgnet_tpu_torch.core.inference import (configure_cudnn,
                                                 make_inference_fn)
    from rsgnet_tpu_torch.serving.batcher import DynamicBatcher
    from rsgnet_tpu_torch.serving.engine import ServingEngine
    manifest, cell, cfg_file, traffic, limits = harness.load_cell(
        args.workload)
    cfg = program.config(cfg_file)
    configure_cudnn(cfg)
    w, h = cfg_file["model"]["image_size"]
    crops = inputs.pinned_uint8(args.seed, 0, (traffic["pool"], h, w, 3),
                                "cuda").numpy()
    sd = weights.make_state_dict(cfg_file["model"], ref_pipe.COCO_SKELETON,
                                 args.seed, "cuda")
    fn = make_inference_fn(cfg, program.model(cfg, sd, "cuda"),
                           normalize_input=True, device="cuda")
    engine = ServingEngine(fn, buckets=tuple(traffic["buckets"]),
                           image_shape=(h, w, 3), image_dtype=np.uint8)
    engine.warmup()
    batcher = DynamicBatcher(engine, max_wait_ms=traffic["max_wait_ms"],
                             in_flight=traffic["in_flight"],
                             max_queued=traffic["max_queued"])
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            ctx = harness.Context(args.workload, cell, cfg_file,
                                  dict(traffic, rate=rate), limits,
                                  args.seed, args.seconds, False)
            sched = serve_open.Schedule(ctx, 4, args.seconds,
                                        traffic["pool"])
            start = time.perf_counter() + 0.05
            futs, done, late = serve_open.play(batcher, sched, crops, start)
            res = serve_open.settle(futs, time.perf_counter() + 60)
            ok = np.array([r is not None for r in res])
            lat = (done - (start + sched.due)) * 1e3
            q = len(sched) // 4
            print(json.dumps({
                "rate": rate, "requests": len(sched),
                "failed": int((~ok).sum()),
                "completed_per_s": float(ok.sum() / (np.nanmax(done)
                                                     - start)),
                "p50_ms": float(np.nanpercentile(lat, 50)),
                "p95_ms": float(np.nanpercentile(lat, 95)),
                "p95_first_quarter_ms": float(np.nanpercentile(lat[:q], 95)),
                "p95_last_quarter_ms": float(np.nanpercentile(lat[-q:], 95)),
                "late_p99_ms": float(np.percentile(late, 99) * 1e3),
                "batches": batcher.stats()["engine"]["bucket_calls"]}),
                flush=True)
    finally:
        batcher.close()
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
