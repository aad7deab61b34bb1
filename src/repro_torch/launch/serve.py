"""Serving launcher for the port, in two modes: ``lm`` (the default, as
in the JAX package's launcher) and ``extract``.

``lm`` — the continuous-batching LM engine over the paged KV cache, on
the architecture's smoke configuration with random weights (seed 0);
each decode round's GQA attention runs through kernel B8, MLA's
(DeepSeek-V3) in plain PyTorch over its latent pages; BERT4Rec's
without the causal mask, with learned positions:

    python -m repro_torch.launch.serve --arch deepseek-v3-671b
    python -m repro_torch.launch.serve --arch bert4rec --max-new-tokens 4

``extract`` — the polytope extraction service under a Zipfian request
mix (the production pattern: a few hot crops dominate traffic), serving
plans from the sharded LRU plan cache (DESIGN.md §4, §7) and reading
values from a payload that lives on the card:

    python -m repro_torch.launch.serve --mode extract --grid-n 1280

``--device cpu`` runs either mode with the plain PyTorch versions of
the kernels.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass
class ExtractRun:
    """What one ``run_extract`` served: the bench row, the service, the
    cube and card-resident payload it read, the request population, and
    every client's ``(population rank, ServiceResult)`` pairs."""

    row: dict[str, Any]
    service: Any
    weather: Any
    payload: Any
    population: list
    served: list


@dataclass
class LMRun:
    """What one ``run_lm`` served: the finished requests, the engine
    (its pager and page pool), the tokens produced and the wall time."""

    done: list
    engine: Any
    tokens: int
    seconds: float


def run_lm(args) -> LMRun:
    """Serve ``--requests`` random prompts of 4-23 tokens, each for
    ``--max-new-tokens`` tokens, through ``ServeEngine`` on the smoke
    configuration of ``--arch``.  With learned positions (BERT4Rec) a
    prompt is at most as long as the position table leaves room for; a
    request that still does not fit exits with the engine's message."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerConfig, init_params
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    try:
        cfg = get_config(args.arch, smoke=True)
    except KeyError as err:
        raise SystemExit(str(err)) from None
    if not isinstance(cfg, TransformerConfig):
        raise SystemExit(f"{args.arch} is not an LM")
    params = init_params(cfg, device=args.device, seed=0)
    engine = ServeEngine(params, cfg, EngineConfig(
        max_batch=4, max_seq=128, page_size=16, n_pages=256),
        device=args.device)

    longest = 23
    if cfg.learned_pos:
        longest = max(4, min(longest, cfg.max_seq - args.max_new_tokens))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        try:
            engine.submit(Request(
                prompt=rng.integers(0, cfg.vocab, rng.integers(4, longest + 1)
                                    ).astype(np.int32),
                max_new_tokens=args.max_new_tokens))
        except ValueError as err:
            raise SystemExit(str(err)) from None
    done = engine.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s) on {engine.device}")
    print(f"KV pool utilization at end: {engine.pager.utilization:.0%}")
    return LMRun(done=done, engine=engine, tokens=n_tok, seconds=dt)


def run_extract(args) -> ExtractRun:
    """Closed-loop Zipfian load against the sharded service: ``--threads``
    clients submit through one :class:`AdmissionQueue` (so duplicate hot
    crops coalesce across callers inside each arrival window), and the
    per-request latency distribution lands in ``--bench-out``.

    The octahedral cube is one ``DevicePlanner`` does not take, so plans
    come from the host planner (the reference semantics); every window's
    union read, with each plan's slice of it, is one
    ``gather_union_slices`` launch on the card."""
    from repro_torch.carry import payload_to_tensor
    from repro_torch.dataplane.weather import WeatherCube, request_population
    from repro_torch.serve.sharded import (AdmissionQueue,
                                           ShardedExtractionService)

    if args.zipf_s <= 1.0:
        raise SystemExit("--zipf-s must be > 1 (Zipf exponent)")
    wc = WeatherCube(n=args.grid_n, n_times=4, n_levels=4)
    data = payload_to_tensor(wc.field_data(), args.device)
    svc = ShardedExtractionService(
        wc.cube, shards=args.shards,
        capacity_per_shard=args.cache_capacity, device=args.device)
    population = request_population(wc)

    rng = np.random.default_rng(args.seed)
    ranks = np.minimum(rng.zipf(args.zipf_s, size=args.requests) - 1,
                       len(population) - 1)
    per_thread = np.array_split(ranks, max(args.threads, 1))
    latencies = [np.empty(0)] * len(per_thread)
    served: list = [[] for _ in per_thread]
    barrier = threading.Barrier(len(per_thread) + 1)

    def client(tid: int, my_ranks: np.ndarray, queue: AdmissionQueue):
        lat = np.empty(len(my_ranks))
        barrier.wait()
        for i, r in enumerate(my_ranks):
            t0 = time.perf_counter()
            res = queue.extract(population[int(r)], timeout=60)
            lat[i] = time.perf_counter() - t0
            served[tid].append((int(r), res))
        latencies[tid] = lat

    with AdmissionQueue(svc, flat_data=data,
                        window_s=args.window_ms / 1e3) as queue:
        threads = [threading.Thread(target=client, args=(i, tr, queue))
                   for i, tr in enumerate(per_thread)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        adm = queue.snapshot()

    lat_ms = np.concatenate(latencies) * 1e3
    if not len(lat_ms):  # --requests 0: an empty but schema-valid row
        lat_ms = np.zeros(1)
    s = svc.stats
    row = {
        "scenario": f"zipf{args.zipf_s}-grid{args.grid_n}",
        "requests": int(len(ranks)),
        "threads": int(len(per_thread)),
        "shards": int(args.shards),
        "window_ms": float(args.window_ms),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "req_per_s": float(len(ranks) / dt) if dt else 0.0,
        "hit_rate": float(s.hit_rate),
        "coalescing_factor": float(adm.coalescing_factor),
        "device": str(data.device),
    }
    with open(args.bench_out, "w") as fh:
        json.dump({"bench": "serve", "rows": [row]}, fh, indent=1)

    print(f"served {len(ranks)} requests from {len(per_thread)} threads "
          f"in {dt:.2f}s ({row['req_per_s']:.0f} req/s) on {data.device}")
    print(f"latency p50 {row['p50_ms']:.2f}ms / p99 {row['p99_ms']:.2f}ms")
    print(f"plan cache: {s.hits} hits / {s.misses} misses "
          f"(+{s.batch_dedup} batch-dedup) = {s.hit_rate:.0%} hit rate, "
          f"{s.evictions} evictions across {args.shards} shards")
    print(f"admission: {adm.windows} windows (max {adm.window_max}), "
          f"{adm.coalesced} coalesced, "
          f"factor {adm.coalescing_factor:.2f}x")
    print(f"planning {s.plan_time_s:.2f}s, shared gather "
          f"{s.gather_time_s:.2f}s, read sharing {s.sharing_factor:.2f}x")
    print(f"wrote {args.bench_out}")
    return ExtractRun(row=row, service=svc, weather=wc, payload=data,
                      population=population,
                      served=[pair for part in served for pair in part])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "extract"], default="lm")
    ap.add_argument("--requests", type=int, default=8)
    # lm mode
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    # extract mode
    ap.add_argument("--grid-n", type=int, default=32)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--cache-capacity", type=int, default=256)
    ap.add_argument("--zipf-s", type=float, default=1.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bench-out", default="BENCH_torch_serve.json")
    ap.add_argument("--device", default="cuda",
                    help="where the payload or the weights live and the "
                         "kernels run ('cpu' runs the plain PyTorch "
                         "versions)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.mode == "extract":
        run_extract(args)
    else:
        run_lm(args)


if __name__ == "__main__":
    main()
