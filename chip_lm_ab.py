#!/usr/bin/env python3
"""``chip_smoke.py``'s LM serving phases of one source tree of the port,
on one card, for a comparison of two trees within one call.

    python3 chip_lm_ab.py [--tree DIR] [--seed N] [--tag NAME] [--out OUT]

DIR is the root of a checkout of the port (this one by default; an
unpacked parent's for the comparison).  The script imports DIR's
``chip_smoke.py`` and DIR's ``src``, so the phases' code, their checks
and the kernels (built from DIR's ``csrc`` first, as ``chip_smoke.py``'s
build phase does, outside the timings) are that tree's.  It runs phase
10, ``lm_serve`` (GLM-4 9B at published width behind ``ServeEngine``),
and phase 11, ``lm_moe`` (DeepSeek-V3 and Arctic at published width and
cut depth), at ``--seed``, and prints for each model the readings the
phases take end to end: the rounds' median less their checks
(``round_ms_p50``), ``decode_tokens_per_s``, ``prefill_s`` (the
prefills' sum), ``serve_s``, the first round replayed unchecked
(``replayed_ms_p50``, its ``idle_share``), each prefill's own seconds
(the first, ``prefill_first_s``, and the median of the others,
``prefill_rest_p50_s``, timed around the tree's ``prefill_paged`` with
a synchronize on each side) and the path's kernel launches, then the
card and one JSON line of them.  Each phase's full rows go to
``OUT/lm_ab_<NAME>.jsonl`` (``build/lm_ab`` of this checkout by
default).  A failed check raises, as in ``chip_smoke.py``.  Compare
trees only within one call, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

KEYS = ("round_ms_p50", "decode_tokens_per_s", "prefill_s", "serve_s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parent
                                         / "build" / "lm_ab"))
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]

    import torch

    if not torch.cuda.is_available():
        print("chip_lm_ab: no CUDA device is available", file=sys.stderr)
        return 1

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tf

    assert Path(chip_smoke.__file__).resolve().parent == tree
    _build.library("gather")          # every kernel, before any timing
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    rows = []
    emit = chip_smoke.emit

    def keep(row):
        rows.append(row)
        return emit(row) if row.get("phase") not in ("lm_serve",
                                                     "lm_moe") else None

    prefill_fn, prefills = tf.prefill_paged, {}

    def timed_prefill(params, cfg, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill_fn(params, cfg, *a, **kw)
        torch.cuda.synchronize()
        prefills.setdefault(cfg.name, []).append(time.perf_counter() - t)
        return out

    chip_smoke.emit, tf.prefill_paged = keep, timed_prefill
    launches = {}
    try:
        chip_smoke.lm_serve(dev, args.seed, card, launches)
        chip_smoke.lm_moe(dev, args.seed, card, launches)
    finally:
        chip_smoke.emit, tf.prefill_paged = emit, prefill_fn
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"lm_ab_{args.tag}.jsonl", "w") as f:
        for row in rows:
            f.write(json.dumps(row, default=str) + "\n")
    summary = {}
    for row in rows:
        if row.get("phase") in ("lm_serve", "lm_moe"):
            replayed = row["replayed_first_round"]
            each = prefills.get(row["model"], [None])
            summary[row["model"]] = {
                **{k: row[k] for k in KEYS},
                "replayed_ms_p50": replayed["round_ms_p50"],
                "idle_share": replayed["idle_share"],
                "prefill_first_s": each[0],
                "prefill_rest_p50_s": statistics.median(each[1:])
                if len(each) > 1 else None, "prefills": len(each)}
    print(card, flush=True)
    print(json.dumps({"tree": args.tag, "seed": args.seed,
                      "models": summary, "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
