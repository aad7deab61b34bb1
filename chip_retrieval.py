#!/usr/bin/env python3
"""``chip_smoke.py``'s recsys_retrieval phase alone, at one or more
seeds: two-tower retrieval and BERT4Rec at published width on the card,
with every check of the phase.  It prints each model's row as one JSON
line (the readings the phase's float64 bounds are measured from), then
the card, and exits 1 if any check failed in any row (the other rows
still run and print).

    python3 chip_retrieval.py --seeds 0 1 2
"""

from __future__ import annotations

import argparse
import gc
import sys

import chip_smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_retrieval: no CUDA device is available", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    matmul = chip_smoke.tf32_off("recsys_retrieval")

    def check(kname, got, want, what):
        assert chip_smoke.bytes_equal(got, want), \
            f"{kname} != plain version ({what})"

    failed = []
    for seed in args.seeds:
        for serve in (chip_smoke.serve_two_tower, chip_smoke.serve_bert4rec):
            row, timed = serve(dev, seed, check, {})
            chip_smoke.emit({"phase": "recsys_retrieval", **row,
                             "b1": timed, "matmul": matmul, "card": card})
            failed += [(seed, row["model"], f) for f in row["failed"]]
            del row, timed
            gc.collect()
            torch.cuda.empty_cache()
    print(card, flush=True)
    chip_smoke.emit({"ok": not failed, "failed": failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
