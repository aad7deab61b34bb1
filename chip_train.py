#!/usr/bin/env python3
"""``chip_smoke.py``'s recsys_train phase alone, at one or more seeds:
DLRM-RM2, DeepFM and two-tower trained at published width on the card,
with every check of the phase.  It prints each model's row as one JSON
line (the readings the phase's float64 bounds, ``TRAIN_F64``, are
measured from), then the card, and exits 1 if any check failed in any
row (the other rows still run and print).  ``--models`` picks some of
the three (``dlrm-rm2``, ``deepfm``, ``two-tower-retrieval``).

    python3 chip_train.py --seeds 0 1 2
"""

from __future__ import annotations

import argparse
import gc
import sys
import traceback

import chip_smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--models", nargs="+", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_train: no CUDA device is available", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    matmul = chip_smoke.tf32_off("recsys_train")
    (chip_smoke.ROOT / "build").mkdir(exist_ok=True)

    def check(kname, got, want, what):
        assert chip_smoke.bytes_equal(got, want), \
            f"{kname} != plain version ({what})"

    failed = []
    for seed in args.seeds:
        for arch_id, cfg in chip_smoke.train_models():
            if args.models and arch_id not in args.models:
                continue
            try:
                row, timed = chip_smoke.train_recsys_model(
                    dev, seed, arch_id, cfg, check, {})
            except Exception:       # report it, and go on to the next row
                traceback.print_exc()
                failed.append((seed, arch_id, "raised"))
                continue
            chip_smoke.emit({"phase": "recsys_train", **row,
                             "kernel": timed, "matmul": matmul,
                             "card": card})
            failed += [(seed, row["model"], f) for f in row["failed"]]
            del row, timed
            gc.collect()
            torch.cuda.empty_cache()
    print(card, flush=True)
    chip_smoke.emit({"ok": not failed, "failed": failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
