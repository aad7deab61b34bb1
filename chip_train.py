#!/usr/bin/env python3
"""``chip_smoke.py``'s training phases alone, at one or more seeds:
recsys_train (DLRM-RM2, DeepFM and two-tower trained at published width
on the card) and train_more (NequIP on ``molecule`` and
``minibatch_lg``, BERT4Rec and GLM-4), with every check of the phases.
It prints each model's row as one JSON line (the readings the phases'
bounds, ``TRAIN_F64``, ``NEQUIP_TRAIN_F64``, ``CE_F64`` and ``LM_F32``,
are measured from), then the card, and exits 1 if any check failed in
any row (the other rows still run and print).  ``--models`` picks some
of ``dlrm-rm2``, ``deepfm``, ``two-tower-retrieval`` (the default three)
and ``nequip``, ``bert4rec``, ``glm4-9b``.

    python3 chip_train.py --seeds 0 1 2
    python3 chip_train.py --models nequip bert4rec glm4-9b --seeds 0 1 2
"""

from __future__ import annotations

import argparse
import gc
import sys
import traceback

import chip_smoke

RECSYS = ("dlrm-rm2", "deepfm", "two-tower-retrieval")
MORE = ("nequip", "bert4rec", "glm4-9b")


def more_rows(dev, seed: int, arch_id: str, check) -> list:
    """[(phase row, timings)] of ``arch_id`` in train_more."""
    if arch_id == "nequip":
        return [chip_smoke.train_nequip_shape(dev, seed, shape, check, {})
                for shape in chip_smoke.MORE_GNN]
    if arch_id == "bert4rec":
        return [(chip_smoke.train_bert4rec(dev, seed, {}), [])]
    return [chip_smoke.train_glm4(dev, seed, check, {})]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--models", nargs="+", default=list(RECSYS),
                    choices=RECSYS + MORE)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_train: no CUDA device is available", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    matmul = chip_smoke.tf32_off("chip_train")
    (chip_smoke.ROOT / "build").mkdir(exist_ok=True)

    def check(kname, got, want, what):
        assert chip_smoke.bytes_equal(got, want), \
            f"{kname} != plain version ({what})"

    recsys = dict(chip_smoke.train_models())
    failed = []
    for seed in args.seeds:
        for arch_id in args.models:
            phase = "recsys_train" if arch_id in RECSYS else "train_more"
            try:
                if arch_id in RECSYS:
                    rows = [chip_smoke.train_recsys_model(
                        dev, seed, arch_id, recsys[arch_id], check, {})]
                else:
                    rows = more_rows(dev, seed, arch_id, check)
            except Exception:       # report it, and go on to the next row
                traceback.print_exc()
                failed.append((seed, arch_id, "raised"))
                continue
            for row, timed in rows:
                chip_smoke.emit({"phase": phase, **row, "kernel": timed,
                                 "matmul": matmul, "card": card})
                failed += [(seed, row["model"], f) for f in row["failed"]]
            del rows
            gc.collect()
            torch.cuda.empty_cache()
    print(card, flush=True)
    chip_smoke.emit({"ok": not failed, "failed": failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
