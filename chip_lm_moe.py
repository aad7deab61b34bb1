#!/usr/bin/env python3
"""``chip_smoke.py``'s lm_moe phase alone, at one or more seeds:
DeepSeek-V3 (5 layers) and Arctic (2 layers) at published width in
bf16 behind ``ServeEngine``, with every check of the phase.  It prints
each model's row as one JSON line (the readings the phase's bounds were
measured from), then the card, and exits 1 if any check failed in any
row (the other rows still run and print).

    python3 chip_lm_moe.py --seeds 0 1 2
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys

import chip_smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_lm_moe: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch import configs

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    matmul = chip_smoke.tf32_off("lm_moe")
    failed = []
    for seed in args.seeds:
        for arch, n_layers, n_params in chip_smoke.MOE_MODELS:
            cfg = dataclasses.replace(configs.get_config(arch),
                                      n_layers=n_layers)
            row = chip_smoke.serve_moe_model(dev, seed, cfg, n_params, {})
            chip_smoke.emit({"phase": "lm_moe", "seed": seed, **row,
                             "matmul": matmul, "card": card})
            failed += [(seed, arch, f) for f in row["failed"]]
            del row
            gc.collect()
            torch.cuda.empty_cache()
    print(card, flush=True)
    chip_smoke.emit({"ok": not failed, "failed": failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
