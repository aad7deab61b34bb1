"""Serving example on the PyTorch port, as ``examples/serve_lm.py``:
continuous batching over a paged KV cache whose page reads are Polytope
extraction plans.  On the card every decode round runs the paged decode
attention kernel once a layer (its CUDA-core kernel: the model is
float32).

  PYTHONPATH=src python examples/torch_serve_lm.py              # the card
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.models.transformer import TransformerConfig, init_params
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

N_REQUESTS = 10
MAX_NEW_TOKENS = 12


def demo_config() -> TransformerConfig:
    return TransformerConfig(
        name="serve-demo", vocab=512, d_model=128, n_layers=4,
        n_heads=8, n_kv_heads=4, d_head=16, d_ff=512, q_chunk=None)


def main(argv: list[str] | None = None) -> dict:
    """Serve the requests; returns what was printed and every request's
    prompt and new tokens."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = demo_config()
    params = init_params(cfg, device=dev, seed=0)
    engine = ServeEngine(params, cfg, EngineConfig(
        max_batch=4, max_seq=128, page_size=16, n_pages=128), device=dev)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(N_REQUESTS):
        engine.submit(Request(
            prompt=rng.integers(0, cfg.vocab,
                                int(rng.integers(8, 48))).astype(np.int32),
            max_new_tokens=MAX_NEW_TOKENS))
    done = engine.run()
    dt = time.time() - t0

    n_tok = sum(len(r.out_tokens) for r in done)
    where = "CPU" if dev.type == "cpu" else dev.type.upper()
    print(f"served {len(done)} requests / {n_tok} new tokens "
          f"in {dt:.1f}s ({n_tok / dt:.1f} tok/s, {where})")
    util = engine.pager.utilization
    print(f"page-pool utilization after drain: "
          f"{util:.0%} (all pages reclaimed)")
    r = done[0]
    print(f"sample: prompt[:8]={r.prompt[:8].tolist()} "
          f"→ out={r.out_tokens}")
    return {"device": str(dev), "requests": len(done), "new_tokens": n_tok,
            "seconds": dt, "utilization": util,
            "outputs": [(r.prompt, list(r.out_tokens)) for r in done]}


if __name__ == "__main__":
    main()
