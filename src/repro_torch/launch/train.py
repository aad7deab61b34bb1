"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``

Trains any of the ten architectures end to end on one card:
step-addressable data → the train step → the fault-tolerant supervisor
→ checkpoints in the JAX package's format.  As the JAX launcher does,
it always runs the smoke configuration (``--smoke`` is on by default),
with the JAX launcher's data for each family: the LMs read their
batches from a ``TokenCube`` through the extraction service (on the
card one ``gather_union_slices`` launch a step), NequIP trains on
sampled minibatches of a synthetic graph (B7 in its forward and its
backward), and the recsys models, BERT4Rec among them, on fresh draws
of their smoke batch's shapes.  ``--device cpu`` runs the plain PyTorch
versions of the kernels.

    python -m repro_torch.launch.train --arch glm4-9b --steps 20
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from .._device import resolve_device
from ..configs import ARCH_IDS
from ..configs import train as train_cfgs
from ..dataplane.pipeline import device_put
from ..train.fault import FaultConfig, Supervisor


def data_source_for(smoke: dict, device):
    """Step-addressable synthetic data matching the smoke batch of
    ``smoke`` (``configs.train.smoke``), placed on ``device``: the JAX
    launcher's recipe for each family."""
    family = smoke["family"]
    batch_template = smoke["batch"]

    if family == "lm":
        from ..dataplane.tokens import TokenCube

        vocab = smoke["cfg"].vocab
        tc = TokenCube(vocab=vocab, n_docs=32, doc_len=512, device=device)
        b, s = np.asarray(batch_template["tokens"]).shape

        def source(step: int) -> dict:
            # numpy from the CPU's plain path; tensors on the card
            bt = tc.batch(step, b, s)
            return device_put(bt, device) if device.type == "cpu" else bt

        return source

    if family == "gnn":
        from ..dataplane.graph import minibatch, synthetic_graph

        g = synthetic_graph(512, 8, batch_template["node_feat"].shape[1],
                            int(batch_template["labels"].max()) + 1)
        n_pad = batch_template["node_feat"].shape[0]
        e_pad = batch_template["edge_index"].shape[1]

        def source(step: int) -> dict:
            return device_put(minibatch(g, 8, [4, 3], n_pad, e_pad,
                                        step=step), device)

        return source

    # recsys: replay the smoke batch's shapes with fresh synthetic data
    def source(step: int) -> dict:
        rng = np.random.default_rng(step)
        out = {}
        for k, v in batch_template.items():
            v = np.asarray(v)
            if v.dtype.kind == "i":
                hi = max(2, int(v.max()) + 1)
                out[k] = rng.integers(0, hi, v.shape).astype(v.dtype)
            else:
                out[k] = (rng.random(v.shape) < 0.5).astype(v.dtype)
        return device_put(out, device)

    return source


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the supervisor's final state."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    smoke = train_cfgs.smoke(args.arch, device=device, seed=args.seed)
    source = data_source_for(smoke, device)
    sup = Supervisor(
        FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        smoke["step"], source)

    t0 = time.time()

    def on_metrics(step, metrics):
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"({time.time() - t0:.1f}s)", flush=True)

    state = sup.run(smoke["state"], args.steps, on_metrics=on_metrics)
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s")
    return state


if __name__ == "__main__":
    main()
