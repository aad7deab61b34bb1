# Hand-written CUDA kernels for the extraction system, the recsys
# embedding bag, the GNN message sum and the LM decode attention, one
# subpackage each as <name>/{kernel.py, ops.py, ref.py}: the
# ctypes-bound CUDA wrapper, the dispatcher (a CUDA tensor launches the
# kernel, a CPU tensor takes the plain version), and the plain PyTorch
# version the tests and chip_smoke.py hold the kernel against.  Sources
# live in ../csrc and are built by _build at first use.
#
# gather — exact-byte extraction gathers: per-offset gather_rows (B1),
#          gather_plan_runs (B2: a plan's runs copied straight into its
#          points) and gather_union_slices (a serving window's union
#          read with every plan's slice, one launch); the EmbeddingBag
#          sum gather_rows_bag (B6) of the recsys models
# plan   — device-resident planning: the Algorithm-1 trailing stage
#          (slice → column ranges → run emission → compaction) (B3)
# slice  — batched BFS-layer slicing slice_batch (B5), the batched crop
#          planner batched_plan_2d (one launch, B4's cut inside it) and
#          the shared slicing core slice_minor_extents (B4) on its own
# segment — the GNN message aggregation segment_sum (B7), and
#           segment_max as a plain version only
# paged_attn — the LM engine's decode attention over the paged KV pool,
#           paged_decode_attention (B8)
#
# _casting.checked_cast_i32 is the ONLY place an offset-carrying array
# may be cast to the kernels' int32 index dtype.
from . import gather, paged_attn, plan, segment, slice  # noqa: F401
from ._build import LAUNCHES, reset_launches
from ._casting import checked_cast_i32, ensure_i32_addressable

__all__ = ["gather", "paged_attn", "plan", "segment", "slice", "LAUNCHES",
           "reset_launches", "checked_cast_i32", "ensure_i32_addressable"]
