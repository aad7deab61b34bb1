# Hand-written CUDA kernels for the extraction main path, one subpackage
# each as <name>/{kernel.py, ops.py, ref.py}: the ctypes-bound CUDA
# wrapper, the dispatcher (a CUDA tensor launches the kernel, a CPU
# tensor takes the plain version), and the plain PyTorch version the
# tests and chip_smoke.py hold the kernel against.  Sources live in
# ../csrc and are built by _build at first use.
#
# gather — exact-byte extraction gathers: per-offset gather_rows (B1)
#          and the run-length burst gather_runs (B2)
# plan   — device-resident planning: the Algorithm-1 trailing stage
#          (slice → column ranges → run emission → compaction) (B3)
# slice  — the shared slicing core slice_minor_extents (B4)
#
# _casting.checked_cast_i32 is the ONLY place an offset-carrying array
# may be cast to the kernels' int32 index dtype.
from . import gather, plan, slice  # noqa: F401
from ._build import LAUNCHES, reset_launches
from ._casting import checked_cast_i32, ensure_i32_addressable

__all__ = ["gather", "plan", "slice", "LAUNCHES", "reset_launches",
           "checked_cast_i32", "ensure_i32_addressable"]
