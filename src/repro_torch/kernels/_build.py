"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/kernels/<hash>/`` at the repository root.  The
hash covers every source and header plus the compiler flags, so an edit
rebuilds and an unchanged tree reuses the libraries.  All sources are
compiled at first use, one ``nvcc`` process each, started together.

``--fmad=false`` is part of the exactness contract, not a tuning flag:
the planning kernel must round ``a + t*(b - a)`` and ``lo - m*period``
exactly as the float64 host planner does, and nvcc would otherwise fuse
them into FMAs that change the last bit.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("batched_plan", "gather", "paged_attn", "paged_attn_tc",
           "plan_runs_2d", "segment_sum", "slice_batch", "slice_extents")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points and their argument types: every pointer and the stream
# are c_void_p (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    "batched_plan": {
        "polytope_batched_plan_2d": [_I, _I, _P, _P, _I, _P, _L, _L, _P, _L,
                                     _L, _L, _I, _I, _P, _I, _P, _P, _P, _P],
    },
    "gather": {
        "polytope_gather_rows": [_I, _P, _L, _P, _L, _I, _I, _I, _I, _P,
                                 _P],
        "polytope_gather_plan_runs": [_I, _P, _P, _P, _P, _L, _L, _I, _P,
                                      _P],
        "polytope_gather_union_slices": [_I, _P, _P, _P, _L, _I, _P, _P],
        "polytope_gather_rows_bag": [_I, _P, _L, _P, _L, _L, _I, _P, _P],
        "polytope_gather_rows_bag_tiled": [_I, _P, _L, _P, _L, _L, _I, _P,
                                           _P],
    },
    "paged_attn": {
        "polytope_paged_decode_attention": [_I, _P, _P, _P, _P, _P, _I, _I,
                                            _I, _I, _I, _I, _I, _I, _P, _P,
                                            _P],
    },
    "paged_attn_tc": {
        "polytope_paged_decode_attention_tc": [_I, _P, _P, _P, _P, _P, _I,
                                               _I, _I, _I, _I, _I, _I, _I,
                                               _P, _P, _P],
    },
    "plan_runs_2d": {
        "polytope_plan_runs_2d": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _P, _P],
    },
    "segment_sum": {
        "polytope_segment_sum": [_I, _P, _L, _P, _P, _L, _I, _P, _P],
    },
    "slice_batch": {
        "polytope_slice_batch": [_I, _P, _P, _P, _L, _I, _I, _I, _P, _P,
                                 _P],
    },
    "slice_extents": {
        "polytope_slice_minor_extents": [_I, _I, _P, _P, _P, _P, _P, _L, _I,
                                         _I, _P, _P, _P, _P],
    },
}

# Launches of each kernel since the last reset_launches(): a wrapper adds
# one where it launches its kernel, and nowhere else.  The extraction
# read counts B1 ("gather_rows"), B2 ("gather_plan_runs") and the
# serving window's union read with its slices ("gather_union_slices")
# apart.  B8 has two kernels: "paged_decode_attention" counts the
# tensor-core one, "paged_decode_attention_simt" the CUDA-core one.  So
# has B6: "gather_rows_bag" counts its kernel for wide rows,
# "gather_rows_bag_tiled" its kernel for narrow rows.  "segment_plan"
# counts B7's segment plans built on the card (kernels/segment/ops.py),
# each the CSR that the B7 launches of one forward then share.
# "batched_plan_2d" counts the batched crop planner (B4's cut inside),
# "slice_minor_extents" B4 launched on its own.
LAUNCHES: dict[str, int] = {"batched_plan_2d": 0, "gather_rows": 0,
                            "gather_plan_runs": 0, "gather_union_slices": 0,
                            "gather_rows_bag": 0, "gather_rows_bag_tiled": 0,
                            "plan_runs_2d": 0, "slice_minor_extents": 0,
                            "slice_batch": 0, "segment_plan": 0,
                            "segment_sum": 0, "paged_decode_attention": 0,
                            "paged_decode_attention_simt": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Wall time of the last build (0.0 when every library came from the cache).
last_build_s = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (CUDA toolkit under "
                           "/usr/local/cuda)")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> None:
    global last_build_s
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not (out_dir / f"lib{s}.so").exists()]
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{out.decode()}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    last_build_s = time.perf_counter() - t0 if todo else 0.0
    for name in SOURCES:
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.polytope_error_string.argtypes = [ctypes.c_int]
        lib.polytope_error_string.restype = ctypes.c_char_p
        _libs[name] = lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source on first use)."""
    with _lock:
        if not _libs:
            _build_all()
        return _libs[name]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        msg = lib.polytope_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} at launch: {msg}")


def cuda_device(t: torch.Tensor, what: str) -> torch.device:
    """The CUDA device ``t`` lies on; raises for anything else (a kernel
    never quietly runs a CPU tensor)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                         f"got {where}")
    return t.device


def expect(t: torch.Tensor, what: str, *, device: torch.device,
           dtype: "torch.dtype | tuple[torch.dtype, ...]",
           shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` with one of
    ``dtype`` and the given shape (``None`` entries match any size)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
