"""Public entry point for the fused planning pipeline.

The tensors' device decides the path: CUDA tensors launch the CUDA
kernel (``kernel``), CPU tensors take the plain PyTorch version
(``ref``).  ``use_pallas``/``interpret`` keep the JAX package's
signature for parity and are ignored — on the port the device decides.
"""

from __future__ import annotations

from .._build import LAUNCHES  # noqa: F401  (ops.LAUNCHES[name])
from . import kernel, ref

EPS0 = ref.EPS0
EPS1 = ref.EPS1
PLANE_TOL_REL = ref.PLANE_TOL_REL
PERIOD = ref.PERIOD


def plan_runs_2d(verts, valid, base, sv0, rowoff0, sv1, scalars, *,
                 n0: int, n1: int, max_rows: int, cyclic: bool,
                 use_pallas: bool = False, interpret: bool = True):
    if verts.device.type == "cuda":
        impl = kernel.plan_runs_2d
    elif verts.device.type == "cpu":
        impl = ref.plan_runs_2d
    else:
        raise ValueError(f"no planning path for tensors on {verts.device}")
    return impl(verts, valid, base, sv0, rowoff0, sv1, scalars,
                n0=n0, n1=n1, max_rows=max_rows, cyclic=cyclic)
