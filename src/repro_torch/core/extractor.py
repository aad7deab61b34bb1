"""Extraction executors + the baselines the paper compares against.

* :class:`PolytopeExtractor` — the paper's technique: plan with the
  slicer, then read only the planned bytes.  On the card the read is
  one launch of a CUDA kernel of ``repro_torch.kernels.gather``: the
  per-offset ``gather_rows``, or ``gather_plan_runs``, which copies the
  plan's coalesced runs straight into its points.
* :class:`BoundingBoxExtractor` — the "state of practice" baseline: the
  tensor-product box of the per-axis extents.
* :class:`TraditionalExtractor` — whole-field reads (paper Table 1
  column 1): everything under the selected leading-axis indices.

All three report bytes-read, so Table 1's reduction factors are computed
like-for-like.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from .datacube import Datacube, OctahedralGridDatacube, TensorDatacube
from .index_tree import ExtractionPlan, coalesce_runs
from .shapes import Request
from .slicer import Slicer, SliceStats


@dataclass
class ExtractResult:
    values: np.ndarray | None
    plan: ExtractionPlan
    stats: SliceStats | None = None

    @property
    def nbytes(self) -> int:
        return self.plan.nbytes


class PolytopeExtractor:
    """Plan on host (float64 geometry) or on device (the fused
    ``device_planner`` pipeline), gather on host or device."""

    def __init__(self, datacube: Datacube, use_kernel: bool = False,
                 verify: bool = False, device_planner: bool = False,
                 burst_gather: bool = False, device=None):
        # device=None means the card (raises when there is none);
        # device="cpu" plans and reads with the plain PyTorch versions.
        self.datacube = datacube
        self.device = resolve_device(device)
        self.slicer = Slicer(datacube, verify=verify,
                             device_planner=device_planner,
                             device=self.device)
        # use_kernel keeps the JAX package's flag for parity; on the port
        # the payload's device decides (a CUDA tensor always launches a
        # kernel).
        self.use_kernel = use_kernel
        # burst_gather=True reads coalesced plan runs straight into the
        # points (kernels.gather.gather_plan_runs) instead of one load
        # per offset — the bandwidth-bound warm path.
        self.burst_gather = burst_gather

    def check_payload(self, flat_data: Any) -> None:
        """A tensor payload must lie on this extractor's device: a CPU
        tensor handed to a CUDA extractor would quietly take the plain
        path.  Numpy payloads keep the host path."""
        if (isinstance(flat_data, torch.Tensor)
                and flat_data.device.type != self.device.type):
            raise ValueError(f"payload on {flat_data.device}, extractor on "
                             f"{self.device}")

    def plan(self, request: Request) -> tuple[ExtractionPlan, SliceStats]:
        return self.slicer.extract_plan(request)

    def extract(self, request: Request,
                flat_data: Any | None = None) -> ExtractResult:
        plan, stats = self.plan(request)
        values = None
        if flat_data is not None:
            self.check_payload(flat_data)
            values = gather(flat_data, plan, use_kernel=self.use_kernel,
                            burst=self.burst_gather)
        return ExtractResult(values=values, plan=plan, stats=stats)


def gather(flat_data: Any, plan: ExtractionPlan,
           use_kernel: bool = False, burst: bool = False) -> Any:
    """Read exactly the planned elements.

    A numpy payload is indexed on the host.  A tensor payload is read by
    one gather kernel on its own device — ``burst=True`` copies the
    plan's coalesced runs (``gather_plan_runs``: the runs, their lengths
    and output offsets in one upload, no per-point index), otherwise
    one load per element (``gather_rows``); results are identical, runs
    tile the offsets exactly.  ``use_kernel`` is kept for parity with
    the JAX package: on the port the tensor's device decides.
    """
    if isinstance(flat_data, np.ndarray):
        return flat_data[plan.offsets]
    if burst:
        from ..kernels.gather import ops as gops

        return gops.gather_plan_runs(flat_data, plan.run_starts,
                                     plan.run_lengths)
    return gather_offsets(flat_data, plan.offsets)


def gather_offsets(flat_data: Any, offsets: np.ndarray) -> Any:
    """``flat_data[offsets]`` for a 1-D payload: numpy indexing on the
    host, the ``gather_rows`` kernel for a tensor."""
    if isinstance(flat_data, np.ndarray):
        return flat_data[offsets]
    if not isinstance(flat_data, torch.Tensor):
        raise TypeError(f"payload must be a numpy array or a tensor, got "
                        f"{type(flat_data).__name__}")
    from ..kernels.gather import ops as gops

    return gops.gather_rows(flat_data[:, None], offsets)[:, 0]


class BoundingBoxExtractor:
    """Tensor-product box of the request's per-axis extents."""

    def __init__(self, datacube: Datacube):
        self.datacube = datacube

    def plan(self, request: Request) -> ExtractionPlan:
        polys = request.polytopes()
        sels = request.selects()
        # per-axis extents across all polytopes (the box around the union)
        ext: dict[str, list[float]] = {}
        for p in polys:
            for ax in p.axes:
                lo, hi = p.extents(ax)
                cur = ext.setdefault(ax, [lo, hi])
                cur[0] = min(cur[0], lo)
                cur[1] = max(cur[1], hi)

        # Walk the cube like the slicer would, but with box shapes only.
        from .shapes import Box, Select, Span

        shapes: list = [Span(ax, lo, hi) for ax, (lo, hi) in ext.items()]
        shapes += [Select(s.axis, s.values) for s in sels]
        box_request = Request(shapes)
        plan, _ = Slicer(self.datacube).extract_plan(box_request)
        return plan

    def extract(self, request: Request,
                flat_data: Any | None = None) -> ExtractResult:
        plan = self.plan(request)
        values = None
        if flat_data is not None:
            values = gather(flat_data, plan)
        return ExtractResult(values=values, plan=plan)


class TraditionalExtractor:
    """Whole-field baseline: read the complete subcube under the selected
    leading axes (what ECMWF MARS / DICOM effectively do today)."""

    def __init__(self, datacube: Datacube,
                 field_axes: tuple[str, ...] = ("lat", "lon")):
        self.datacube = datacube
        self.field_axes = field_axes

    def nbytes(self, request: Request) -> int:
        """Bytes = (#selected leading-index combinations) × field size."""
        dc = self.datacube
        polys = request.polytopes()
        sels = {s.axis: s for s in request.selects()}
        n_lead = 1
        if isinstance(dc, OctahedralGridDatacube):
            lead_names = dc._lead_names
            field_elems = dc.points_per_field
        elif hasattr(dc, "axis_names"):
            # regular or transformed cube: fields are the trailing
            # (logical) field axes, everything else is a lead axis
            lead_names = tuple(n for n in dc.axis_names
                               if n not in self.field_axes)
            field_elems = int(np.prod([len(dc.axis(n, {})) for n in
                                       self.field_axes]))
        else:
            return dc.nbytes
        for name in lead_names:
            ax = dc.axis(name, {})
            if name in sels:
                n_lead *= len(sels[name].values)
                continue
            on_axis = [p for p in polys if name in p.axes]
            if not on_axis:
                n_lead *= len(ax)
                continue
            lo = min(p.extents(name)[0] for p in on_axis)
            hi = max(p.extents(name)[1] for p in on_axis)
            pos, _ = ax.indices_in_range(lo, hi)
            n_lead *= max(1, len(pos))
        return n_lead * field_elems * dc.dtype.itemsize
