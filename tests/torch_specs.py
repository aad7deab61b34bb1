"""Helpers for the port's differential tests: describe a JAX-package
object as a plain numpy spec (``repro_torch.carry``'s input) and compare
plans across the two packages.  Not a test module."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro.core import axes as ref_axes
from repro.core import datacube as ref_datacube
from repro.core import shapes as ref_shapes


def axis_spec(ax) -> dict:
    if isinstance(ax, ref_axes.CyclicAxis):
        return {"kind": "cyclic", "name": ax.name,
                "values": np.array(ax.values), "period": ax.period}
    if isinstance(ax, ref_axes.OrderedAxis):
        return {"kind": "ordered", "name": ax.name,
                "values": np.array(ax.values)}
    if isinstance(ax, ref_axes.CategoricalAxis):
        return {"kind": "categorical", "name": ax.name,
                "values": list(ax.values)}
    raise TypeError(type(ax))


def transform_spec(t) -> dict:
    if isinstance(t, ref_axes.CyclicTransform):
        return {"kind": "cyclic", "name": t.logical_name,
                "period": t.period, "storage_name": t.storage_names[0]}
    if isinstance(t, ref_axes.MergedTransform):
        return {"kind": "merged", "name": t.logical_name,
                "storage_names": list(t.storage_names)}
    if isinstance(t, ref_axes.MappedTransform):
        return {"kind": "mapped", "name": t.logical_name,
                "storage_name": t.storage_names[0],
                "values": np.array(t._values)}
    raise TypeError(type(t))


def cube_spec(dc) -> dict:
    if isinstance(dc, ref_datacube.TransformedDatacube):
        return {"kind": "transformed", "base": cube_spec(dc.base),
                "transforms": [transform_spec(t)
                               for t in dc._transforms.values()]}
    if isinstance(dc, ref_datacube.TensorDatacube):
        return {"kind": "tensor", "axes": [axis_spec(a) for a in dc._axes],
                "dtype": dc.dtype.name}
    if isinstance(dc, ref_datacube.OctahedralGridDatacube):
        return {"kind": "octahedral",
                "leading": [axis_spec(a) for a in dc._leading],
                "n": dc.n, "dtype": dc.dtype.name}
    raise TypeError(type(dc))


def _field_spec(value):
    if isinstance(value, ref_shapes.Shape):
        return shape_spec(value)
    if isinstance(value, (list, tuple)) and value and all(
            isinstance(v, ref_shapes.Shape) for v in value):
        return [shape_spec(v) for v in value]
    if isinstance(value, np.ndarray):
        return value.copy()
    return value


def shape_spec(shape) -> dict:
    out = {"kind": type(shape).__name__.lower()}
    for f in dataclasses.fields(shape):
        out[f.name] = _field_spec(getattr(shape, f.name))
    return out


def request_spec(request) -> dict:
    return {"shapes": [shape_spec(s) for s in request.shapes]}


def assert_plans_equal(got, want, label=""):
    """Offsets, runs, coords and itemsize of two plans, byte for byte."""
    np.testing.assert_array_equal(got.offsets, want.offsets, label)
    assert got.offsets.dtype == want.offsets.dtype, label
    np.testing.assert_array_equal(got.run_starts, want.run_starts, label)
    np.testing.assert_array_equal(got.run_lengths, want.run_lengths, label)
    assert set(got.coords) == set(want.coords), label
    for k in got.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k], label)
    assert got.itemsize == want.itemsize, label


def assert_stats_equal(got, want, label=""):
    assert got.n_slices == want.n_slices, label
    assert got.n_slices_by_dim == want.n_slices_by_dim, label
    assert got.n_points == want.n_points, label
