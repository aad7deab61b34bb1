"""Carry state across from plain numpy specs into the port's objects.

The extraction system has no weights: its state is the datacube, the
payload and the requests.  A *spec* is a plain dict of numpy arrays,
numbers and strings that either implementation can be described by, so
the same arrays feed both and nothing of one package leaks into the
other.

Datacube spec::

    {"kind": "tensor", "axes": [axis, ...], "dtype": "float64"}
    {"kind": "transformed", "base": <tensor spec>,
     "transforms": [transform, ...]}
    {"kind": "octahedral", "leading": [axis, ...], "n": 32,
     "dtype": "float64"}

    axis      = {"kind": "ordered" | "cyclic" | "categorical",
                 "name": str, "values": array, "period": float (cyclic)}
    transform = {"kind": "cyclic", "name", "period", "storage_name"}
              | {"kind": "merged", "name", "storage_names"}
              | {"kind": "mapped", "name", "storage_name", "values"}

Request spec::

    {"shapes": [shape, ...]}
    shape = {"kind": <lower-cased shape class name>, **fields}

with the fields of the shape's dataclass (``axes``, ``lows``/``highs``,
``points``, ``vertices``, ``center``/``radius``, ``axis``/``values``,
...); the nested shapes of ``union`` and ``path`` are shape specs too.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .core import axes as _axes
from .core import datacube as _datacube
from .core import shapes as _shapes

_SHAPES = {cls.__name__.lower(): cls for cls in (
    _shapes.Select, _shapes.All, _shapes.Span, _shapes.Point, _shapes.Box,
    _shapes.ConvexPolytope, _shapes.Disk, _shapes.Ellipsoid,
    _shapes.Polygon, _shapes.Union, _shapes.Path)}


def _axis(spec: dict[str, Any]) -> _axes.Axis:
    kind = spec["kind"]
    if kind == "ordered":
        return _axes.OrderedAxis(spec["name"], spec["values"])
    if kind == "cyclic":
        return _axes.CyclicAxis(spec["name"], spec["values"],
                                period=spec["period"])
    if kind == "categorical":
        return _axes.CategoricalAxis(spec["name"], spec["values"])
    raise ValueError(f"unknown axis kind {kind!r}")


def _transform(spec: dict[str, Any]) -> _axes.Transform:
    kind = spec["kind"]
    if kind == "cyclic":
        return _axes.CyclicTransform(spec["name"], period=spec["period"],
                                     storage_name=spec.get("storage_name"))
    if kind == "merged":
        return _axes.MergedTransform(spec["name"], spec["storage_names"])
    if kind == "mapped":
        return _axes.MappedTransform(spec["name"], spec["storage_name"],
                                     values=spec["values"])
    raise ValueError(f"unknown transform kind {kind!r}")


def datacube_from_spec(spec: dict[str, Any]) -> _datacube.Datacube:
    kind = spec["kind"]
    if kind == "tensor":
        return _datacube.TensorDatacube([_axis(a) for a in spec["axes"]],
                                        dtype=spec.get("dtype", "float64"))
    if kind == "transformed":
        return _datacube.TransformedDatacube(
            datacube_from_spec(spec["base"]),
            [_transform(t) for t in spec["transforms"]])
    if kind == "octahedral":
        return _datacube.OctahedralGridDatacube(
            [_axis(a) for a in spec["leading"]], n=spec["n"],
            dtype=spec.get("dtype", "float64"))
    raise ValueError(f"unknown datacube kind {kind!r}")


def _field(value: Any) -> Any:
    if isinstance(value, dict) and "kind" in value:
        return shape_from_spec(value)
    if isinstance(value, list) and value and all(
            isinstance(v, dict) and "kind" in v for v in value):
        return [shape_from_spec(v) for v in value]
    return value


def shape_from_spec(spec: dict[str, Any]) -> _shapes.Shape:
    cls = _SHAPES.get(spec["kind"])
    if cls is None:
        raise ValueError(f"unknown shape kind {spec['kind']!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _field(v) for k, v in spec.items()
                  if k != "kind" and k in names})


def request_from_spec(spec: dict[str, Any]) -> _shapes.Request:
    return _shapes.Request([shape_from_spec(s) for s in spec["shapes"]])


def payload_to_tensor(flat: np.ndarray, device=None) -> torch.Tensor:
    """The flat payload as a contiguous tensor on ``device`` (None = the
    card), moved once."""
    dev = resolve_device(device)
    return torch.from_numpy(np.ascontiguousarray(flat)).to(dev)
