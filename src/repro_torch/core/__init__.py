# The paper's primary contribution: the Polytope feature-extraction
# engine — geometry, axes, datacubes, Algorithm-1 slicer, index trees,
# extraction plans and executors (plus the bounding-box / whole-field
# baselines the paper compares against).  The batched planner of the
# JAX package (batched.py, kernel B5) is not ported yet.
from .axes import (Axis, CategoricalAxis, CyclicAxis, CyclicTransform,
                   MappedTransform, MergedTransform, OrderedAxis, Transform)
from .datacube import (BranchingDatacube, Datacube, OctahedralGridDatacube,
                       TensorDatacube, TransformedDatacube)
from .delta_planner import DeltaPlanner
from .device_planner import DevicePlanner
from .extractor import (BoundingBoxExtractor, ExtractResult,
                        PolytopeExtractor, TraditionalExtractor, gather)
from .geometry import Polytope, box_polytope, regular_polygon, slice_vertices
from .hull import convex_hull_prune
from .index_tree import (CompressedPlan, ExtractionPlan, IndexNode,
                         assemble_plan, coalesce_runs, compress_plan,
                         decompress_plan, flatten)
from .shapes import (CANON_TOL, All, Box, ConvexPolytope, Disk, Ellipsoid,
                     Path, Point, Polygon, Request, Select, Shape, Span,
                     Union, canonical_hash, canonical_key, ear_clip,
                     shape_signature, signature_hash)
from .slicer import Slicer, SliceStats

__all__ = [
    "Axis", "CategoricalAxis", "CyclicAxis", "OrderedAxis",
    "Transform", "CyclicTransform", "MappedTransform", "MergedTransform",
    "BranchingDatacube", "Datacube", "OctahedralGridDatacube",
    "TensorDatacube", "TransformedDatacube",
    "BoundingBoxExtractor", "ExtractResult",
    "PolytopeExtractor", "TraditionalExtractor", "gather", "Polytope",
    "box_polytope", "regular_polygon", "slice_vertices",
    "convex_hull_prune", "ExtractionPlan", "IndexNode", "coalesce_runs",
    "flatten", "assemble_plan", "CompressedPlan", "compress_plan",
    "decompress_plan",
    "DeltaPlanner", "DevicePlanner", "All", "Box", "ConvexPolytope",
    "Disk", "Ellipsoid", "Path",
    "Point", "Polygon", "Request", "Select", "Shape", "Span", "Union",
    "ear_clip", "Slicer", "SliceStats", "CANON_TOL",
    "canonical_hash", "canonical_key", "shape_signature",
    "signature_hash",
]
