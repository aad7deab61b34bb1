"""PyTorch + CUDA port of the Polytope extraction system.

Same layout and names as the JAX package it was ported from: ``core``
(geometry, axes, datacubes, Algorithm-1 slicer, device planner,
extractors), ``kernels`` (hand-written CUDA kernels with plain PyTorch
versions), ``serve`` (plan cache and extraction service), ``dataplane``
(weather cubes, click streams, graphs), ``models`` (dense layers, the
DLRM and DeepFM serving models, NequIP), ``configs`` (their published
configurations) and ``analysis`` (plan verifier).  ``carry`` turns
plain numpy specs and parameter trees into the port's objects.
"""
