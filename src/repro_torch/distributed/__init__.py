# Consistent-hash routing for the sharded plan cache, and distribution:
# the sharding rules (``sharding``), the mesh-axis context (``context``)
# and the int8 all-reduce (``compression``).
from . import compression, context, sharding  # noqa: F401
from .sharding import PREFIX_HEX, RING_SPACE, HashRing, key_point

__all__ = ["PREFIX_HEX", "RING_SPACE", "HashRing", "key_point"]
