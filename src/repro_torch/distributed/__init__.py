# Consistent-hash routing for the sharded plan cache.
from .sharding import PREFIX_HEX, RING_SPACE, HashRing, key_point

__all__ = ["PREFIX_HEX", "RING_SPACE", "HashRing", "key_point"]
