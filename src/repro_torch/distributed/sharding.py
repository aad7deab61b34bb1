"""Consistent-hash routing of plan-cache keys to shards (DESIGN.md §7).

Only the ring of the JAX package's ``distributed/sharding.py`` is here:
``PREFIX_HEX``, ``RING_SPACE``, ``key_point`` and ``HashRing``, with the
logic unchanged.  It is pure Python.  The mesh and the partition rules
of that file wait for the model layers.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable


# ---------------------------------------------------------------------------
# Consistent-hash routing (DESIGN.md §7)
#
# Plan-cache keys are stable sha256 content hashes
# (``Request.canonical_hash``), so the routing point is simply the key's
# leading 64-bit hex prefix — already uniform, never rehashed.  Shards
# get ``replicas`` virtual points on the ring, which keeps balance
# within a few percent and makes shard add/remove move only ~1/N of the
# key space (the classic consistent-hashing guarantee the rebalance
# tests pin down).
# ---------------------------------------------------------------------------

PREFIX_HEX = 16        # leading hex chars of a key → 64-bit ring point
RING_SPACE = 2 ** (4 * PREFIX_HEX)


def key_point(key: str) -> int:
    """Ring position of a canonical-hash key: its 64-bit hex prefix."""
    return int(key[:PREFIX_HEX], 16)


class HashRing:
    """Consistent-hash ring over named shards.

    Lock-free readers: the ring state is one tuple
    ``(nodes, points, owners)`` that mutators rebuild and swap with a
    single attribute store, so a concurrent ``route`` sees either the
    old or the new ring, never a half-built one.  Mutations themselves
    are admin-plane — callers (``ShardedPlanCache.add_shard``) serialize
    them externally.
    """

    def __init__(self, nodes: Iterable[str] = (), replicas: int = 64):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = replicas
        self._state: tuple[tuple[str, ...], tuple[int, ...],
                           tuple[str, ...]] = ((), (), ())
        for node in nodes:
            self.add_node(node)

    @property
    def nodes(self) -> tuple[str, ...]:
        """Shard names in insertion order."""
        return self._state[0]

    def __len__(self) -> int:
        return len(self._state[0])

    def __contains__(self, node: str) -> bool:
        return node in self._state[0]

    @staticmethod
    def _virtual_points(node: str, replicas: int) -> list[int]:
        return [int(hashlib.sha256(f"{node}#{i}".encode()).hexdigest()
                    [:PREFIX_HEX], 16) for i in range(replicas)]

    def _rebuild(self, nodes: tuple[str, ...]) -> None:
        ring = sorted((p, n) for n in nodes
                      for p in self._virtual_points(n, self.replicas))
        self._state = (nodes, tuple(p for p, _ in ring),
                       tuple(n for _, n in ring))

    def add_node(self, node: str) -> None:
        nodes = self._state[0]
        if node in nodes:
            raise ValueError(f"shard {node!r} already on the ring")
        self._rebuild(nodes + (node,))

    def remove_node(self, node: str) -> None:
        nodes = self._state[0]
        if node not in nodes:
            raise KeyError(node)
        self._rebuild(tuple(n for n in nodes if n != node))

    def route(self, key: str) -> str:
        """Owning shard of a canonical-hash key (clockwise successor of
        the key's 64-bit prefix point on the ring)."""
        _, points, owners = self._state
        if not owners:
            raise RuntimeError("HashRing has no nodes")
        i = bisect.bisect_right(points, key_point(key))
        return owners[i % len(owners)]
