"""Model registry of the port: ``get_config(arch_id)`` resolves here.

Each module holds ``ID``, the full published configuration ``_cfg()``
and a reduced smoke configuration ``_smoke()``, with the same values as
the JAX package's configuration modules: the same ten architectures.
The sharding rules and lowerings are not ported.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "arctic-480b": "arctic_480b",
    "dlrm-rm2": "dlrm_rm2",
    "deepfm": "deepfm",
    "two-tower-retrieval": "two_tower_retrieval",
    "bert4rec": "bert4rec",
    "nequip": "nequip",
    "glm4-9b": "glm4_9b",
    "granite-3-8b": "granite_3_8b",
    "yi-34b": "yi_34b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False):
    """The published configuration of ``arch_id`` (the smoke one with
    ``smoke=True``)."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod._smoke() if smoke else mod._cfg()
