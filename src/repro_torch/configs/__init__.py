"""Model registry of the port: ``get_config(arch_id)`` resolves here.

Each module holds ``ID``, the full published configuration ``_cfg()``,
a reduced smoke configuration ``_smoke()``, the training optimizer
``_opt()`` and ``get()``, its ``common.ArchDef`` (lowerings, shardings,
smoke set-up), with the same values as the JAX package's configuration
modules: the same ten architectures, in the same order.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "arctic-480b": "arctic_480b",
    "glm4-9b": "glm4_9b",
    "yi-34b": "yi_34b",
    "granite-3-8b": "granite_3_8b",
    "nequip": "nequip",
    "dlrm-rm2": "dlrm_rm2",
    "bert4rec": "bert4rec",
    "two-tower-retrieval": "two_tower_retrieval",
    "deepfm": "deepfm",
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


def get_arch(arch_id: str):
    """The ``common.ArchDef`` of ``arch_id``."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"{__name__}.{_MODULES[arch_id]}").get()


def all_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells — 40 in all."""
    return [(aid, shape) for aid in ARCH_IDS
            for shape in get_arch(aid).shapes]
