"""Carry state across from plain numpy specs into the port's objects.

The extraction system has no weights: its state is the datacube, the
payload and the requests.  A *spec* is a plain dict of numpy arrays,
numbers and strings that either implementation can be described by, so
the same arrays feed both and nothing of one package leaks into the
other.  The models do have weights: ``dlrm_from_params``,
``deepfm_from_params``, ``twotower_from_params`` and
``nequip_from_params`` load a parameter tree of numpy arrays, laid out
as the JAX package's initialisers build it, into the port's modules, and
``transformer_from_params`` turns such a tree into the decoder's
parameter dict (BERT4Rec's too, with its ``pos_embed``).
``distribute_state`` places such a state (or a batch) on a mesh as
``DTensor`` tensors under a cell's specs.

Training state crosses too: ``model_params`` keys a recsys model's or
NequIP's parameters by the JAX package's tree paths (``"bags/tables"``,
``"bot/layers/0/w"``, ``"user_embed/table"``), the keys of the port's
train state (``repro_torch.train``), and ``decoder_params`` does the
same for a decoder (the LMs, BERT4Rec), its layers stacked by group as
the JAX tree holds them (``"groups/0/attn/wq"``); ``decoder_tree`` is
its inverse.  ``train_state_from_tree`` loads a
JAX train state ``{"params", "opt"}`` (AdamW's ``m``, ``v``, ``step``
or Adafactor's ``f``, ``step``; ``ef`` too where present) of numpy
arrays into a model and a port train state, and ``train_state_to_tree``
turns a port train state back into that tree.

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
from .models import nequip as _nequip
from .models import recsys as _recsys
from .models import transformer as _transformer
from .train.checkpoint import SEP, flatten_tree

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


def _load(param: torch.Tensor, value: Any, what: str) -> None:
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{what}: shape {arr.shape}, the module's is "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(arr, order="C")))


def _load_mlp(mlp: torch.nn.Module, tree: dict, what: str) -> None:
    layers = tree["layers"]
    if len(layers) != len(mlp.layers):
        raise ValueError(f"{what}: {len(layers)} layers, the module has "
                         f"{len(mlp.layers)}")
    for i, (layer, p) in enumerate(zip(mlp.layers, layers)):
        _load(layer.w, p["w"], f"{what}.layers[{i}].w")
        _load(layer.b, p["b"], f"{what}.layers[{i}].b")


# The parameters whose JAX path is not their module name with "." → "/".
_PATHS = {_recsys.TwoTower: {"user_embed": "user_embed/table",
                             "item_embed": "item_embed/table"}}


def jax_path(model: torch.nn.Module, name: str) -> str:
    """The JAX package's tree path of ``model``'s parameter ``name``."""
    renames = _PATHS.get(type(model), {})
    if name in renames:
        return renames[name]
    parts = name.split(".")
    if isinstance(model, _nequip.NequIP):
        # NequIP's "self" is the attribute self_interaction.
        parts = ["self" if p == "self_interaction" else p for p in parts]
    return SEP.join(parts)


def model_params(model) -> dict:
    """A model's parameters keyed by the JAX package's tree paths
    (``"bags/tables"``, ``"bot/layers/0/w"``, ``"user_embed/table"``,
    NequIP's ``"layers/0/self/0"``): the ``params`` of the port's train
    state.  A decoder's parameters are already such a dict
    (``decoder_params``), returned as it is."""
    if isinstance(model, dict):
        return model
    return {jax_path(model, name): p
            for name, p in model.named_parameters()}


def decoder_params(params: dict, cfg: _transformer.TransformerConfig
                   ) -> dict:
    """A decoder's nested parameters (``transformer.init_params``) as a
    train state's flat dict, keyed by the JAX package's tree paths with
    each group's layers stacked (``"groups/0/attn/wq"`` (L_group, ...),
    ``transformer.stack_groups``).  ``decoder_tree`` gives the nested
    parameters back, as views of these tensors."""
    return flatten_tree(_transformer.stack_groups(params, cfg))


def decoder_tree(flat: dict, cfg: _transformer.TransformerConfig) -> dict:
    """The inverse of ``decoder_params``: the nested parameters a decoder
    runs on, each layer's tensors views of the flat dict's stacked ones
    (so gradients reach those)."""
    return _transformer.unstack_groups(tree_from_paths(flat), cfg)


def _load_params(model, params: dict, what: str) -> None:
    """Load a JAX parameter tree of numpy arrays into ``model``: every
    path of the tree must be one of the model's, and the other way
    round."""
    flat, own = flatten_tree(params), model_params(model)
    if set(flat) != set(own):
        raise ValueError(f"{what}: parameters {sorted(flat)}, the module "
                         f"has {sorted(own)}")
    for path, value in flat.items():
        _load(own[path], value, f"{what}.{path}")


def dlrm_from_params(cfg: _recsys.DLRMConfig, params: dict,
                     device=None) -> _recsys.DLRM:
    """A ``DLRM`` holding ``params``: ``{"bags": {"tables"}, "bot":
    {"layers": [{"w", "b"}, ...]}, "top": {...}}`` as numpy arrays."""
    model = _recsys.DLRM(cfg, device=device)
    _load_params(model, params, cfg.name)
    return model


def deepfm_from_params(cfg: _recsys.DeepFMConfig, params: dict,
                       device=None) -> _recsys.DeepFM:
    """A ``DeepFM`` holding ``params``: ``{"bags": {"tables"}, "linear":
    {"tables"}, "deep": {"layers": [...]}, "bias"}`` as numpy arrays."""
    model = _recsys.DeepFM(cfg, device=device)
    _load_params(model, params, cfg.name)
    return model


def twotower_from_params(cfg: _recsys.TwoTowerConfig, params: dict,
                         device=None) -> _recsys.TwoTower:
    """A ``TwoTower`` holding ``params``: ``{"user_embed": {"table"},
    "item_embed": {"table"}, "user_tower": {"layers": [{"w", "b"}, ...]},
    "item_tower": {...}}`` as numpy arrays."""
    model = _recsys.TwoTower(cfg, device=device)
    _load_params(model, params, cfg.name)
    return model


def _tensors_like(tree: dict, params: dict, what: str) -> dict:
    """A params-shaped JAX tree (``m``, ``v``, ``ef``) as tensors keyed by
    path, on the parameters' devices."""
    flat = flatten_tree(tree)
    if set(flat) != set(params):
        raise ValueError(f"{what}: leaves {sorted(flat)}, the parameters "
                         f"are {sorted(params)}")
    out = {}
    for path, p in params.items():
        arr = np.asarray(flat[path])
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{what}.{path}: shape {arr.shape}, the "
                             f"parameter's is {tuple(p.shape)}")
        out[path] = torch.from_numpy(np.array(arr, order="C")).to(p.device)
    return out


def _factored(tree: dict, params: dict) -> dict:
    """Adafactor's ``f`` (per parameter ``{"vr", "vc"}`` or ``{"v"}``) as
    tensors keyed by parameter path."""
    flat = flatten_tree(tree)
    out = {path: {} for path in params}
    for key, value in flat.items():
        path, _, leaf = key.rpartition(SEP)
        if path not in out or leaf not in ("vr", "vc", "v"):
            raise ValueError(f"opt.f: leaf {key!r} is not a moment of a "
                             f"parameter")
        out[path][leaf] = torch.from_numpy(
            np.array(np.asarray(value), order="C")).to(params[path].device)
    for path, p in params.items():
        want = ({"vr": p.shape[:-1], "vc": p.shape[:-2] + p.shape[-1:]}
                if p.ndim >= 2 else {"v": p.shape})
        got = {k: tuple(t.shape) for k, t in out[path].items()}
        if got != {k: tuple(v) for k, v in want.items()}:
            raise ValueError(f"opt.f.{path}: {got}, expected {want}")
    return out


def train_state_from_tree(model, tree: dict) -> dict:
    """Load a JAX train state of numpy arrays — ``{"params", "opt"}``,
    and ``"ef"`` where present — into ``model`` (a module, or a
    decoder's flat parameters: ``decoder_params``) and a port train
    state on its device: ``{"params": model_params(model), "opt": {"m",
    "v", "step"} or {"f", "step"}}`` (and ``"ef"``)."""
    _load_params(model, tree["params"], "params")
    params = model_params(model)
    device = next(iter(params.values())).device
    opt = {}
    for key, value in tree["opt"].items():
        if key == "step":
            opt[key] = torch.tensor(np.asarray(value), dtype=torch.int32,
                                    device=device)
        elif key in ("m", "v"):
            opt[key] = _tensors_like(value, params, f"opt.{key}")
        elif key == "f":
            opt[key] = _factored(value, params)
        else:
            raise ValueError(f"opt: unknown leaf {key!r}")
    state = {"params": params, "opt": opt}
    if "ef" in tree:
        state["ef"] = _tensors_like(tree["ef"], params, "ef")
    return state


def distribute_state(tree: Any, mesh, specs: Any) -> Any:
    """A carried tree (a train state, parameters or a batch, of plain
    tensors or numpy arrays) placed on ``mesh`` (``launch.mesh.Mesh``):
    each leaf a ``DTensor`` under its spec in ``specs`` (a cell's
    ``Lowering.in_specs`` entry), the spec first made legal for the
    mesh's sizes (``sanitize_specs``).  Every rank passes the whole tree
    and keeps its own shards, so a model carried from one set of weights
    runs sharded from those weights."""
    from .dataplane.pipeline import device_put_sharded
    from .distributed import sharding as shd

    tensors = shd.tree_map(lambda x: x if isinstance(x, torch.Tensor)
                           else torch.as_tensor(np.asarray(x)), tree)
    return device_put_sharded(tensors, shd.named(
        mesh, shd.sanitize_specs(specs, tensors, mesh)))


def tree_from_paths(flat: dict) -> dict:
    """{path: leaf} → nested dicts, and lists where a level's keys are
    0..n-1 (the JAX package's layer lists)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *parts, last = path.split(SEP)
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and \
            sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def train_state_to_tree(state: dict) -> dict:
    """A port train state as the JAX package's tree of numpy arrays (host
    copies): the inverse of ``train_state_from_tree``."""
    return tree_from_paths({
        path: leaf.detach().to("cpu", copy=True).numpy()
        for path, leaf in flatten_tree(state).items()})


def _load_keyed(params: torch.nn.ParameterDict, tree: dict,
                what: str) -> None:
    if set(tree) != set(params.keys()):
        raise ValueError(f"{what}: keys {sorted(tree)}, the module has "
                         f"{sorted(params.keys())}")
    for key, value in tree.items():
        _load(params[key], value, f"{what}[{key!r}]")


def nequip_from_params(cfg: _nequip.NequIPConfig, params: dict,
                       device=None) -> _nequip.NequIP:
    """A ``NequIP`` holding ``params``: ``{"embed": {"layers": [...]},
    "readout": {...}, "layers": [{"radial": {...}, "mix": {l: w},
    "self": {l: w}, "gate": {l: w}}, ...]}`` as numpy arrays, keyed by
    ``str(l)`` as the JAX package's ``nequip_init`` builds it, and cast
    to ``cfg.dtype``."""
    model = _nequip.NequIP(cfg, device=device)
    layers = params["layers"]
    if len(layers) != len(model.layers):
        raise ValueError(f"nequip: {len(layers)} layers, the module has "
                         f"{len(model.layers)}")
    _load_mlp(model.embed, params["embed"], "embed")
    _load_mlp(model.readout, params["readout"], "readout")
    for i, (layer, p) in enumerate(zip(model.layers, layers)):
        _load_mlp(layer.radial, p["radial"], f"layers[{i}].radial")
        _load_keyed(layer.mix, p["mix"], f"layers[{i}].mix")
        _load_keyed(layer.self_interaction, p["self"], f"layers[{i}].self")
        _load_keyed(layer.gate, p["gate"], f"layers[{i}].gate")
    return model


def _carry_tree(tree: dict, want: dict, what: str, device: torch.device,
                layer: int | None = None) -> dict:
    """``tree`` (numpy arrays; with ``layer``, stacked along a leading
    layer axis and taken at ``layer``) as tensors shaped like ``want``
    and in its dtypes."""
    if set(tree) != set(want):
        raise ValueError(f"{what}: keys {sorted(tree)}, expected "
                         f"{sorted(want)}")
    out = {}
    for key, spec in want.items():
        name = f"{what}.{key}"
        if isinstance(spec, dict):
            out[key] = _carry_tree(tree[key], spec, name, device, layer)
            continue
        arr = np.asarray(tree[key])
        if layer is not None:
            arr = arr[layer]
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{tuple(spec.shape)}")
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(
            device=device, dtype=spec.dtype)
    return out


def transformer_from_params(cfg: _transformer.TransformerConfig,
                            params: dict, device=None) -> dict:
    """The port's parameter dict for ``params``, a tree of numpy arrays
    as the JAX package's ``init_params`` builds it: ``{"embed":
    {"table"}, "final_norm": {"scale"}, "groups": [stacked layers, ...]}``
    (and ``"head"`` for untied embeddings, ``"mtp"`` for DeepSeek's
    multi-token-prediction head, ``"pos_embed"`` for learned
    positions).  Each of ``cfg.layer_groups()``'s
    groups holds its layers' leaves stacked (L_group, ...): they are
    unstacked into ``params["layers"]`` in execution order.  The group
    count, every key and every shape are checked; the tensors are cast
    to ``cfg.dtype`` (the MoE router stays float32) on ``device`` (None
    = the card)."""
    want = _transformer.init_params(cfg, device="meta")
    dev = resolve_device(device)
    groups = params.get("groups", [])
    layout = cfg.layer_groups()
    if len(groups) != len(layout):
        raise ValueError(f"{cfg.name}: {len(groups)} layer groups, the "
                         f"configuration has {len(layout)}")
    top = {k: v for k, v in params.items() if k != "groups"}
    top_want = {k: v for k, v in want.items() if k != "layers"}
    out = _carry_tree(top, top_want, cfg.name, dev)
    out["layers"] = []
    for gi, ((n, _), group) in enumerate(zip(layout, groups)):
        for leaf in _transformer.tree_leaves(group):
            if np.shape(leaf)[:1] != (n,):
                raise ValueError(f"{cfg.name}: a stacked leaf of group {gi} "
                                 f"has shape {np.shape(leaf)}, expected "
                                 f"{n} layers")
        for j in range(n):
            i = len(out["layers"])
            out["layers"].append(_carry_tree(
                group, want["layers"][i], f"{cfg.name}.layers[{i}]", dev,
                layer=j))
    return out
