"""Asset pipeline: decode a state directory into live-able objects.

The port of ``tpu_operator/controllers/resource_manager.py``; its assets
are the port's own (``tpu_operator_torch/assets/``). Reference analogue: controllers/resource_manager.go — but where the reference
regex-matches ``kind:`` to route each YAML into a typed struct field
(:35-53, :91-187), the dynamic-object design makes decode trivial: every
document becomes an ``Obj``; apply order is the filename order the asset
numbering scheme (NNNN_) already encodes.
"""

from __future__ import annotations

import os

import yaml

from tpu_operator_torch.kube.objects import REGISTRY, Obj

# assets baked into the operator image / the package
DEFAULT_ASSETS_DIR = os.environ.get(
    "GPU_OPERATOR_ASSETS",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "assets"))


class AssetError(Exception):
    pass


def load_state_assets(state_dir: str) -> list[Obj]:
    """Decode every YAML document under ``state_dir``, filename order.

    Unknown kinds are a hard error at load time (operator startup), not at
    apply time — same fail-fast the reference gets from panicking on decode
    (resource_manager.go:101-187).
    """
    if not os.path.isdir(state_dir):
        raise AssetError(f"no such state dir: {state_dir}")
    objs: list[Obj] = []
    for fname in sorted(os.listdir(state_dir)):
        if not (fname.endswith(".yaml") or fname.endswith(".yml")):
            continue
        path = os.path.join(state_dir, fname)
        with open(path) as f:
            try:
                docs = list(yaml.safe_load_all(f))
            except yaml.YAMLError as e:
                raise AssetError(f"{path}: bad YAML: {e}") from None
        for doc in docs:
            if not doc:
                continue
            kind = doc.get("kind")
            if not kind:
                raise AssetError(f"{path}: document without kind")
            if kind not in REGISTRY:
                raise AssetError(f"{path}: unsupported kind {kind!r}")
            objs.append(Obj(doc))
    if not objs:
        raise AssetError(f"{state_dir}: no manifests found")
    return objs


def load_all_states(assets_dir: str, state_names: list[str]) -> dict[str, list[Obj]]:
    return {name: load_state_assets(os.path.join(assets_dir, name))
            for name in state_names}
