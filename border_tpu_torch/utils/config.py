"""Config-from-YAML construction and config-tree flattening
(≙ border_tpu/utils/config.py).

≙ the reference's three config tiers (SURVEY.md §5.6):

1. every component already has a dataclass config with YAML-able fields
   (≙ serde Config structs),
2. :func:`build_agent_from_path` / :func:`build_agent` construct an agent
   from a YAML file or dict (≙ ``Configurable::build_from_path``,
   border-core/src/base/policy.rs:100-140), :func:`build_env` does the same
   for environments (≙ ``Env::build(config, seed)``, base/env.rs:81-83),
3. :func:`flatten_config` turns the whole config tree into dotted
   ``section.key → value`` pairs for experiment tracking (≙ serializing the
   config tree into MLflow params, examples/gym/dqn_cartpole/src/main.rs:122-125).

``yaml`` is imported only by the functions that read or write YAML, so the
dict-based builders work where PyYAML is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from border_tpu_torch.errors import ConfigError

# -- model factories by name (YAML cannot hold callables) -------------------


def _atari_cnn(n: int):
    from border_tpu_torch.models import AtariCNN

    return AtariCNN(out_dim=n)


def _atari_cnn_factory():
    return _atari_cnn


MODEL_REGISTRY: Dict[str, Callable[[], Callable]] = {
    "atari_cnn": _atari_cnn_factory,
}


def register_model(name: str, factory: Callable[[], Callable]) -> None:
    MODEL_REGISTRY[name] = factory


def _agent_registry() -> Dict[str, Tuple[type, type]]:
    from border_tpu_torch.agents import (
        AWAC, AWACConfig, BC, BCConfig, DQN, DQNConfig,
        IQL, IQLConfig, IQN, IQNConfig, SAC, SACConfig,
    )

    return {
        "dqn": (DQN, DQNConfig),
        "iqn": (IQN, IQNConfig),
        "sac": (SAC, SACConfig),
        "awac": (AWAC, AWACConfig),
        "iql": (IQL, IQLConfig),
        "bc": (BC, BCConfig),
    }


# -- dataclass ↔ plain-dict/YAML --------------------------------------------


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    """Dataclass config → YAML-safe dict.  Callable fields (model
    factories) are replaced by their registered name when known, else
    dropped with a ``<callable>`` marker."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if callable(v) and not isinstance(v, type):
            name = getattr(v, "_config_name", None)
            out[f.name] = name if name else "<callable>"
        elif isinstance(v, tuple):
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out


def save_config(cfg: Any, path: str, kind: Optional[str] = None) -> None:
    doc = {"config": config_to_dict(cfg)}
    if kind is not None:
        doc["kind"] = kind
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(doc, f)


def _resolve_model(d: Dict[str, Any]) -> Dict[str, Any]:
    model = d.get("model")
    if isinstance(model, str) and model not in ("<callable>",):
        factory = MODEL_REGISTRY[model]()
        try:
            factory._config_name = model
        except AttributeError:
            pass
        d = dict(d, model=factory)
    elif model == "<callable>":
        d = dict(d, model=None)
    return d


def build_agent(kind: str, config: Optional[Dict[str, Any]] = None):
    """(kind, config dict) → constructed Agent (≙ Configurable::build)."""
    agent_cls, cfg_cls = _agent_registry()[kind]
    d = dict(config or {})
    field_names = {f.name for f in dataclasses.fields(cfg_cls)}
    unknown = set(d) - field_names
    if unknown:
        raise ConfigError(f"unknown {kind} config fields: {sorted(unknown)}")
    if "model" in d:
        d = _resolve_model(d)
    for f in dataclasses.fields(cfg_cls):
        if f.name in d and isinstance(d[f.name], list):
            d[f.name] = tuple(d[f.name])
    return agent_cls(cfg_cls(**d))


def build_agent_from_path(path: str):
    """YAML {kind: ..., config: {...}} → Agent
    (≙ Configurable::build_from_path, base/policy.rs:131-139)."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    return build_agent(doc["kind"], doc.get("config"))


def build_env(config: Dict[str, Any]):
    """YAML/dict {name: ..., **kwargs} → Environment via the registry
    (≙ Env::build(config, seed), base/env.rs:81-83).  The environment is a
    description; the ``VecEnv`` or trainer that runs it takes the device."""
    from border_tpu_torch.envs import make

    d = dict(config)
    name = d.pop("name")
    return make(name, **d)


def build_env_from_path(path: str):
    import yaml

    with open(path) as f:
        return build_env(yaml.safe_load(f))


# -- config-tree flattening for experiment tracking -------------------------


def flatten_config(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts/dataclasses → flat ``a.b.c → value`` params dict."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = config_to_dict(v)
        if isinstance(v, dict):
            flat.update(flatten_config(v, prefix=f"{key}."))
        elif isinstance(v, (list, tuple)):
            flat[key] = str(list(v))
        else:
            flat[key] = v
    return flat
