"""Utilities of the port (≙ border_tpu/utils): device resolution,
checkpointing, the build cache, profiling, policy export, config
construction, live display / frame capture.

The names below the device helpers are imported at first use: the modules
that define them import the agents and models, which import this package's
device helpers first.
"""

import importlib

from border_tpu_torch.utils.device import as_generator, resolve_device  # noqa: F401

_LAZY = {
    "enable_compilation_cache": "cache",
    "CheckpointManager": "checkpoint",
    "FrameRecorder": "window",
    "TerminalWindow": "window",
    "profile_trace": "profiling",
    "export_policy": "export",
    "NumpyMLPPolicy": "export",
    "build_agent": "config",
    "build_agent_from_path": "config",
    "build_env": "config",
    "build_env_from_path": "config",
    "config_to_dict": "config",
    "flatten_config": "config",
    "register_model": "config",
    "save_config": "config",
}

__all__ = ["as_generator", "resolve_device", *_LAZY]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
