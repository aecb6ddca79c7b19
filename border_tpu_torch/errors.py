"""Unified error surface of the PyTorch port.

Own copy of :mod:`border_tpu.errors` (the port imports nothing of the JAX
package): catch ``BorderTpuError`` for any framework-raised condition, or the
specific subclass.
"""

from __future__ import annotations


class BorderTpuError(Exception):
    """Base class for every error this framework raises."""


class RecordKeyError(BorderTpuError, KeyError):
    """A Record was asked for a key it does not hold."""

    def __init__(self, key: str):
        super().__init__(key)
        self.key = key

    def __str__(self) -> str:
        return f"Record has no key {self.key!r}"


class RecordValueTypeError(BorderTpuError, TypeError):
    """A Record value was accessed with the wrong typed getter."""

    def __init__(self, key: str, expected: str, actual: str):
        super().__init__(key, expected, actual)
        self.key = key
        self.expected = expected
        self.actual = actual

    def __str__(self) -> str:
        return (
            f"Record key {self.key!r} is not a {self.expected} "
            f"(got {self.actual})"
        )


class ConfigError(BorderTpuError, ValueError):
    """Invalid component configuration."""


class EnvironmentError_(BorderTpuError, RuntimeError):
    """Environment construction/step failure (native pool, registry)."""
