"""Typed-config base machinery — the port of
``deepspeed_tpu/runtime/config_utils.py``.

The reference builds its configs on pydantic; the port uses dataclasses
with the same contract, so it needs no package beyond torch and numpy:

- unknown keys raise :class:`ConfigError` (a typo fails loudly);
- ``"auto"`` is accepted where a field's type allows a string;
- nested sections are built from dicts.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, Type, TypeVar


class ConfigError(Exception):
    """Raised for malformed configs (reference: ``DeepSpeedConfigError``)."""


AUTO = "auto"

M = TypeVar("M", bound="DSConfigModel")


def is_auto(value: Any) -> bool:
    return isinstance(value, str) and value.lower() == AUTO


def _section_type(hint: Any) -> Optional[Type["DSConfigModel"]]:
    """The config class a field holds (also under ``Optional[...]``)."""
    if isinstance(hint, type) and issubclass(hint, DSConfigModel):
        return hint
    if typing.get_origin(hint) is typing.Union:
        for arg in typing.get_args(hint):
            if isinstance(arg, type) and issubclass(arg, DSConfigModel):
                return arg
    return None


class DSConfigModel:
    """Base of every config section; subclasses are dataclasses.

    ``from_dict`` rejects unknown keys and builds nested sections from
    dicts; ``validate``, run on every construction, checks field values."""

    def __post_init__(self) -> None:
        self.validate()

    @classmethod
    def from_dict(cls: Type[M], data: Any) -> M:
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise ConfigError(f"{cls.__name__}: expected a dict, got "
                              f"{type(data).__name__}")
        hints = typing.get_type_hints(cls)
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - names)
        if unknown:
            raise ConfigError(f"{cls.__name__}: unknown key(s) {unknown}; "
                              f"have {sorted(names)}")
        kwargs = {}
        for key, value in data.items():
            section = _section_type(hints[key])
            if section is not None and value is not None:
                value = section.from_dict(value)
            kwargs[key] = value
        try:
            return cls(**kwargs)
        except TypeError as e:
            raise ConfigError(f"{cls.__name__}: {e}") from e

    def validate(self) -> None:
        """Field checks of a section; raises :class:`ConfigError`."""


def check_int_or_auto(owner: str, **values: Any) -> None:
    for name, value in values.items():
        if is_auto(value):
            continue
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{owner}.{name} must be an int or 'auto', "
                              f"got {value!r}")
