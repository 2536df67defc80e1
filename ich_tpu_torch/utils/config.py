"""JSON-backed attribute dicts and explicit name -> constructor registries,
copied from ``ich_tpu/utils/config.py`` (``AttrDict``, ``rgetattr``,
``Config``, ``Registry`` and the registries; importing ``ich_tpu`` imports
jax). The names are the reference's, so the JSON configs resolve
unchanged."""

from __future__ import annotations

import copy
import functools
import json
import os
from typing import Any, Callable, Dict, Iterator


class AttrDict(dict):
    """A dict whose items are also attributes, recursively (the reference's
    ``python_utils.py:15-28``): ``from_nested_dicts`` and ``from_json_path``
    classmethods, attribute get/set."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # keep AttributeError semantics for hasattr()
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def from_nested_dicts(cls, data: Any) -> Any:
        """Recursively convert nested dicts (in dicts/lists) to AttrDicts."""
        if isinstance(data, dict):
            return cls({k: cls.from_nested_dicts(v) for k, v in data.items()})
        if isinstance(data, (list, tuple)):
            return type(data)(cls.from_nested_dicts(v) for v in data)
        return data

    @classmethod
    def from_json_path(cls, path: str) -> "AttrDict":
        with open(path, "r") as f:
            return cls.from_nested_dicts(json.load(f))

    def to_dict(self) -> dict:
        """Deep-convert back to plain dicts (for JSON dumps)."""

        def conv(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def to_json_path(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def copy(self) -> "AttrDict":
        return AttrDict.from_nested_dicts(copy.deepcopy(self.to_dict()))


def rgetattr(obj: Any, attr: str, *args: Any) -> Any:
    """Recursive getattr through dotted paths (the reference's
    ``python_utils.py:30-41``)."""

    def _get(o: Any, name: str) -> Any:
        return getattr(o, name, *args)

    return functools.reduce(_get, [obj] + attr.split("."))


class Config:
    """Thin JSON config wrapper (the reference's ``Config.py:3-25``):
    ``settings`` is an :class:`AttrDict`; ``load_config`` / ``save_config``
    round-trip it to JSON."""

    def __init__(self, settings: Any = None):
        if settings is None:
            settings = {}
        self.settings = AttrDict.from_nested_dicts(dict(settings))

    def load_config(self, path: str) -> "Config":
        self.settings = AttrDict.from_json_path(path)
        return self

    def save_config(self, path: str) -> None:
        AttrDict.from_nested_dicts(self.settings).to_json_path(path)


class Registry:
    """Explicit name → constructor registry.

    Replaces the reference's ``getattr(module, name)`` reflection as the
    config extension mechanism. Each subsystem owns a registry instance
    (transforms, losses, schedulers, trainers) and registers symbols with
    :meth:`register`; configs then refer to them by name.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Callable] = {}

    def register(self, name: str | None = None) -> Callable:
        def deco(fn: Callable) -> Callable:
            key = name or fn.__name__
            if key in self._items:
                raise KeyError(f"{self.kind} registry already has {key!r}")
            self._items[key] = fn
            return fn

        return deco

    def add(self, name: str, fn: Callable) -> None:
        self.register(name)(fn)

    def get(self, name: str) -> Callable:
        try:
            return self._items[name]
        except KeyError:
            known = ", ".join(sorted(self._items))
            raise KeyError(
                f"Unknown {self.kind} {name!r}. Registered: {known}"
            ) from None

    def build(self, name: str, /, *args: Any, **kwargs: Any) -> Any:
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def names(self) -> list[str]:
        return sorted(self._items)


TRANSFORMS = Registry("transform")
LOSSES = Registry("loss")
SCHEDULES = Registry("lr-schedule")
TRAINERS = Registry("trainer")
NETWORKS = Registry("network")
