"""Explicit name -> constructor registries, copied from
``ich_tpu/utils/config.py`` (``Registry`` and the registries the 2.5D
training path resolves; importing ``ich_tpu`` imports jax). The names are
the reference's, so the JSON configs resolve unchanged."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator


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
