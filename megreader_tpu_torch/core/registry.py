"""Component registry: name -> class, the backbone of the YAML configs.

The port's own copy of ``megreader_tpu/core/registry.py``: a YAML node with a
``class:`` key is built by the class registered under that name. The port
keeps a registry of its own (``COMPONENTS`` here), filled by
``megreader_tpu_torch/all.py``; it never touches the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional


class Registry:
    """A string -> class map with decorator-based registration."""

    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, type] = {}

    def register(self, cls: Optional[type] = None, *, name: Optional[str] = None):
        def _do(c: type) -> type:
            key = name or c.__name__
            if key in self._map and self._map[key] is not c:
                raise KeyError(f"{self.name}: duplicate registration for {key!r}")
            self._map[key] = c
            return c

        if cls is None:
            return _do
        return _do(cls)

    def get(self, key: str) -> type:
        try:
            return self._map[key]
        except KeyError:
            known = ", ".join(sorted(self._map)) or "<empty>"
            raise KeyError(
                f"{self.name}: unknown component {key!r}. Known: {known}"
            ) from None

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def items(self):
        return self._map.items()


#: One global namespace, as in the JAX package: names are unique.
COMPONENTS = Registry("components")

register = COMPONENTS.register


def resolve(name: str) -> type:
    return COMPONENTS.get(name)
