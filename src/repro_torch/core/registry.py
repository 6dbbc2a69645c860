"""Shared warn-on-collision registry.

One implementation of the register/unregister/available semantics every
repo registry promises (see docs/api.md): registering an existing name
with a *different* value warns (``replace=True`` silences), same-value
re-registration is silent, and lookups fail with the available names.
Used by the experiment registry and the host-layer registries; the
simulation/pressure-backend registries in :mod:`repro_torch.core.device`
keep a bare-dict form with identical observable semantics.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional


class Registry:
    """Name -> value map with collision warnings and decorator support."""

    def __init__(self, what: str):
        self.what = what
        self._entries: Dict[str, object] = {}

    def register(self, name: str, fn: Optional[object] = None, *,
                 replace: bool = False):
        def _do(f):
            if not replace and name in self._entries \
                    and self._entries[name] is not f:
                warnings.warn(
                    f"{self.what} {name!r} is already registered; replacing "
                    f"it. Pass replace=True to silence this warning.",
                    RuntimeWarning, stacklevel=3)
            self._entries[name] = f
            return f
        return _do(fn) if fn is not None else _do

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str):
        if name not in self._entries:
            raise KeyError(f"unknown {self.what} {name!r}; available: "
                           f"{self.available()}")
        return self._entries[name]

    def available(self) -> tuple:
        return tuple(sorted(self._entries))

    # -- mapping protocol (read-only) ----------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str):
        return self._entries[name]

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def values(self):
        return self._entries.values()

    def items(self):
        return self._entries.items()
