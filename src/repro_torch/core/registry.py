"""Name -> object registries backing the :mod:`repro_torch.api` façade.

Own copy of ``src/repro/core/registry.py`` for the port.  The façade
dispatches by *name* over two registries — layout strategies ("iris"
plus the paper's baselines) and execution backends ("numpy", "cuda",
"c") — so sweeps, benchmarks and comparisons iterate one table
instead of importing one function per layout family.  The registry is
deliberately tiny: insertion-ordered, no priorities, no entry points;
third-party strategies register by calling :meth:`Registry.register` at
import time.
"""
from __future__ import annotations

from typing import Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """Insertion-ordered name -> object table with helpful lookup errors.

    A failed :meth:`get` raises ``KeyError`` naming the registry kind and
    listing every registered name, so a typo'd ``strategy="irsi"`` is a
    one-glance fix rather than a stack-trace hunt.
    """

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._entries: dict[str, T] = {}

    def register(self, name: str, obj: T | None = None, *,
                 overwrite: bool = False):
        """Register ``obj`` under ``name``; decorator form when obj omitted.

        Re-registering an existing name raises unless ``overwrite=True``
        (guards against two plugins silently shadowing each other).
        """

        def _add(o: T) -> T:
            if not overwrite and name in self._entries:
                raise KeyError(
                    f"{self.kind} {name!r} is already registered; "
                    "pass overwrite=True to replace it"
                )
            self._entries[name] = o
            return o

        if obj is None:
            return _add
        return _add(obj)

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(repr(n) for n in self._entries) or "(none)"
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            ) from None

    def names(self) -> list[str]:
        return list(self._entries)

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {self.names()})"
