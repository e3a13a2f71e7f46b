"""Lazy re-exports for the port's package ``__init__`` files.

The JAX package's subpackages import their public names eagerly. Here a
package names them in a table and each is imported at its first use
(a module-level ``__getattr__``, PEP 562), so that importing a host-only
module such as ``geo.boxes`` or ``data.filenames`` pulls in neither torch
nor pandas through its package, and a serving process's import time does
not grow with the package surface.
"""

from __future__ import annotations

import importlib


def lazy_exports(namespace: dict, table: dict) -> None:
    """Install ``__getattr__``, ``__dir__`` and ``__all__`` in a package's
    ``namespace`` (its ``globals()``). ``table`` maps a submodule name,
    relative to the package, to the names the package re-exports from it.
    A resolved name is cached in the namespace.

    A name that is also its submodule's name (``ops.nms``, ``ops.letterbox``)
    resolves to the submodule, whichever is imported first: the port's
    code imports those modules by that name. (The JAX package's eager
    import rebinds them to the functions, ``ops.nms.nms`` and
    ``ops.letterbox.letterbox`` here.)"""
    package = namespace["__name__"]
    where = {name: module for module, names in table.items() for name in names}

    def __getattr__(name: str):
        module = where.get(name)
        if module is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = importlib.import_module(f"{package}.{module}")
        if name != module:
            value = getattr(value, name)
        namespace[name] = value
        return value

    def __dir__():
        return sorted(set(namespace) | set(where))

    namespace.update(__getattr__=__getattr__, __dir__=__dir__, __all__=sorted(where))
