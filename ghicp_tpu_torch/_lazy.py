"""Package exports resolved at their first use."""
from __future__ import annotations

import importlib


def lazy_exports(package: str, modules: dict):
    """(``__all__``, ``__getattr__``) for ``package``, whose public names
    live in its modules (``modules``: module -> names).  A name is imported
    at its first use, so importing the package imports none of its
    modules: the subpackages' modules import each other's, and eager
    re-exports would close import cycles."""
    owner = {name: mod for mod, names in modules.items() for name in names}

    def __getattr__(name: str):
        if name not in owner:
            raise AttributeError(f"module {package!r} has no attribute "
                                 f"{name!r}")
        module = importlib.import_module(f"{package}.{owner[name]}")
        return getattr(module, name)

    return list(owner), __getattr__
