"""Lazy module loading (counterpart of `spateo_tpu._lazy_loader`; reference
spateo/_lazy_loader.py:14,70). Host code, copied: a module or attribute
bound with these is imported on first attribute access.
"""

from __future__ import annotations

import importlib
import types
from typing import Optional


class LazyLoader(types.ModuleType):
    """Lazily import a module on first attribute access."""

    def __init__(self, local_name: str, parent_module_globals: dict, name: str):
        self._local_name = local_name
        self._parent_module_globals = parent_module_globals
        super().__init__(name)

    def _load(self):
        module = importlib.import_module(self.__name__)
        self._parent_module_globals[self._local_name] = module
        self.__dict__.update(module.__dict__)
        return module

    def __getattr__(self, item):
        module = self._load()
        return getattr(module, item)

    def __dir__(self):
        module = self._load()
        return dir(module)


class LazyAttribute:
    """Defer an attribute (e.g. a class) of a lazily-imported module."""

    def __init__(self, module_name: str, attr: str):
        self._module_name = module_name
        self._attr = attr
        self._value: Optional[object] = None

    def _load(self):
        if self._value is None:
            module = importlib.import_module(self._module_name)
            self._value = getattr(module, self._attr)
        return self._value

    def __call__(self, *args, **kwargs):
        return self._load()(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._load(), item)


def create_lazy_module(name: str, parent_module_globals: dict) -> LazyLoader:
    """Factory for a module lazy-loader (parity: reference
    _lazy_loader.py:129)."""
    return LazyLoader(name.rsplit(".", 1)[-1], parent_module_globals, name)


def create_lazy_attribute(import_path: str, attribute_name: str = None) -> LazyAttribute:
    """Factory for an attribute lazy-loader (parity: reference
    _lazy_loader.py:148). With no `attribute_name`, the last dotted
    component of `import_path` is the attribute."""
    if attribute_name is None:
        import_path, attribute_name = import_path.rsplit(".", 1)
    return LazyAttribute(import_path, attribute_name)
