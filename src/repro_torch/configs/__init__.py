"""Architecture registry: --arch <id> resolution for launchers/benchmarks.

Configs are AUTO-DISCOVERED: every module in this package that exposes a
module-level `CONFIG: ArchConfig` is registered.  Adding a new architecture
is one new file -- no hand-kept import list to forget, and the test suite
parametrizes over whatever is found here, so a new config cannot silently
skip coverage.
"""
import importlib
import pkgutil

from .base import ArchConfig, InputShape, SHAPES, applicable_shapes

ARCHS: dict[str, ArchConfig] = {}
CONFIG_MODULES: dict[str, str] = {}   # arch name -> defining module

for _info in sorted(pkgutil.iter_modules(__path__), key=lambda i: i.name):
    if _info.name == "base" or _info.name.startswith("_"):
        continue
    _mod = importlib.import_module(f"{__name__}.{_info.name}")
    _cfg = getattr(_mod, "CONFIG", None)
    if _cfg is None:
        continue
    if not isinstance(_cfg, ArchConfig):
        raise TypeError(f"{_mod.__name__}.CONFIG is not an ArchConfig")
    if _cfg.name in ARCHS:
        raise ValueError(f"duplicate arch name {_cfg.name!r} "
                         f"({CONFIG_MODULES[_cfg.name]} vs {_mod.__name__})")
    ARCHS[_cfg.name] = _cfg
    CONFIG_MODULES[_cfg.name] = _mod.__name__


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "InputShape", "SHAPES", "ARCHS", "CONFIG_MODULES",
           "get_config", "applicable_shapes"]
