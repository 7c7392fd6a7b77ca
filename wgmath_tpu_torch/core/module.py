"""Kernel-module registry: composable device functions + entry points.

Counterpart of ``wgmath_tpu/core/module.py`` (the reference's shader
composition stack): a :class:`KernelModule` declares its name, its
dependencies, the *composable* functions it provides (plain Python callables
on tensors) and its *entry points*.

- :func:`compose` — depth-first dependency walk with by-name dedup, returning
  a flat namespace; later (more derived) modules shadow earlier ones.
- :func:`flat_source` — concatenated Python source of every function the
  composed module provides.
- :func:`compile_check` — eager PyTorch has nothing to lower, so "compiles
  for this backend" means: run every entry point once on its example
  arguments on the resolved device. On the card that builds and launches the
  module's hand-written kernels; on the CPU it runs their plain versions.
- :func:`reload` — re-import the defining Python module and forget the
  loaded kernel libraries, so an edited ``.cu`` (new hash, new ``.so``) or
  an edited Python kernel is picked up without restarting the process.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import os
import sys
import threading
from typing import Any, Callable, Iterable, Mapping

import torch

from wgmath_tpu_torch.core import cuda_build
from wgmath_tpu_torch.core.dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """A kernel entry point. ``example_args(device)`` returns concrete
    arguments on ``device``; only :func:`compile_check` calls it."""

    fn: Callable[..., Any]
    example_args: Callable[[torch.device], tuple] | None = None


@dataclasses.dataclass(frozen=True)
class KernelModule:
    name: str
    deps: tuple[str, ...] = ()
    provides: Mapping[str, Callable[..., Any]] = dataclasses.field(
        default_factory=dict)
    entries: Mapping[str, EntryPoint] = dataclasses.field(
        default_factory=dict)
    doc: str = ""

    def __post_init__(self):
        object.__setattr__(self, "provides", dict(self.provides))
        object.__setattr__(self, "entries", dict(self.entries))


_REGISTRY: dict[str, KernelModule] = {}
_DEFINING_PYMODULE: dict[str, str] = {}
_LOCK = threading.Lock()


def register_module(mod: KernelModule, *,
                    allow_replace: bool = False) -> KernelModule:
    """Register a module once by name.

    Registering again from the same defining Python module is idempotent
    (supports ``importlib.reload``); from another one it is an error unless
    ``allow_replace``.
    """
    frame = inspect.stack()[1]
    pymod = frame.frame.f_globals.get("__name__", "?")
    with _LOCK:
        if mod.name in _REGISTRY and not allow_replace:
            if _DEFINING_PYMODULE.get(mod.name) != pymod:
                raise ValueError(
                    f"kernel module {mod.name!r} already registered by "
                    f"{_DEFINING_PYMODULE.get(mod.name)!r}")
        _REGISTRY[mod.name] = mod
        _DEFINING_PYMODULE[mod.name] = pymod
    return mod


def get_module(name: str) -> KernelModule:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel module {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def all_modules() -> dict[str, KernelModule]:
    return dict(_REGISTRY)


def _walk_deps(name: str, seen: set[str], order: list[str]) -> None:
    if name in seen:
        return
    seen.add(name)
    for dep in get_module(name).deps:
        _walk_deps(dep, seen, order)
    order.append(name)


def dependency_order(name: str) -> list[str]:
    """Depth-first post-order over transitive deps, deduplicated by name."""
    seen: set[str] = set()
    order: list[str] = []
    _walk_deps(name, seen, order)
    return order


def compose(name: str) -> dict[str, Callable[..., Any]]:
    """Flat namespace of every function provided by ``name`` and its
    transitive deps."""
    ns: dict[str, Callable[..., Any]] = {}
    for mod_name in dependency_order(name):
        ns.update(get_module(mod_name).provides)
    return ns


def flat_source(name: str) -> str:
    """Concatenated Python source of the composed module."""
    chunks: list[str] = []
    for mod_name in dependency_order(name):
        chunks.append(f"# ===== module: {mod_name} =====")
        for fn_name, fn in get_module(mod_name).provides.items():
            try:
                chunks.append(inspect.getsource(fn))
            except (OSError, TypeError):
                chunks.append(f"# <source unavailable for {fn_name}>")
    return "\n".join(chunks)


def compile_check(name: str, *, entry: str | None = None,
                  device=None) -> list[str]:
    """Run every entry point of ``name`` once on its example arguments, on
    the card unless ``device`` says otherwise. Returns the entry names
    checked; raises on any build, launch or run failure."""
    dev = resolve_device(device)
    mod = get_module(name)
    items = mod.entries.items()
    if entry is not None:
        items = [(entry, mod.entries[entry])]
    checked = []
    for entry_name, ep in items:
        if ep.example_args is None:
            continue
        ep.fn(*ep.example_args(dev))
        if dev.type == "cuda":
            # a fault inside a kernel shows only at the next sync
            torch.cuda.synchronize(dev)
        checked.append(entry_name)
    return checked


def reload(name: str) -> KernelModule:
    """Re-import the Python module that defined ``name`` and forget the
    loaded kernel libraries. The re-imported module is expected to register
    itself again."""
    pymod_name = _DEFINING_PYMODULE.get(name)
    if pymod_name is None or pymod_name not in sys.modules:
        raise KeyError(
            f"module {name!r} has no reloadable defining python module")
    with _LOCK:
        _REGISTRY.pop(name, None)
    importlib.reload(sys.modules[pymod_name])
    cuda_build.drop_loaded()
    return get_module(name)


def _source_path(name: str) -> str | None:
    pymod = sys.modules.get(_DEFINING_PYMODULE.get(name, ""), None)
    return getattr(pymod, "__file__", None)


def watch_sources(names: Iterable[str]) -> dict[str, float]:
    """Snapshot mtimes of the files defining ``names``. Pair with
    :func:`needs_reload` in a dev loop."""
    stamps: dict[str, float] = {}
    for name in names:
        path = _source_path(name)
        if path:
            stamps[name] = os.stat(path).st_mtime
    return stamps


def needs_reload(stamps: dict[str, float]) -> list[str]:
    """Module names whose defining files changed since ``watch_sources``."""
    changed = []
    for name, old in stamps.items():
        path = _source_path(name)
        if path and os.stat(path).st_mtime > old:
            changed.append(name)
    return changed
