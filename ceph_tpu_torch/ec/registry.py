"""ErasureCodePluginRegistry — plugin discovery and instantiation.

Port copy of ceph_tpu/ec/registry.py, kept here so the port imports nothing
of the JAX package.  ``factory`` also takes the torch device of the codec.

Mirrors reference src/erasure-code/ErasureCodePlugin.h:45-79 (singleton with
factory/add/get/load/preload) with Python idioms: instead of dlopening
``libec_<name>.so`` and resolving the ``__erasure_code_init`` C entry point
(ErasureCodePlugin.h:24-27), ``load`` imports ``ceph_tpu_torch.ec.plugins.<name>``
(or a module given by a dotted path) and calls its
``__erasure_code_init__(registry)`` function. Thread-safe like the original
(mutex-guarded; the dlclose concern does not apply).
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable, Mapping

from ceph_tpu_torch.ec.interface import ErasureCodeInterface

# A factory takes the profile and the torch device the codec runs on
# (None: CUDA, raising when there is none).
PluginFactory = Callable[..., ErasureCodeInterface]

ENTRY_POINT = "__erasure_code_init__"
DEFAULT_PLUGIN_PACKAGE = "ceph_tpu_torch.ec.plugins"

# Built-in plugin set, preloaded like osd_erasure_code_plugins defaults.
BUILTIN_PLUGINS = ("jax_rs", "xor", "lrc", "shec", "clay")


class ErasureCodePlugin:
    """A named factory. Subclass or wrap a callable."""

    def __init__(self, name: str, factory: PluginFactory):
        self.name = name
        self._factory = factory

    def factory(self, profile: Mapping[str, str],
                device=None) -> ErasureCodeInterface:
        instance = self._factory(profile, device=device)
        # Constructors taking a profile already ran init (the common
        # pattern here); only init again if the instance is still blank,
        # avoiding a full re-parse (LRC rebuilds every inner codec).
        if not instance.get_profile():
            instance.init(profile)
        return instance


class ErasureCodePluginRegistry:
    """Process-wide plugin registry (singleton via ``instance()``)."""

    _singleton: "ErasureCodePluginRegistry | None" = None
    _singleton_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._load_lock = threading.Lock()  # serialises import+register
        self._plugins: dict[str, ErasureCodePlugin] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._singleton_lock:
            if cls._singleton is None:
                cls._singleton = cls()
        return cls._singleton

    def add(self, name: str, plugin: ErasureCodePlugin | PluginFactory) -> None:
        if not isinstance(plugin, ErasureCodePlugin):
            plugin = ErasureCodePlugin(name, plugin)
        with self._lock:
            if name in self._plugins:
                raise KeyError(f"erasure code plugin {name!r} already registered")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def load(self, name: str, module_path: str | None = None) -> ErasureCodePlugin:
        """Import the plugin module and run its entry point.

        ``module_path`` overrides the default package location, playing the
        role of the plugin directory argument in the reference loader."""
        with self._load_lock:
            plugin = self.get(name)
            if plugin is not None:
                return plugin
            path = module_path or f"{DEFAULT_PLUGIN_PACKAGE}.{name}"
            try:
                module = importlib.import_module(path)
            except ImportError as e:
                raise ImportError(f"erasure code plugin {name!r}: {e}") from e
            entry = getattr(module, ENTRY_POINT, None)
            if entry is None:
                raise ImportError(
                    f"plugin module {path} has no {ENTRY_POINT} entry point"
                )
            entry(self)
            plugin = self.get(name)
            if plugin is None:
                raise ImportError(
                    f"plugin module {path} entry point did not register {name!r}"
                )
            return plugin

    def preload(self, names=BUILTIN_PLUGINS) -> None:
        for name in names:
            self.load(name)

    def factory(
        self, name: str, profile: Mapping[str, str], device=None
    ) -> ErasureCodeInterface:
        """Load-if-needed and instantiate — the main entry point, mirroring
        ErasureCodePluginRegistry::factory.  ``device`` is the torch device
        the codec runs on: CUDA when None (raising when there is none),
        ``"cpu"`` only when asked for."""
        return self.load(name).factory(profile, device=device)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
