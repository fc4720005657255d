"""Lazy jax loading: host-path CLI runs never pay `import jax`.

`import jax` costs seconds of interpreter start-up — more than the
entire runtime of most host-path tool invocations. The bin/ launchers
therefore start CPython with ``-S`` (no site initialization) and every
module that only *might* need jax imports the proxies below instead of
the real thing:

    from genometester4_tpu.utils.lazyjax import jax, jnp, jit

Attribute access on a proxy performs the real import (and points JAX's
persistent compilation cache at its directory, see
``compile_cache_dir``) and caches the resolved attribute on the proxy,
so all later accesses are one instance-dict hit.  ``jit(...)`` replaces
module-level ``@partial(jax.jit, ...)`` decorators: it returns a wrapper
that defers the real ``jax.jit`` call until the first invocation (or
first attribute access, e.g. ``.lower()``), keeping kernel modules
importable in milliseconds.

When the process was started normally (tests, library users), jax is
already imported by the time any proxy resolves, and the proxies are
transparent pass-throughs.
"""

from __future__ import annotations

import importlib
import os
import sys

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_cache_configured = False


def compile_cache_dir() -> str:
    """Directory of JAX's persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads the variable
    itself); otherwise the fixed ``<checkout>/.jax_cache``, so that
    every tool process of a checkout reuses what another compiled (the
    path is part of the cache key, so it must not move)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def configure_compile_cache(jax_mod) -> None:
    """Point ``jax_mod``'s persistent compilation cache at
    ``compile_cache_dir()``. Sets nothing when the environment variable
    is set or the process already chose a directory."""
    global _cache_configured
    _cache_configured = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if jax_mod.config.jax_compilation_cache_dir:
        return
    jax_mod.config.update("jax_compilation_cache_dir", compile_cache_dir())


def ensure_jax():
    """Import jax (once) with the compilation cache configured."""
    m = sys.modules.get("jax")
    if m is None:
        m = importlib.import_module("jax")
    if not _cache_configured:
        configure_compile_cache(m)
    return m


class _LazyModule:
    """Module proxy: first attribute access imports and caches."""

    def __init__(self, name: str):
        object.__setattr__(self, "_lazy_name", name)

    def __getattr__(self, attr):
        if attr.startswith("__") and attr.endswith("__"):
            # dunder probes (inspect, copy, pickling) must not trigger
            # the jax import; real modules lack most of them anyway.
            raise AttributeError(attr)
        ensure_jax()
        mod = importlib.import_module(self._lazy_name)
        val = getattr(mod, attr)
        self.__dict__[attr] = val
        return val

    def __repr__(self):
        return f"<lazy module {self._lazy_name!r}>"


class LazyJitted:
    """``jax.jit`` applied at first call instead of decoration time."""

    def __init__(self, fn, kwargs):
        self._fn = fn
        self._kw = kwargs
        self._jitted = None
        self.__name__ = getattr(fn, "__name__", "jitted")
        self.__doc__ = getattr(fn, "__doc__", None)
        self.__wrapped__ = fn

    def _resolve(self):
        j = self._jitted
        if j is None:
            j = self._jitted = ensure_jax().jit(self._fn, **self._kw)
        return j

    def __call__(self, *args, **kwargs):
        return self._resolve()(*args, **kwargs)

    def __getattr__(self, attr):  # .lower(), .trace(), ...
        return getattr(self._resolve(), attr)


def jit(fn=None, **kwargs):
    """Drop-in for ``jax.jit`` / ``partial(jax.jit, ...)`` as a
    module-level decorator, without importing jax at decoration time."""
    if fn is not None:
        return LazyJitted(fn, kwargs)
    return lambda f: LazyJitted(f, kwargs)


jax = _LazyModule("jax")
jnp = _LazyModule("jax.numpy")
lax = _LazyModule("jax.lax")
jax_sharding = _LazyModule("jax.sharding")
