"""Placement rule, compile-cache location, gmer_caller's route and the
chip smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _sites():
    from genometester4_tpu.pipelines import listcompare, listmaker
    from genometester4_tpu.utils.backend import prefer_host
    return {
        "prefer_host": lambda: "host" if prefer_host() else "device",
        "count_impl": listmaker._count_impl,
        "setops_impl": listcompare._setops_impl,
    }


@pytest.mark.parametrize("site", ["prefer_host", "count_impl",
                                  "setops_impl"])
@pytest.mark.parametrize("backend,expect", [("cpu", "host"),
                                            ("gpu", "device")])
def test_placement_rule(monkeypatch, site, backend, expect):
    """Host engine when JAX's backend is the CPU, device path on any
    other backend — at every placement site."""
    from genometester4_tpu.utils import backend as backend_mod

    for var in ("GT4_TPU_COUNT_IMPL", "GT4_TPU_SETOPS_IMPL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "")
    monkeypatch.setattr(backend_mod.jax, "default_backend", lambda: backend)
    assert _sites()[site]() == expect


def test_placement_answers_from_env_without_jax(monkeypatch):
    """JAX_PLATFORMS=cpu answers "host" before jax would be asked."""
    from genometester4_tpu.utils import backend as backend_mod

    def boom():
        raise AssertionError("jax consulted")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(backend_mod.jax, "default_backend", boom)
    assert backend_mod.prefer_host()


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and is left for JAX to read;
    otherwise the cache sits at the fixed <checkout>/.jax_cache."""
    from genometester4_tpu.utils import lazyjax

    class FakeConfig:
        jax_compilation_cache_dir = None
        updates = {}

        def update(self, key, value):
            self.updates[key] = value

    class FakeJax:
        config = FakeConfig()

    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert lazyjax.compile_cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert lazyjax.compile_cache_dir() == str(REPO / ".jax_cache")
    lazyjax.configure_compile_cache(FakeJax)
    if env_set:
        assert FakeJax.config.updates == {}
    else:
        assert FakeJax.config.updates == {
            "jax_compilation_cache_dir": str(REPO / ".jax_cache")}


@pytest.mark.parametrize("impl,expect", [(None, "native"),
                                         ("device", "device")])
def test_gmer_caller_route(monkeypatch, impl, expect):
    """gmer_caller's posteriors come from the exact native path on every
    backend; the float32 device twin only under
    GT4_TPU_CALLER_IMPL=device."""
    from genometester4_tpu.models import fastgt_native
    from genometester4_tpu.pipelines import gmercall
    from genometester4_tpu.utils import backend as backend_mod

    monkeypatch.setenv("JAX_PLATFORMS", "")
    monkeypatch.setattr(backend_mod.jax, "default_backend", lambda: "gpu")
    if impl is None:
        monkeypatch.delenv("GT4_TPU_CALLER_IMPL", raising=False)
    else:
        monkeypatch.setenv("GT4_TPU_CALLER_IMPL", impl)
    fn = gmercall._genotype_batch_impl()
    if expect == "native":
        assert fn is fastgt_native.genotype_batch
    else:
        from genometester4_tpu.models.genotype import genotype_batch_device
        assert fn is genotype_batch_device


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """Without a GPU (or without the rest of the repository) the smoke
    script exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
