"""Entry-point plumbing: the persistent compile cache location, and the
main path importing with none of the packages the card's machine lacks."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CACHE_PROBE = (
    "import jax; from dh3d_tpu.compile_cache import enable_compile_cache; "
    "print(enable_compile_cache()); print(jax.config.jax_compilation_cache_dir)"
)


def _python(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_compile_cache_follows_env_var(tmp_path):
    used, configured = _python(CACHE_PROBE,
                               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert used == configured == str(tmp_path)


def test_compile_cache_default_is_fixed_in_repo():
    code = ("import os; os.environ.pop('JAX_COMPILATION_CACHE_DIR', None); "
            + CACHE_PROBE)
    used, configured = _python(code)
    assert used == configured == os.path.join(REPO, ".jax_cache")


BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax", "sklearn", "tensorflow"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import importlib
importlib.import_module({module!r})
print("imported")
"""


@pytest.mark.parametrize("module", ["dh3d_tpu.nn", "dh3d_tpu.train",
                                    "dh3d_tpu.eval", "train",
                                    "chip_smoke", "bench"])
def test_imports_without_unavailable_packages(module):
    assert _python(BLOCKER.format(module=module)) == ["imported"]
