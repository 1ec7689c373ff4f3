"""Where `import tomojax` puts JAX's persistent compilation cache."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins where it is set (JAX reads it, the
    package sets nothing); otherwise the cache is <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if from_env:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c",
         "import tomojax, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want
