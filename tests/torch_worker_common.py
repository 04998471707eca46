"""How the port's CPU tests share a tier-1 worker with the JAX package's.

Tier-1 runs six pytest workers on a few cores, each taking whole test
files, the JAX package's beside the port's.  Two costs of the port's
parity tests are the workers' rather than the code's, and every port test
module that runs on the CPU takes both fixtures below::

    from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

    pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

* :func:`one_torch_thread`: torch's intra-op pool is as wide as the
  machine in every worker, and at these tests' sizes it costs more than it
  saves, contending with JAX's pools and the other workers.
* :func:`jax_compile_cache`: the JAX references build fresh facades and
  jitted functions test after test, and compile the same programs again;
  with JAX's persistent compilation cache on, a worker compiles each
  program once.  The cache holds compiled programs, not results.

Both are module-scoped and put the previous settings back after the
module, so the JAX package's own tests run as they would alone.
"""

import pytest
import torch

#: The worker's cache directory, made on first use (one per process).
_CACHE_DIR = None
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for the module; the caller's count
    comes back after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache, on for the module, in one
    directory a worker; every program is cached, however quick its
    compile.  The cache is dropped again after the module (JAX keeps the
    one it first opened for the process otherwise)."""
    global _CACHE_DIR
    import jax
    from jax._src import compilation_cache

    if _CACHE_DIR is None:
        _CACHE_DIR = str(tmp_path_factory.mktemp("jax_compile_cache"))
    before = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    jax.config.update(_CACHE_KEYS[0], _CACHE_DIR)
    jax.config.update(_CACHE_KEYS[1], 0.0)
    jax.config.update(_CACHE_KEYS[2], -1)
    compilation_cache.reset_cache()
    yield
    for k, v in before.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
