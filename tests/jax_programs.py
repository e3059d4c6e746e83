"""A fixture that drops JAX's compiled programs when a test module ends.

Each compiled XLA program holds memory mappings of its own, and the port's
JAX-comparing test modules compile thousands of them (the interpret-mode
Pallas kernels, the duration-arc lattices). A test worker that runs several
of them and then other JAX-heavy modules can reach the kernel's limit on
mappings a process (vm.max_map_count, 65530 by default), where the next
compile fails with a segmentation fault. A module opts in with

    from jax_programs import release_compiled_programs  # noqa: F401
"""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    yield
    jax.clear_caches()
