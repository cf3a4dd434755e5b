"""Test harness: force an 8-device virtual CPU mesh so multi-device
sharding tests run anywhere (SURVEY.md §4: pixel tiles are embarrassingly
parallel, so the sharded run must match the one-device run).  The suite
runs on the CPU backend; GPU kernels run there in Pallas interpret mode."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# keep the suite hermetic: no persistent compilation cache (XLA:CPU's AOT
# loader also warns noisily about pseudo machine features on cache hits)
jax.config.update("jax_enable_compilation_cache", False)


def pytest_collection_modifyitems(session, config, items):
    """XLA:CPU segfaults (hard crash in backend_compile_and_load) while
    compiling test_traversal's lax.while_loop program when it runs LATE in
    the full suite — after hundreds of in-process CPU compilations — but
    is stable standalone, in any shorter sub-sequence, and early in the
    order (reproduced 3x on 2026-08-20, same stack each time).  Until the
    upstream compiler bug is addressed, run that file first; the stable
    sort leaves all other ordering untouched."""
    items.sort(key=lambda it: 0 if "test_traversal.py" in str(it.fspath) else 1)
