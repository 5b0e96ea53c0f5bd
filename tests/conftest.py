"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
exercised without accelerator hardware (see SURVEY.md §4.3).  The config is
updated through the jax API as well as the environment, since backends have
not been initialised yet at conftest time.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

from storage_tpu.utils.compile_cache import use_compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: the fast suite is compile-bound, and most
# programs recur run-to-run.  $JAX_COMPILATION_CACHE_DIR when set, else
# .jax_test_cache/ in the checkout.
use_compile_cache(os.path.join(os.path.dirname(__file__), os.pardir, ".jax_test_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
# XLA:CPU's AOT loader logs a (harmless, multi-KB) machine-feature mismatch
# error for cache hits on some hosts — drown it out or the suite output
# becomes unreadable.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
