"""Test harness config: force JAX onto CPU with 8 virtual devices.

GPU runs happen through chip_smoke.py and bench.py; the tests exercise the
same code paths (including shard_map/ppermute/psum semantics) on a virtual
CPU mesh (SURVEY.md §4 "Distributed without a pod"). The fused Viterbi
kernel runs here through the Pallas interpreter, which tests request
explicitly.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
