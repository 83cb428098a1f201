"""Worker for the 2-process jax.distributed CPU test (SURVEY.md §4).

Each process owns 4 virtual CPU devices; the global mesh spans 8 devices
across 2 processes — the same code path a multi-host GPU cluster runs
(jax.distributed.initialize + global mesh + ppermute/psum across hosts).
"""

import os
import sys

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)

import numpy as np
import zlib

from ofdm_uhd_tpu.core.spec import config, ChannelSpec
from ofdm_uhd_tpu.channel import make_capture
from ofdm_uhd_tpu.golden import GoldenModem
from ofdm_uhd_tpu.pipeline.stream import StreamRx
from ofdm_uhd_tpu.shard.mesh import make_mesh

assert jax.process_count() == nproc
assert len(jax.devices()) == 4 * nproc

spec = config("c1")  # small frames -> fast CPU test
rng = np.random.default_rng(7)
gm = GoldenModem(spec)
payloads = rng.integers(0, 2, (5, spec.payload_bits_per_frame)).astype(np.uint8)
frames = np.stack([gm.modulate_frame(p) for p in payloads])
cap = make_capture(frames, ChannelSpec(snr_db=25.0, cfo=0.2,
                                       timing_offset=111),
                   spec.n_sc, gap=150, seed=5).astype(np.complex64)

mesh = make_mesh(1, 4 * nproc)
rx = StreamRx(spec, mesh=mesh)
got = rx.process(cap) + rx.flush()

ok = (len(got) == 5
      and all(g.crc_ok for g in got)
      and all(np.array_equal(g.payload, p) for g, p in zip(got, payloads)))
digest = zlib.crc32(b"".join(np.asarray(g.payload).tobytes() for g in got))
print(f"WORKER {pid} RESULT ok={ok} n={len(got)} "
      f"starts={[g.start for g in got]} digest={digest}", flush=True)
