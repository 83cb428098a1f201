"""ofdm_uhd_tpu — an OFDM modem framework in JAX, run on an NVIDIA GPU.

Brand-new design (NOT a port) with the capabilities of the reference
`rubiruchi/ofdm_uhd` class of C++/UHD OFDM transceivers, built as array
programs: JAX/XLA for the signal chain, one hand-written Pallas kernel
(Triton route) for the Viterbi decoder, `shard_map` + collectives for
multi-device scaling, and file/stream sample sources in place of UHD
radio I/O.

Layer map (see SURVEY.md §1.2):
  core/      specs, numerology, stream state, compile cache
  golden/    float64 NumPy oracle chain (accuracy reference)
  phy/       pure-JAX PHY blocks (scramble, FEC, QAM, frame, chanest, sync, ...)
  kernels/   XLA kernels (FFT, FIR/polyphase, S&C correlator) + the fused
             Viterbi kernel
  channel/   impairment models (AWGN, multipath, CFO, phase noise)
  io/        capture file / stream sample sources and sinks
  pipeline/  jitted TX/RX pipelines, streaming loop
  shard/     mesh, shard_map wrappers, halo exchange, distributed init
  cli/       command-line entry points (tx, rx, loopback, bench, pod_rx)
"""

__version__ = "0.1.0"

# Exact matmul/conv numerics by default. The chain moves symbols between
# bin orderings, depunctures, checks CRCs and searches integer CFO with
# one-hot f32 matmuls that are bit-exact only when f32 products are kept
# whole; a GPU's default f32 matmul precision runs them in TF32, which
# keeps ~10 mantissa bits and would round them (and the FIR filters)
# to ~1e-3. Opt out (or pick another level) via OFDM_MATMUL_PRECISION.
import os as _os

import jax as _jax

_jax.config.update("jax_default_matmul_precision",
                   _os.environ.get("OFDM_MATMUL_PRECISION", "highest"))
