"""Frame-parallel (data-parallel) sharding of the batched TX/RX pipelines.

SURVEY.md §2.3 row 'DP -> frame parallel': the frame/batch axis is sharded
over the 'frame' mesh axis with NamedSharding; the per-frame chain needs no
cross-talk, so the only collective is a psum of scalar metrics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.spec import WaveformSpec
from ..pipeline import rx as RXP
from ..pipeline import tx as TXP


def tx_frames_sharded(spec: WaveformSpec, mesh: jax.sharding.Mesh):
    """Returns jitted fn: payloads [B, bits] -> frames [B, frame_len_radio],
    B sharded over the 'frame' mesh axis."""
    in_s = NamedSharding(mesh, P("frame", None))
    out_s = NamedSharding(mesh, P("frame", None))
    return jax.jit(functools.partial(TXP._tx_step, spec),
                   in_shardings=in_s, out_shardings=out_s)


def rx_frames_sharded(spec: WaveformSpec, mesh: jax.sharding.Mesh,
                      shift: int = 0):
    """Returns jitted fn: frames [B, len] -> result dict, frame-sharded.

    The whole per-frame chain runs inside shard_map, so every device
    decodes its own frames (the fused Viterbi kernel included: a custom
    kernel is opaque to XLA's automatic partitioner). Scalar health
    metrics (frames decoded, mean EVM) are psum-reduced over the mesh so
    every host sees global counters (SURVEY.md §5.5).
    """
    def body(frames):
        out = RXP._rx_aligned(spec, shift, True, frames)
        n_ok = jax.lax.psum(jnp.sum(out["crc_ok"].astype(jnp.int32)), "frame")
        evm = jax.lax.psum(jnp.sum(out["evm_db"]), "frame")
        return out, n_ok, evm

    def step(frames):
        out, n_ok, evm_sum = jax.shard_map(
            body, mesh=mesh, in_specs=P("frame"),
            out_specs=(P("frame"), P(), P()), check_vma=False)(frames)
        out["n_ok_global"] = n_ok
        out["mean_evm_global"] = evm_sum / frames.shape[0]
        return out

    in_s = NamedSharding(mesh, P("frame", None))
    return jax.jit(step, in_shardings=in_s)
