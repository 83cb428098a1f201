"""Batched TX pipeline: one fused jitted graph per spec.

Target call stack (SURVEY.md §3.5): scramble -> FEC -> interleave -> QAM ->
frame build -> IFFT+CP -> polyphase interp to radio rate. Replaces the
reference-class ofdm_tx main loop (§3.2; mount empty, §0), batched over
frames so the whole TX is a handful of large array ops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.spec import WaveformSpec, TAIL_BITS
from ..kernels import fir as K2
from ..phy import bits as PB
from ..phy import frame as PF
from ..phy import qam as PQ
from ..phy import tables as T


class TxPipeline:
    """payloads [B, payload_bits_per_frame] -> frames [B, frame_len_radio]."""

    def __init__(self, spec: WaveformSpec):
        self.spec = spec
        self._step = jax.jit(functools.partial(_tx_step, spec))

    def encode(self, payloads: jax.Array) -> jax.Array:
        """payloads -> interleaved coded bits [B, coded_bits_per_frame]."""
        return _encode(self.spec, payloads)

    def __call__(self, payloads: jax.Array) -> jax.Array:
        """Returns frames [B, frame_len_radio] complex64."""
        return self._step(payloads)


def _encode(spec: WaveformSpec, payloads: jax.Array) -> jax.Array:
    crc = PB.crc32(payloads)
    body = PB.scramble(jnp.concatenate([payloads.astype(jnp.uint8), crc], axis=-1))
    tail = jnp.zeros(body.shape[:-1] + (TAIL_BITS,), dtype=jnp.uint8)
    coded = PB.conv_encode(jnp.concatenate([body, tail], axis=-1))
    coded = PB.puncture(coded, spec.fec_rate)
    return PB.interleave(coded, spec.coded_bits_per_sym)


def _tx_step(spec: WaveformSpec, payloads: jax.Array) -> jax.Array:
    coded = _encode(spec, payloads)
    syms = PQ.qam_map(coded, spec.modulation)
    data = syms.reshape(-1, spec.n_data_syms, spec.n_data_sc)
    grid = PF.build_grid(spec, data)
    frames = PF.ofdm_modulate(spec, grid)
    l, m = spec.resample_l, spec.resample_m
    if l != 1 or m != 1:
        taps = T.resample_filter(l, m)
        if l > 1:
            frames = K2.polyphase_interp(frames, l, taps,
                                         precision=spec.filter_precision)
        if m > 1:
            frames = K2.polyphase_decim(frames, m, taps,
                                        precision=spec.filter_precision)
    return frames
