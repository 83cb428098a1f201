"""Shared bench helpers: synthetic capture construction.

Used by bench.py (headline), chip_smoke.py and bench/stages.py so every
harness measures the same waveform.
"""

from __future__ import annotations

import numpy as np


_TX_CACHE: dict = {}


def _tx_frames(spec, payloads: np.ndarray) -> np.ndarray:
    """Modulate frames with the JAX TxPipeline on the default device.

    Far faster than the float64 golden modulator for large captures and
    bit-equivalent at capture SNRs (TX chains are equality-tested in
    tests/unit)."""
    from ofdm_uhd_tpu.pipeline import TxPipeline

    if spec not in _TX_CACHE:
        _TX_CACHE[spec] = TxPipeline(spec)
    return np.asarray(_TX_CACHE[spec](payloads))


def build_capture(spec, n_frames: int, gap: int, seed: int = 0,
                  snr_db: float = 28.0, cfo: float = 0.8,
                  phase_noise_std: float = 2e-4, timing_offset: int = 100,
                  tx: str = "jax"):
    """Multi-frame capture with channel impairments.

    Returns (capture complex64 [n], payloads uint8 [n_frames, bits]).
    tx='jax' modulates with the TxPipeline (fast); tx='golden' uses the
    float64 golden modulator (the accuracy oracle).
    """
    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.channel import make_capture

    rng = np.random.default_rng(seed)
    payloads = rng.integers(
        0, 2, (n_frames, spec.payload_bits_per_frame)).astype(np.uint8)
    if tx == "jax":
        frames = _tx_frames(spec, payloads)
    else:
        from ofdm_uhd_tpu.golden import GoldenModem
        gm = GoldenModem(spec)
        frames = np.stack([gm.modulate_frame(p) for p in payloads])
    ch = ChannelSpec(snr_db=snr_db, cfo=cfo, phase_noise_std=phase_noise_std,
                     timing_offset=timing_offset)
    cap = make_capture(frames, ch, spec.n_sc, gap=gap, seed=seed)
    return cap.astype(np.complex64), payloads


def build_captures(spec, n_caps: int, n_frames: int, gap: int):
    """[C, n] stacked distinct captures (seeds 0..C-1) + [C, F, bits]
    payloads."""
    caps, pays = [], []
    for c in range(n_caps):
        cap, pay = build_capture(spec, n_frames, gap, seed=c)
        caps.append(cap)
        pays.append(pay)
    return np.stack(caps), np.stack(pays)


def to_sc16(caps: np.ndarray) -> np.ndarray:
    """[C, n] complex -> [2, C, n] int16 full-scale planes (UHD sc16)."""
    planes = np.stack([caps.real, caps.imag])
    scale = 32767.0 / np.max(np.abs(planes))
    return np.round(planes * scale).astype(np.int16)
