"""FIR / polyphase resampler kernel (K2) — XLA banded-matmul filters.

Replaces the reference-class liquid-dsp-style C/SIMD filter tier
(SURVEY.md §2.2-K2; mount empty, §0). The filters run as the block-banded
matmuls of kernels/conv_backend.py.

Numerics match golden.resample (same Kaiser-sinc prototype, same 'same'
alignment / group-delay handling), up to f32.
"""

from __future__ import annotations

import jax
import numpy as np

from . import conv_backend

# spec.filter_precision -> matmul precision of the filter band: 'exact' is
# HIGHEST (f32 products; the default, and what every bit-level correctness
# gate assumes); 'bf16' is Precision.DEFAULT, which on a GPU runs f32
# matmuls in TF32 (~1e-3 relative) — for EVM-grade callers only.
_PRECISIONS = {
    "exact": jax.lax.Precision.HIGHEST,
    "bf16": jax.lax.Precision.DEFAULT,
}


def polyphase_interp(x: jax.Array, l: int, taps: np.ndarray,
                     precision: str = "exact") -> jax.Array:
    """L-fold polyphase interpolation, [..., n] -> [..., n*l].

    taps: prototype low-pass (host numpy; gain-l compensation applied
    internally). Twin of golden.resample.resample(x, l, 1).
    """
    return conv_backend.polyphase_interp_xla(
        x, l, taps, precision=_PRECISIONS[precision])


def polyphase_decim(x: jax.Array, m: int, taps: np.ndarray,
                    precision: str = "exact") -> jax.Array:
    """M-fold polyphase decimation, [..., n*m] -> [..., n].

    Twin of golden.resample.resample(x, 1, m).
    """
    return conv_backend.polyphase_decim_xla(
        x, m, taps, precision=_PRECISIONS[precision])
