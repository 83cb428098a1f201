"""Batched FFT/IFFT kernel (K1): XLA's FFT (cuFFT on a GPU).

Replaces the reference-class FFTW dependency (SURVEY.md §2.2-K1; mount
empty, §0). Orthonormal scaling throughout (matches golden.modem).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fft(x: jax.Array) -> jax.Array:
    """N-point FFT along the last axis, norm='ortho'."""
    return jnp.fft.fft(x, norm="ortho").astype(jnp.complex64)


def ifft(x: jax.Array) -> jax.Array:
    """N-point IFFT along the last axis, norm='ortho'."""
    return jnp.fft.ifft(x, norm="ortho").astype(jnp.complex64)
