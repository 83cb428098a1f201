"""Schmidl-Cox sliding correlation kernel (K3), in XLA.

Replaces the reference-class per-sample C++ correlator hot loop
(SURVEY.md §2.2-K3; mount empty, §0). Computes, for each lag d:

    P(d) = sum_{m=0}^{L-1} conj(r[d+m]) * r[d+m+L]
    R(d) = 0.5 * sum_{m=0}^{2L-1} |r[d+m]|^2

The windowed sums are computed by PAIRWISE DOUBLING —
S_2w[d] = S_w[d] + S_w[d+w], log2(win) shifted adds of contiguous slices —
NOT prefix-sum differences (long f32 cumsums lose precision) and NOT a
boxcar convolution: the doubling form is a handful of fused slice+adds,
bound by memory bandwidth, and the pairwise tree carries LESS rounding
error than the sequential conv order.

Golden twin: golden.sync.sc_metric (float64 cumsum form).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _moving_sum(x: jax.Array, win: int) -> jax.Array:
    """Valid-mode boxcar: y[..., d] = sum_{m<win} x[..., d+m], len n-win+1.

    Pairwise doubling over the binary decomposition of `win`: maintain
    S_w (window-w sums) by doubling, and fold in the powers present in
    `win` at their running offsets. For power-of-two windows (the S&C
    case: L = n_sc/2) this is exactly log2(win) shifted adds.
    """
    n = x.shape[-1]
    out_len = n - win + 1
    s = x.astype(jnp.float32)       # S_1
    w = 1
    acc = None
    off = 0                          # samples already covered by acc
    rem = win
    while rem:
        if rem & 1:
            part = jax.lax.slice_in_dim(s, off, off + out_len, axis=-1)
            acc = part if acc is None else acc + part
            off += w
        rem >>= 1
        if rem:
            half = jax.lax.slice_in_dim(s, 0, s.shape[-1] - w, axis=-1)
            shift = jax.lax.slice_in_dim(s, w, s.shape[-1], axis=-1)
            s = half + shift         # S_2w
            w *= 2
    return acc


def sc_correlate(r: jax.Array, l: int) -> tuple[jax.Array, jax.Array]:
    """r [..., n] complex -> (P [..., nd], R [..., nd]), nd = n - 2l + 1."""
    prod = jnp.conj(r[..., :-l]) * r[..., l:]        # s[n], length n-l
    p_re = _moving_sum(jnp.real(prod), l)            # [..., nd]
    p_im = _moving_sum(jnp.imag(prod), l)
    e = jnp.abs(r) ** 2
    rr = 0.5 * _moving_sum(e, 2 * l)                 # [..., nd]
    p = (p_re + 1j * p_im).astype(jnp.complex64)
    return p, rr


def sc_metric(p: jax.Array, rr: jax.Array, eps: float = 1e-12) -> jax.Array:
    """M(d) = |P|^2 / R^2 with zero where R ~ 0 (idle input)."""
    m = jnp.abs(p) ** 2 / jnp.maximum(rr, eps) ** 2
    return jnp.where(rr > eps, m, 0.0)
