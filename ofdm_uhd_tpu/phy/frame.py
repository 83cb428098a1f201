"""JAX frame build/parse, OFDM modulate/demodulate, channel estimation,
one-tap EQ and pilot phase tracking — batched over frames.

Array re-design of the reference-class per-symbol C++ loops around FFTW
(SURVEY.md §2.1 #8-#15; mount empty, §0). All subcarrier moves between
orderings (data/pilot <-> FFT grid <-> occupied) are ONE-HOT SELECTION
MATMULS (exact under the package's f32 'highest' matmul precision), not
gathers/scatters. Whether the native gather is cheaper on a GPU is an
open question (ROADMAP Speed item 4). The FFT runs through the K1
kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.spec import WaveformSpec
from ..kernels import fft as K1
from . import tables as T


def _sel(x: jax.Array, m) -> jax.Array:
    """Complex [..., a] @ one-hot [a, b] -> [..., b] via two real matmuls."""
    mj = jnp.asarray(m)
    re = jnp.real(x).astype(jnp.float32) @ mj
    im = jnp.imag(x).astype(jnp.float32) @ mj
    return (re + 1j * im).astype(jnp.complex64)


def build_grid(spec: WaveformSpec, data_syms: jax.Array) -> jax.Array:
    """data_syms [B, n_data_syms, n_data_sc] -> grid [B, n_syms, n_sc] c64."""
    t = T.frame_tables(spec)
    s = T.selection_tables(spec)
    b = data_syms.shape[0]
    pol = jnp.asarray(t["pilot_polarity"]).astype(jnp.complex64)
    pilots = jnp.broadcast_to(pol[None, :, None],
                              (b, spec.n_data_syms, spec.n_pilots))
    data_part = _sel(data_syms.astype(jnp.complex64), s["data_to_grid"])
    pilot_part = _sel(pilots, s["pilot_to_grid"])
    body = data_part + pilot_part                     # [B, S, n_sc]
    pre = jnp.stack([jnp.asarray(t["sym_a"]), jnp.asarray(t["sym_b"])])
    pre = jnp.broadcast_to(pre[None], (b, 2, spec.n_sc))
    return jnp.concatenate([pre, body], axis=1)


def ofdm_modulate(spec: WaveformSpec, grid: jax.Array) -> jax.Array:
    """grid [B, n_syms, n_sc] -> samples [B, frame_len] (IFFT + CP).

    Windowed-OFDM taper per spec.tx_window (twin of golden.modem's
    overlap-add form, vectorized: the suffix overlap-add is a pad + shifted
    add over the symbol axis instead of a loop).
    """
    import numpy as np
    w = spec.tx_window
    b = grid.shape[0]
    x = K1.ifft(grid)
    with_cp = jnp.concatenate([x[..., -spec.cp:], x], axis=-1)
    if w <= 0:
        return with_cp.reshape(b, spec.frame_len)
    assert 2 * w <= spec.cp, "tx_window must be <= cp/2"
    ramp = jnp.asarray(
        0.5 * (1 - np.cos(np.pi * (np.arange(w) + 0.5) / w)),
        dtype=jnp.float32).astype(jnp.complex64)
    head = with_cp[..., :w] * ramp
    body = with_cp[..., w:]
    tapered = jnp.concatenate([head, body], axis=-1)     # [B, S, sym_len]
    main = tapered.reshape(b, spec.frame_len)
    suffix = x[..., :w] * ramp[::-1]                     # [B, S, w]
    pad = jnp.zeros((b, spec.n_syms, spec.sym_len - w), dtype=jnp.complex64)
    sufframe = jnp.concatenate([suffix, pad], axis=-1).reshape(
        b, spec.frame_len)
    # suffix of symbol s lands at (s+1)*sym_len: shift right by sym_len,
    # drop the spill past frame_len
    shifted = jnp.concatenate(
        [jnp.zeros((b, spec.sym_len), jnp.complex64), sufframe],
        axis=-1)[:, : spec.frame_len]
    return main + shifted


def ofdm_demodulate(spec: WaveformSpec, samples: jax.Array,
                    shift: int = 0) -> jax.Array:
    """samples [B, frame_len] -> grid [B, n_syms, n_sc] (CP strip + FFT).

    `shift` advances the FFT window into the CP (absorbed by the EQ, same as
    golden.modem.ofdm_demodulate).
    """
    b = samples.shape[0]
    syms = samples[:, : spec.frame_len].reshape(b, spec.n_syms, spec.sym_len)
    start = spec.cp - shift
    win = jax.lax.slice_in_dim(syms, start, start + spec.n_sc, axis=-1)
    return K1.fft(win)


def _smooth_occ(h: jax.Array, width: int) -> jax.Array:
    """Edge-renormalized MA over the occupied-bin axis (golden twin).

    Small dense matmul (n_occ x n_occ banded-with-renorm matrix)."""
    if width <= 1:
        return h
    import numpy as np
    n = h.shape[-1]
    den = np.convolve(np.ones(n), np.ones(width), mode="same")
    m = np.zeros((n, n), dtype=np.float32)
    lo = width // 2
    for j in range(n):
        a = max(0, j - lo)
        b = min(n, j + (width - 1 - lo) + 1)
        m[a:b, j] = 1.0 / den[j]
    mj = jnp.asarray(m)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return (mm(jnp.real(h).astype(jnp.float32), mj)
            + 1j * mm(jnp.imag(h).astype(jnp.float32), mj)).astype(h.dtype)


def estimate_channel(spec: WaveformSpec, grid_rx: jax.Array) -> jax.Array:
    """LS estimate from preamble sym B -> H on occupied bins [B, n_occupied].

    Twin of golden.modem.estimate_channel (X is unit-power PN, so
    H = Y * conj(X)), with the same optional bin smoothing. SURVEY.md §2.1
    #13; psum-averaged across shards in pod mode (shard/ layer).
    """
    t = T.frame_tables(spec)
    s = T.selection_tables(spec)
    y = _sel(grid_rx[:, 1, :], s["grid_to_occ"])
    h = y * jnp.asarray(t["sym_b_occ_conj"])
    return _smooth_occ(h, spec.chanest_smooth)


def estimate_noise(spec: WaveformSpec, grid_rx: jax.Array) -> jax.Array:
    """Per-frame noise variance [B] from the guard (noise-only) bins.

    Selection-matmul form: sum |grid|^2 over guard bins = |grid|^2 @ onehot.
    """
    import numpy as np
    oh = np.zeros(spec.n_sc, dtype=np.float32)
    oh[spec.guard_bins] = 1.0
    p = jnp.abs(grid_rx) ** 2
    tot = jnp.sum(p @ jnp.asarray(oh), axis=-1)      # [B]
    return tot / (spec.n_syms * len(spec.guard_bins))


def equalize(spec: WaveformSpec, grid_rx: jax.Array, h_occ: jax.Array,
             eps: float = 1e-12) -> jax.Array:
    """One-tap EQ -> equalized occupied bins [B, n_data_syms, n_occupied].

    Twin of golden.modem.equalize ('zf' or 'mmse' per spec.eq_mode).
    """
    s = T.selection_tables(spec)
    y = _sel(grid_rx[:, 2:, :], s["grid_to_occ"])
    h = h_occ[:, None, :]
    reg = jnp.float32(eps)
    if spec.eq_mode == "mmse":
        reg = estimate_noise(spec, grid_rx)[:, None, None] + eps
    return y * jnp.conj(h) / (jnp.abs(h) ** 2 + reg)


def track_phase(spec: WaveformSpec, eq_occ: jax.Array
                ) -> tuple[jax.Array, jax.Array]:
    """Pilot phase tracking (CPE, + phase slope when spec.sfo_track) ->
    (data [B, n_data_syms, n_data_sc], cpe [B, S]). Twin of
    golden.modem.track_phase."""
    import numpy as np
    t = T.frame_tables(spec)
    s = T.selection_tables(spec)
    pol = jnp.asarray(t["pilot_polarity"]).astype(jnp.complex64)
    pilots = _sel(eq_occ, s["occ_to_pilot"]) * jnp.conj(pol)[None, :, None]
    k_pil = jnp.asarray(t["pilot_positions"].astype(np.float32))
    if spec.sfo_track and spec.n_pilots >= 2:
        diffs = pilots[..., 1:] * jnp.conj(pilots[..., :-1])
        dk = float(np.mean(np.diff(t["pilot_positions"].astype(np.float64))))
        slope = jnp.angle(jnp.sum(diffs, axis=-1)) / dk          # [B, S]
    else:
        slope = jnp.zeros(eq_occ.shape[:2], dtype=jnp.float32)
    derot = jnp.exp(-1j * slope[..., None] * k_pil).astype(jnp.complex64)
    cpe = jnp.angle(jnp.sum(pilots * derot, axis=-1))            # [B, S]
    k_data = jnp.asarray(t["data_positions"].astype(np.float32))
    corr = jnp.exp(-1j * (cpe[..., None] + slope[..., None] * k_data)
                   ).astype(jnp.complex64)
    data = _sel(eq_occ, s["occ_to_data"]) * corr
    return data, cpe


def data_csi(spec: WaveformSpec, h_occ: jax.Array) -> jax.Array:
    """|H|^2 on data bins [B, n_data_sc] — LLR reliability weights."""
    s = T.selection_tables(spec)
    return jnp.abs(h_occ) ** 2 @ jnp.asarray(s["occ_to_data"])
