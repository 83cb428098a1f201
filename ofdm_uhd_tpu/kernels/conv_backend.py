"""XLA formulations for the K2 FIR/polyphase kernel.

Design notes (SURVEY.md §2.2-K2):
* ALL 1-D filtering runs as BLOCK-BANDED MATMULS, not
  `lax.conv_general_dilated`: each block of outputs is one dense
  [window, band] matmul, which XLA hands to the matrix library, at a MAC
  overhead of ~(blk+K)/K. Whether cuDNN's 1-D convolution beats it on a
  GPU is an open question (PERF.md). Plain jnp, so XLA fuses it (and
  GSPMD partitions it) anywhere.
* complex-by-real filtering runs the (re, im) planes as a batch dim;
* polyphase interpolation never materializes the zero-stuffed signal: the
  prototype is decomposed host-side into an [L, D] branch-tap matrix and
  the L branches become output channels, interleaved afterwards.

Derivation for the branch matrix (matches golden.resample.resample exactly):
with u = zero-stuffed x, 'same' output y[i] = sum_j h[j]*u[i+half-j] at the
upsampled rate, write i = n*L + p:
    y[n*L + p] = sum_d g_p[d] * x[n - d],   g_p[d] = L * h[d*L + p + half]
with d in [d_min, d_max], d_min = -((half + L - 1) // L),
d_max = (len(h) - 1 - half) // L, zeros outside the prototype support.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

@functools.lru_cache(maxsize=64)
def _band_matrix(kern_key: tuple, c: int, k: int, stride: int,
                 blk: int) -> np.ndarray:
    """[blk_in, C*blk] band: band[i*stride + t, c_i*blk + i] = kern[c_i, t]."""
    kern = np.asarray(kern_key, dtype=np.float32).reshape(c, k)
    blk_in = (blk - 1) * stride + k
    band = np.zeros((blk_in, c * blk), dtype=np.float32)
    for ci in range(c):
        for i in range(blk):
            band[i * stride: i * stride + k, ci * blk + i] = kern[ci]
    return band


def _conv1d(x: jax.Array, kernels, pad_left: int, pad_right: int,
            stride: int = 1, blk: int | None = None,
            precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Batched 1-D cross-correlation: x [B, n], kernels [C, K] -> [B, C, n_out].

    out[b, c, i] = sum_t kernels[c, t] * x[b, i*stride - pad_left + t]

    Block-banded matmul: outputs are produced blk at a time; each output
    block reads a (blk-1)*stride + K input window assembled from two
    consecutive stride*blk input blocks (one reshape + one shifted
    reshape — no gathers).

    blk sets the dense band's MAC inflation, ((blk-1)*stride + K) / K:
    the default scales blk down until the window is ~2 taps wide
    (inflation ~2x), with a floor of 128 outputs per block.
    precision: HIGHEST (f32 products; the default everywhere correctness
    gates compare bit-level) or a lower level for callers whose gates are
    EVM-level (kernels/fir.py).
    """
    kern = np.asarray(kernels, dtype=np.float32)
    c, k = kern.shape
    b, n = x.shape
    if blk is None:
        # inflation ((blk-1)*stride + k)/k ~ 2 => blk ~ k/stride, floored
        # at 128 outputs per block
        blk = max(128, 1 << int(np.ceil(np.log2(max(k / max(stride, 1), 1)))))
    ablk = blk * stride
    assert k <= ablk + stride, "taps longer than a block: raise blk"
    blk_in = (blk - 1) * stride + k
    n_in = n + pad_left + pad_right
    n_out = (n_in - k) // stride + 1
    nb = -(-n_out // blk)
    total = nb * ablk + ablk                      # room for the shifted view
    xp = jnp.pad(x.astype(jnp.float32),
                 ((0, 0), (pad_left, total - n - pad_left)))
    a = xp[:, : nb * ablk].reshape(b, nb, ablk)
    nxt = xp[:, ablk: ablk + nb * ablk].reshape(b, nb, ablk)
    win = jnp.concatenate([a, nxt], axis=-1)[..., :blk_in]   # [b, nb, blk_in]
    band = jnp.asarray(_band_matrix(tuple(kern.ravel().tolist()), c, k,
                                    stride, blk))
    y = jnp.matmul(win, band, precision=precision)  # [b, nb, C*blk]
    y = y.reshape(b, nb, c, blk).transpose(0, 2, 1, 3).reshape(
        b, c, nb * blk)[..., :n_out]
    return y


def _split_complex(x: jax.Array) -> tuple[jax.Array, tuple]:
    """[..., n] complex -> [2*prod(batch), n] f32 planes + shape info."""
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    planes = jnp.concatenate([jnp.real(flat), jnp.imag(flat)], axis=0)
    return planes.astype(jnp.float32), (batch_shape, flat.shape[0], n)


def _merge_complex(planes: jax.Array, info, n_out: int) -> jax.Array:
    batch_shape, b, _ = info
    re, im = planes[:b], planes[b:]
    return (re + 1j * im).astype(jnp.complex64).reshape(batch_shape + (n_out,))


def fir_same(x: jax.Array, taps,
             precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """'Same'-aligned FIR with real taps over complex [..., n] signals.

    y[i] = sum_j taps[j] * x[i + half - j], half = (len(taps)-1)//2 —
    the f32 twin of golden.resample.fir_filter.
    """
    taps = np.asarray(taps, dtype=np.float32)
    nt = len(taps)
    half = (nt - 1) // 2
    planes, info = _split_complex(x)
    k = taps[::-1][None, :]                  # correlation with flipped taps
    out = _conv1d(planes, k, pad_left=nt - 1 - half, pad_right=half,
                  precision=precision)
    return _merge_complex(out[:, 0, :], info, x.shape[-1])


@functools.lru_cache(maxsize=32)
def _branch_matrix(taps_key: tuple, l: int) -> tuple[np.ndarray, int, int]:
    """Host-side polyphase branch decomposition -> (G [L, D], d_min, d_max)."""
    h = np.asarray(taps_key, dtype=np.float64) * l
    nt = len(h)
    half = (nt - 1) // 2
    d_min = -((half + l - 1) // l)
    d_max = (nt - 1 - half) // l
    dd = np.arange(d_min, d_max + 1)
    g = np.zeros((l, len(dd)), dtype=np.float32)
    for p in range(l):
        idx = dd * l + p + half
        ok = (idx >= 0) & (idx < nt)
        g[p, ok] = h[idx[ok]]
    return g, d_min, d_max


def polyphase_interp_xla(x: jax.Array, l: int, taps: np.ndarray,
                         precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """L-fold interpolation [..., n] -> [..., n*l]; taps = prototype (numpy)."""
    g, d_min, d_max = _branch_matrix(tuple(np.asarray(taps, dtype=np.float64)), l)
    planes, info = _split_complex(x)
    # y_p[n] = sum_d g_p[d] x[n-d] = correlation with g_p reversed
    out = _conv1d(planes, g[:, ::-1], pad_left=d_max, pad_right=-d_min,
                  precision=precision)                     # [B2, L, n]
    n = x.shape[-1]
    inter = jnp.swapaxes(out, 1, 2).reshape(planes.shape[0], n * l)
    return _merge_complex(inter, info, n * l)


def polyphase_decim_stream(w: jax.Array, m: int, taps: np.ndarray) -> jax.Array:
    """Causal streaming M-fold decimation (valid mode, no implicit padding).

    w [..., C*m + nt - 1] = carry(nt-1 radio samples) ++ chunk; returns
    [..., C] with y[k] = sum_j h[j] * w[k*m + (nt-1) - j] — i.e. the
    continuously-filtered stream delayed by nt-1 radio samples. The constant
    delay is absorbed by frame sync. Used by the streaming receiver
    (pipeline/stream.py); GSPMD partitions the strided conv with automatic
    halo exchange when w is sharded.
    """
    taps = np.asarray(taps, dtype=np.float32)
    planes, info = _split_complex(w)
    out = _conv1d(planes, taps[::-1][None, :], pad_left=0, pad_right=0,
                  stride=m)[:, 0, :]
    n_out = (w.shape[-1] - len(taps)) // m + 1
    return _merge_complex(out, info, n_out)


@functools.lru_cache(maxsize=32)
def _rational_kernels(taps_key: tuple, l: int, m: int
                      ) -> tuple[np.ndarray, int]:
    """Per-output-phase kernels for the causal rational M/L resampler.

    y[n] = sum_j h[j] * u[n*l + nt-1 - j], u = w zero-stuffed by M, gain M.
    Writing n = j*m + k: phase p_k = (k*l + nt-1) mod m and base offset
    s0_k = (k*l + nt-1 - p_k) / m are constant per k (radio chunks are
    multiples of L, so the phase pattern restarts every chunk — no phase
    state beyond the nt-1 radio-sample carry). Returns (kern [m, K], K)
    with out_k[j] = sum_t kern[k, t] * w[j*l + t].
    """
    h = np.asarray(taps_key, dtype=np.float64) * m
    nt = len(h)
    s0, gs = [], []
    for k in range(m):
        p = (k * l + nt - 1) % m
        idx = np.arange(p, nt, m)
        gs.append(h[idx])                       # G_k[d] = h[p + d*m]
        s0.append((k * l + nt - 1 - p) // m)
    kk = max(s0) + 1
    kern = np.zeros((m, kk), dtype=np.float32)
    for k in range(m):
        d = np.arange(len(gs[k]))
        t = s0[k] - d
        ok = t >= 0
        kern[k, t[ok]] = gs[k][ok]
    return kern, kk


def rational_decim_stream(w: jax.Array, l: int, m: int,
                          taps: np.ndarray) -> jax.Array:
    """Causal streaming rational resample by M/L (radio -> baseband).

    w [..., C_r + nt - 1] = carry(nt-1 radio samples) ++ radio chunk;
    returns [..., C_r * m / l] baseband samples — the continuously
    resampled stream delayed by a constant group delay (absorbed by frame
    sync). Requires C_r * m % l == 0 (choose radio chunks divisible by L).
    m == 1 reduces exactly to integer decimation (polyphase_decim_stream).
    """
    taps = np.asarray(taps, dtype=np.float64)
    nt = len(taps)
    c_r = w.shape[-1] - (nt - 1)
    assert (c_r * m) % l == 0, "radio chunk must be a multiple of L"
    c_b = c_r * m // l
    j_out = c_b // m
    kern, kk = _rational_kernels(tuple(taps), l, m)
    planes, info = _split_complex(w)
    out = _conv1d(planes, kern, pad_left=0, pad_right=kk, stride=l)
    out = out[:, :, :j_out]                       # [B2, m, J]
    inter = jnp.swapaxes(out, 1, 2).reshape(planes.shape[0], c_b)
    return _merge_complex(inter, info, c_b)


def polyphase_decim_xla(x: jax.Array, m: int, taps: np.ndarray,
                        precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """M-fold decimation [..., n*m] -> [..., n]: strided 'same' FIR.

    Uses conv stride m so the discarded outputs are never computed.
    """
    taps = np.asarray(taps, dtype=np.float32)
    nt = len(taps)
    half = (nt - 1) // 2
    planes, info = _split_complex(x)
    out = _conv1d(planes, taps[::-1][None, :],
                  pad_left=nt - 1 - half, pad_right=half, stride=m,
                  precision=precision)[:, 0, :]
    return _merge_complex(out, info, x.shape[-1] // m)
