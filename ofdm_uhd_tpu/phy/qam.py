"""JAX QAM mapper/demapper (hard + max-log LLR), Gray-coded, unit power.

Array re-design of the reference-class C++ LUT mapper / nearest-point demapper
(SURVEY.md §2.1 #6-#7; mount empty, §0): table gathers and per-axis
vectorized min-distance — separable for Gray square QAM, so LLRs cost
O(2^(b/2)) per axis instead of O(2^b) per symbol.

Matches golden.modem.qam_map / qam_demap_llr numerically (same LUTs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import MOD_BITS
from . import tables as T


def _gray_amplitude(bits_axis: jax.Array, nb: int) -> jax.Array:
    """Gray-coded axis amplitude computed ARITHMETICALLY (gather-free).

    With signs s_i = 2*b_i - 1 (b_0 = MSB), the LUT in tables.qam_tables is
    exactly the nested form

        a = s_0 * acc,   acc = 2^(nb-i) - s_i * acc  (i = nb-1 .. 1, acc0=1)

    A few fused elementwise ops replace a 2-8 entry table gather.
    """
    s = 2.0 * bits_axis.astype(jnp.float32) - 1.0        # [..., nb]
    acc = jnp.float32(1.0)
    for i in range(nb - 1, 0, -1):
        acc = float(1 << (nb - i)) - s[..., i] * acc
    return s[..., 0] * acc


def qam_map(bits: jax.Array, mod: str) -> jax.Array:
    """bits [..., n*bits_per_qam] -> complex64 symbols [..., n]."""
    t = T.qam_tables(mod)
    nb = int(t["nb"])
    scale = float(np.max(np.abs(t["axis_lut"])) / ((1 << nb) - 1))
    bpq = MOD_BITS[mod]
    b = bits.reshape(bits.shape[:-1] + (-1, bpq))
    re = _gray_amplitude(b[..., :nb], nb) * scale
    if mod == "bpsk":
        return re.astype(jnp.complex64)
    im = _gray_amplitude(b[..., nb:], nb) * scale
    return (re + 1j * im).astype(jnp.complex64)


def _axis_llr(x: jax.Array, lut: jax.Array, bit_of_level: jax.Array) -> jax.Array:
    """x [...] real -> [..., nb] max-log LLRs for one I/Q axis."""
    d2 = (x[..., None] - lut) ** 2                       # [..., L]
    inf = jnp.float32(jnp.inf)
    # [..., L, nb] masked distances
    m0 = jnp.min(jnp.where(bit_of_level == 0.0, d2[..., None], inf), axis=-2)
    m1 = jnp.min(jnp.where(bit_of_level == 1.0, d2[..., None], inf), axis=-2)
    return m1 - m0


def qam_demap_llr(syms: jax.Array, mod: str,
                  csi: jax.Array | None = None) -> jax.Array:
    """symbols [..., n] -> LLRs [..., n*bits_per_qam], llr>0 favours bit 0.

    `csi` [..., n] scales per-symbol reliability (|H|^2 after one-tap EQ).
    """
    t = T.qam_tables(mod)
    lut = jnp.asarray(t["axis_lut"])
    bol = jnp.asarray(t["bit_of_level"])
    i_llr = _axis_llr(jnp.real(syms).astype(jnp.float32), lut, bol)
    if mod == "bpsk":
        out = i_llr
    else:
        q_llr = _axis_llr(jnp.imag(syms).astype(jnp.float32), lut, bol)
        out = jnp.concatenate([i_llr, q_llr], axis=-1)   # [..., n, bpq]
    if csi is not None:
        out = out * csi[..., None].astype(jnp.float32)
    return out.reshape(syms.shape[:-1] + (-1,))


def qam_demap_hard(syms: jax.Array, mod: str) -> jax.Array:
    """Nearest-point hard decisions -> bits [..., n*bits_per_qam]."""
    t = T.qam_tables(mod)
    nb = int(t["nb"])
    lut = jnp.asarray(t["axis_lut"])

    def axis_bits(x):
        idx = jnp.argmin(jnp.abs(x[..., None] - lut), axis=-1)
        shifts = jnp.asarray([nb - 1 - k for k in range(nb)], dtype=jnp.int32)
        return ((idx[..., None] >> shifts) & 1).astype(jnp.uint8)

    i_bits = axis_bits(jnp.real(syms))
    if mod == "bpsk":
        out = i_bits
    else:
        q_bits = axis_bits(jnp.imag(syms))
        out = jnp.concatenate([i_bits, q_bits], axis=-1)
    return out.reshape(syms.shape[:-1] + (-1,))
