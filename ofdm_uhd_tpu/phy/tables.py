"""Host-side precomputed constants per WaveformSpec (cached).

Derived from the golden oracle's NumPy definitions so the JAX chain is
consistent with the float64 reference by construction. All tables are plain
NumPy; they become on-device constants when closed over by jitted functions.
"""

from __future__ import annotations

import functools

import numpy as np

from ..core.spec import (WaveformSpec, CONV_POLY_A, CONV_POLY_B,
                         MOD_BITS)
from ..golden import bits as GB
from ..golden import modem as GM
from ..golden import resample as GR


@functools.lru_cache(maxsize=64)
def scramble_seq(n: int, seed: int = GB.SCRAMBLER_SEED) -> np.ndarray:
    return GB.lfsr_sequence(n, seed)


@functools.lru_cache(maxsize=64)
def crc_matrix(n_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(M [32, n], c [32]) with crc = (M @ bits + c) mod 2."""
    return GB.crc32_matrix(n_bits)


@functools.lru_cache(maxsize=8)
def parity7_lut() -> np.ndarray:
    """parity of the low 7 bits, indexed 0..127."""
    x = np.arange(128)
    return (np.bitwise_count(x) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def conv_output_luts() -> tuple[np.ndarray, np.ndarray]:
    """LUTs over the 7-bit window w=(current..6-back): out_a[w], out_b[w]."""
    p = parity7_lut()
    w = np.arange(128)
    return p[w & CONV_POLY_A], p[w & CONV_POLY_B]


@functools.lru_cache(maxsize=8)
def viterbi_tables() -> dict[str, np.ndarray]:
    """Trellis tables matching golden.bits.viterbi_decode exactly.

    pred [2, 64]: predecessor states of s' (shifted-out bit 0/1);
    br_a/br_b [2, 64]: branch output bits on the pred->s' transition.
    """
    s = np.arange(64)
    pred = np.stack([((s & 31) << 1) | 0, ((s & 31) << 1) | 1]).astype(np.int32)
    in_bit = (s >> 5).astype(np.int32)
    w = (in_bit[None, :] << 6) | pred
    p = parity7_lut()
    return {
        "pred": pred,
        "br_a": p[w & CONV_POLY_A].astype(np.float32),
        "br_b": p[w & CONV_POLY_B].astype(np.float32),
    }


@functools.lru_cache(maxsize=64)
def interleave_tables(n_cbps: int) -> tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm): tx_bits[perm[k]] = coded[k]; gather forms for jnp.

    interleave:  out = coded[inv_perm]  (out[i] = coded at position with perm==i)
    deinterleave: coded = rx[perm]
    """
    perm = GB.interleave_perm(n_cbps).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_cbps, dtype=np.int32)
    return perm, inv


@functools.lru_cache(maxsize=16)
def qam_tables(mod: str) -> dict[str, np.ndarray]:
    nb = max(MOD_BITS[mod] // 2, 1)
    lut = (GM._AXIS_LUT[nb] * GM.qam_scale(mod)).astype(np.float32)
    bit_of_level = ((np.arange(len(lut))[:, None] >> np.arange(nb - 1, -1, -1)) & 1
                    ).astype(np.float32)
    return {"axis_lut": lut, "bit_of_level": bit_of_level, "nb": np.int32(nb)}


@functools.lru_cache(maxsize=32)
def frame_tables(spec: WaveformSpec) -> dict[str, np.ndarray]:
    """Per-spec grid constants: preambles, pilot polarity, bin indices."""
    sym_a, sym_b = GM.preamble_freq(spec)
    return {
        "sym_a": sym_a.astype(np.complex64),
        "sym_b": sym_b.astype(np.complex64),
        "sym_b_occ_conj": np.conj(sym_b[spec.occupied_bins]).astype(np.complex64),
        "pilot_polarity": GB.pilot_polarity(spec.n_data_syms).astype(np.float32),
        "occupied_bins": spec.occupied_bins.astype(np.int32),
        "pilot_bins": spec.pilot_bins.astype(np.int32),
        "data_bins": spec.data_bins.astype(np.int32),
        "pilot_positions": spec.pilot_positions.astype(np.int32),
        "data_positions": spec.data_positions.astype(np.int32),
    }


@functools.lru_cache(maxsize=32)
def puncture_tables(rate: str, full_len: int) -> dict[str, np.ndarray]:
    """(kept indices, depuncture one-hot [kept, full]) for a FEC rate."""
    mask = GB.puncture_mask(rate, full_len)
    kept = np.nonzero(mask)[0].astype(np.int32)
    dep = np.zeros((len(kept), full_len), dtype=np.float32)
    dep[np.arange(len(kept)), kept] = 1.0
    return {"kept": kept, "depuncture": dep}


@functools.lru_cache(maxsize=32)
def selection_tables(spec: WaveformSpec) -> dict[str, np.ndarray]:
    """One-hot f32 selection matrices — the gather/scatter-free way to move
    symbols between bin orderings (phy/frame.py).

      data_to_grid  [n_data_sc, n_sc] : data symbols -> FFT-order bins
      pilot_to_grid [n_pilots, n_sc]  : pilot symbols -> FFT-order bins
      grid_to_occ   [n_sc, n_occ]     : FFT-order bins -> occupied ordering
      occ_to_pilot  [n_occ, n_pilots] : occupied -> pilot positions
      occ_to_data   [n_occ, n_data_sc]: occupied -> data positions
    """
    occ = spec.occupied_bins
    out = {}

    def onehot(rows, cols, row_idx_to_col):
        m = np.zeros((rows, cols), dtype=np.float32)
        m[np.arange(rows), row_idx_to_col] = 1.0
        return m

    out["data_to_grid"] = onehot(spec.n_data_sc, spec.n_sc, spec.data_bins)
    out["pilot_to_grid"] = onehot(spec.n_pilots, spec.n_sc, spec.pilot_bins)
    out["grid_to_occ"] = onehot(spec.n_occupied, spec.n_sc, occ).T.copy()
    out["occ_to_pilot"] = onehot(
        spec.n_pilots, spec.n_occupied, spec.pilot_positions).T.copy()
    out["occ_to_data"] = onehot(
        spec.n_data_sc, spec.n_occupied, spec.data_positions).T.copy()
    return out


@functools.lru_cache(maxsize=32)
def resample_filter(l: int, m: int) -> np.ndarray:
    """Kaiser-sinc prototype (float32) shared with the golden resampler."""
    return GR.design_lowpass(l, m).astype(np.float32)
