"""The XLA kernels (FFT, FIR/polyphase, S&C correlator) against independent
float64 NumPy references: np.fft, golden.resample and golden.sync.

Tolerances: f32 products summed over K taps (<= 1200 here) of O(1)
samples err by ~K * 2^-24 * |x|, so 2e-4 absolute bounds every FIR case;
an N-point f32 FFT errs by ~log2(N) * 2^-24 * sqrt(N)-scaled values,
bounded by 2e-4 * sqrt(N).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ofdm_uhd_tpu.core.spec import config
from ofdm_uhd_tpu.golden import resample as GR
from ofdm_uhd_tpu.golden import sync as GS
from ofdm_uhd_tpu.kernels import conv_backend as CB
from ofdm_uhd_tpu.kernels import fft as K1
from ofdm_uhd_tpu.kernels.sync import sc_correlate, sc_metric
from ofdm_uhd_tpu.phy import frame as PF
from ofdm_uhd_tpu.phy.tables import resample_filter

FIR_ATOL = 2e-4


def rng_for(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


def crand(r, *shape):
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)
            ).astype(np.complex64)


def _rows(x):
    return x.reshape(-1, x.shape[-1]).astype(np.complex128)


# ------------------------------------------------------------------- FFT

@pytest.mark.parametrize("n", [64, 256, 512, 1024])
def test_fft_matches_numpy(n):
    r = rng_for(f"fft{n}")
    x = crand(r, 5, n)
    np.testing.assert_allclose(np.asarray(K1.fft(x)),
                               np.fft.fft(x, norm="ortho", axis=-1),
                               atol=2e-4 * np.sqrt(n))
    np.testing.assert_allclose(np.asarray(K1.ifft(x)),
                               np.fft.ifft(x, norm="ortho", axis=-1),
                               atol=2e-4 * np.sqrt(n))


@pytest.mark.parametrize("n,cp", [(64, 16), (256, 32), (512, 64),
                                  (1024, 128)])
def test_cp_strip_fft_and_ifft_cp(n, cp):
    """ofdm_demodulate's CP strip + FFT and ofdm_modulate's IFFT + CP
    insertion against the NumPy slice/fft and ifft/concat forms."""
    spec = config("c1").with_(n_sc=n, cp=cp, n_occupied=0, n_data_syms=3)
    r = rng_for(f"cpfft{n}")
    shift = min(4, cp // 4)
    x = crand(r, 3, spec.frame_len)
    got = np.asarray(PF.ofdm_demodulate(spec, jnp.asarray(x), shift=shift))
    syms = x.reshape(3, spec.n_syms, spec.sym_len)
    start = cp - shift
    ref = np.fft.fft(syms[..., start:start + n], norm="ortho", axis=-1)
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.sqrt(n))
    g = crand(r, 3, spec.n_syms, n)
    got = np.asarray(PF.ofdm_modulate(spec, jnp.asarray(g)))
    xi = np.fft.ifft(g, norm="ortho", axis=-1)
    ref = np.concatenate([xi[..., -cp:], xi], axis=-1).reshape(3, -1)
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.sqrt(n))


def test_fft_parseval_and_linearity():
    r = rng_for("fftprop")
    x = crand(r, 3, 256)
    y = np.asarray(K1.fft(x))
    np.testing.assert_allclose(np.sum(np.abs(y) ** 2, axis=-1),
                               np.sum(np.abs(x) ** 2, axis=-1), rtol=1e-4)
    a, b = crand(r, 1, 256), crand(r, 1, 256)
    np.testing.assert_allclose(
        np.asarray(K1.fft(a + 2 * b)),
        np.asarray(K1.fft(a)) + 2 * np.asarray(K1.fft(b)), atol=1e-3)


def test_fft_impulse():
    # FFT of a unit impulse = constant 1/sqrt(N)
    x = np.zeros((1, 1024), dtype=np.complex64)
    x[0, 0] = 1.0
    np.testing.assert_allclose(np.asarray(K1.fft(x)),
                               np.full((1, 1024), 1 / 32, dtype=complex),
                               atol=1e-5)


# ------------------------------------------------------- FIR / polyphase

def _hann(n):
    t = np.hanning(n).astype(np.float32)
    return t / t.sum()


FIR_CASES = {
    "193t-1d": ((5000,), lambda: resample_filter(8, 1)),
    "193t-batched": ((3, 4500), lambda: resample_filter(8, 1)),
    "193t-2x2": ((2, 2, 2048), lambda: resample_filter(8, 1)),
    "97t": ((3, 1000), lambda: GR.design_lowpass(4, 1).astype(np.float32)),
    "3t": ((2, 1000), lambda: np.asarray([0.25, 0.5, 0.25], np.float32)),
    "385t": ((2000,), lambda: _hann(385)),
}


@pytest.mark.parametrize("case", sorted(FIR_CASES))
def test_fir_matches_golden(case):
    shape, taps_fn = FIR_CASES[case]
    taps = np.asarray(taps_fn())
    x = crand(rng_for(f"fir{case}"), *shape)
    got = np.asarray(CB.fir_same(x, taps))
    assert got.shape == x.shape
    ref = np.stack([GR.fir_filter(row, taps.astype(np.float64))
                    for row in _rows(x)]).reshape(shape)
    np.testing.assert_allclose(got, ref, atol=FIR_ATOL)


def test_fir_impulse_response():
    taps = np.arange(1, 12, dtype=np.float32)
    x = np.zeros((1, 300), dtype=np.complex64)
    x[0, 100] = 1.0
    y = np.asarray(CB.fir_same(x, taps))
    half = (len(taps) - 1) // 2
    expect = np.zeros(300)
    expect[100 - half: 100 - half + len(taps)] = taps
    np.testing.assert_allclose(y[0].real, expect, atol=1e-5)


DECIM_CASES = {
    "8x-40960": (8, (40960,), None),
    "2x-9000": (2, (9000,), None),
    "8x-batched": (8, (5, 16384), None),
    "8x-4096x2": (8, (2, 4096), None),
    "8x-1200t": (8, (9600,), 1200),
}


@pytest.mark.parametrize("case", sorted(DECIM_CASES))
def test_decim_matches_golden(case):
    m, shape, hann = DECIM_CASES[case]
    taps = _hann(hann) if hann else resample_filter(m, 1)
    x = crand(rng_for(f"decim{case}"), *shape)
    got = np.asarray(CB.polyphase_decim_xla(x, m, taps))
    assert got.shape == shape[:-1] + (shape[-1] // m,)
    ref = np.stack([GR.resample(row, 1, m, taps.astype(np.float64))
                    for row in _rows(x)]).reshape(got.shape)
    np.testing.assert_allclose(got, ref, atol=FIR_ATOL)


INTERP_CASES = {
    "8x-5120": (8, (5120,)),
    "2x-3000": (2, (3000,)),
    "8x-batched": (8, (6, 2100)),
    "2x-700x2": (2, (2, 700)),
    "8x-700x2": (8, (2, 700)),
}


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interp_matches_golden(case):
    l, shape = INTERP_CASES[case]
    taps = resample_filter(l, 1)
    x = crand(rng_for(f"interp{case}"), *shape)
    got = np.asarray(CB.polyphase_interp_xla(x, l, taps))
    assert got.shape == shape[:-1] + (shape[-1] * l,)
    ref = np.stack([GR.resample(row, l, 1, taps.astype(np.float64))
                    for row in _rows(x)]).reshape(got.shape)
    np.testing.assert_allclose(got, ref, atol=FIR_ATOL)


def test_fir_high_precision_batched():
    """A lower matmul precision (Precision.HIGH) stays within an
    EVM-grade bound of the f32-exact filter."""
    taps = resample_filter(8, 1)
    x = crand(rng_for("firhigh"), 4, 20000)
    ref = np.asarray(CB.fir_same(x, taps))
    got = np.asarray(CB.fir_same(x, taps, precision=jax.lax.Precision.HIGH))
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_filter_precision_gate_chain():
    """spec.filter_precision reaches the filter matmuls: 'bf16' stays
    EVM-grade through the resampled C4 chain (CRC passes, bits exact)."""
    from ofdm_uhd_tpu.pipeline import TxPipeline, RxPipeline
    spec = config("c4").with_(n_data_syms=4)
    r = np.random.default_rng(8)
    p = r.integers(0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
    base = RxPipeline(spec).rx_aligned(np.asarray(TxPipeline(spec)(p)))
    assert float(np.mean(np.asarray(base["evm_db"]))) < -30.0
    sp = spec.with_(filter_precision="bf16")
    out = RxPipeline(sp).rx_aligned(np.asarray(TxPipeline(sp)(p)))
    assert np.asarray(out["crc_ok"]).all()
    assert np.array_equal(np.asarray(out["payload"]), p)
    assert float(np.mean(np.asarray(out["evm_db"]))) < -25.0


# ------------------------------------------------------- S&C correlator

SC_CASES = {
    "60000-128": (None, 60000, 128),
    "20000-128": (None, 20000, 128),
    "9000-512": (None, 9000, 512),
    "9000-32": (None, 9000, 32),
    "20480-128": (None, 20480, 128),
    "3x6000-32": (3, 6000, 32),
    "3x16000-128": (3, 16000, 128),
}


@pytest.mark.parametrize("case", sorted(SC_CASES))
def test_sc_correlator_matches_golden(case):
    batch, n, l = SC_CASES[case]
    r = rng_for(f"sc{case}")
    x = crand(r, *((batch,) if batch else ()), n)
    p, rr = sc_correlate(jnp.asarray(x), l)
    m = np.asarray(sc_metric(p, rr))
    spec = config("c1").with_(n_sc=2 * l, cp=l // 4, n_occupied=0)
    for i, row in enumerate(_rows(x)):
        p_g, rr_g = GS.sc_metric(spec, row)
        m_g = np.where(rr_g > 1e-12,
                       np.abs(p_g) ** 2 / np.maximum(rr_g, 1e-12) ** 2, 0.0)
        got_p = np.asarray(p).reshape(-1, p.shape[-1])[i]
        got_r = np.asarray(rr).reshape(-1, rr.shape[-1])[i]
        # window sums of l (or 2l) unit-power terms: f32 error ~ sqrt(l)
        np.testing.assert_allclose(got_p, p_g, atol=2e-4 * np.sqrt(l))
        np.testing.assert_allclose(got_r, rr_g, atol=2e-4 * np.sqrt(l))
        np.testing.assert_allclose(m.reshape(-1, m.shape[-1])[i], m_g,
                                   atol=1e-4)


def test_sc_metric_on_real_capture_detects_golden_plateaus():
    """On an actual C3 capture the metric matches the float64 golden
    metric, so detection sees the same plateaus."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from bench_lib import build_capture
    spec = config("c3")
    cap, _ = build_capture(spec, 4, gap=300)
    l = spec.n_sc // 2
    p, rr = sc_correlate(jnp.asarray(cap), l)
    m = np.asarray(sc_metric(p, rr))
    p_g, rr_g = GS.sc_metric(spec, cap.astype(np.complex128))
    m_g = np.where(rr_g > 1e-12,
                   np.abs(p_g) ** 2 / np.maximum(rr_g, 1e-12) ** 2, 0.0)
    np.testing.assert_allclose(m, m_g, atol=1e-4)
    assert np.sum((m >= 0.5) & ~np.r_[False, m[:-1] >= 0.5]) >= 4
