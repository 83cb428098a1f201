"""JAX PHY blocks vs their golden NumPy twins (SURVEY.md §4 unit tier)."""

import zlib

import numpy as np
import pytest

from ofdm_uhd_tpu.core.spec import WaveformSpec, config
from ofdm_uhd_tpu.golden import bits as GB
from ofdm_uhd_tpu.golden import modem as GM
from ofdm_uhd_tpu.phy import bits as PB
from ofdm_uhd_tpu.phy import qam as PQ


def rng_for(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


def test_scramble_matches_golden():
    r = rng_for("scramble")
    b = r.integers(0, 2, (4, 300)).astype(np.uint8)
    out = np.asarray(PB.scramble(b))
    ref = np.stack([GB.scramble(x) for x in b])
    assert np.array_equal(out, ref)


def test_crc32_matches_golden():
    r = rng_for("crc")
    b = r.integers(0, 2, (5, 123)).astype(np.uint8)
    out = np.asarray(PB.crc32(b))
    ref = np.stack([GB.crc32_bits(x) for x in b])
    assert np.array_equal(out, ref)


def test_conv_encode_matches_golden():
    r = rng_for("conv")
    b = r.integers(0, 2, (3, 200)).astype(np.uint8)
    out = np.asarray(PB.conv_encode(b))
    ref = np.stack([GB.conv_encode(x) for x in b])
    assert np.array_equal(out, ref)


def test_viterbi_branch_metric_symmetry():
    """bm[1, s] == -bm[0, s]: both generator polynomials (0o133/0o171) tap
    the oldest register bit, so flipping the predecessor bit flips BOTH
    encoder outputs. The decoders exploit this (c1 = pred1 - bm0); this
    pins the table property they rely on."""
    from ofdm_uhd_tpu.phy import tables as T
    vt = T.viterbi_tables()
    a, b = np.asarray(vt["br_a"]), np.asarray(vt["br_b"])
    assert np.array_equal(a[1], 1 - a[0])
    assert np.array_equal(b[1], 1 - b[0])


def test_viterbi_matches_golden():
    r = rng_for("viterbi")
    n = 300
    msgs = r.integers(0, 2, (4, n)).astype(np.uint8)
    llrs = []
    for m in msgs:
        coded = GB.conv_encode(np.concatenate([m, np.zeros(6, np.uint8)]))
        llr = (1.0 - 2.0 * coded) + 0.7 * r.standard_normal(len(coded))
        llrs.append(llr)
    llrs = np.stack(llrs).astype(np.float32)
    out = np.asarray(PB.viterbi_decode(llrs))
    ref = np.stack([GB.viterbi_decode(l.astype(np.float64)) for l in llrs])
    assert np.array_equal(out, ref)


def test_interleave_matches_golden():
    r = rng_for("ilv")
    n_cbps = 192
    b = r.integers(0, 2, (2, n_cbps * 12)).astype(np.uint8)
    out = np.asarray(PB.interleave(b, n_cbps))
    ref = np.stack([GB.interleave(x, n_cbps) for x in b])
    assert np.array_equal(out, ref)
    back = np.asarray(PB.deinterleave(out, n_cbps))
    assert np.array_equal(back, b)


@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "qam16", "qam64", "qam256"])
def test_qam_matches_golden(mod):
    from ofdm_uhd_tpu.core.spec import MOD_BITS
    r = rng_for("qam" + mod)
    bits = r.integers(0, 2, (2, MOD_BITS[mod] * 256)).astype(np.uint8)
    syms = np.asarray(PQ.qam_map(bits, mod))
    ref = np.stack([GM.qam_map(x, mod) for x in bits])
    np.testing.assert_allclose(syms, ref, atol=1e-6)
    # noisy demap equality
    noisy = ref + 0.05 * (r.standard_normal(ref.shape)
                          + 1j * r.standard_normal(ref.shape))
    hard = np.asarray(PQ.qam_demap_hard(noisy.astype(np.complex64), mod))
    hard_ref = np.stack([GM.qam_demap_hard(x, mod) for x in noisy])
    assert np.array_equal(hard, hard_ref)
    llr = np.asarray(PQ.qam_demap_llr(noisy.astype(np.complex64), mod))
    llr_ref = np.stack([GM.qam_demap_llr(x, mod) for x in noisy])
    np.testing.assert_allclose(llr, llr_ref, atol=1e-4)


def test_chanest_smoothing_matches_golden():
    """Optional H smoothing: JAX twin == golden (flat-channel benefit only;
    biases multipath EQ at small N, so default-off — see docs)."""
    from ofdm_uhd_tpu.core.spec import config
    from ofdm_uhd_tpu.golden import modem as GM2
    from ofdm_uhd_tpu.phy import frame as PF
    r = rng_for("smooth")
    spec = config("c3").with_(chanest_smooth=7)
    g = (r.standard_normal((2, spec.n_syms, spec.n_sc))
         + 1j * r.standard_normal((2, spec.n_syms, spec.n_sc))
         ).astype(np.complex64)
    h_jax = np.asarray(PF.estimate_channel(spec, g))
    h_gold = np.stack([GM2.estimate_channel(spec, gg.astype(np.complex128))
                       for gg in g])
    np.testing.assert_allclose(h_jax, h_gold, atol=1e-4)


def test_sfo_slope_tracking():
    """Known phase slope across bins is removed when sfo_track is on, and
    golden == JAX."""
    from ofdm_uhd_tpu.core.spec import config
    from ofdm_uhd_tpu.golden import modem as GM2
    from ofdm_uhd_tpu.phy import frame as PF
    spec = config("c3").with_(sfo_track=True)
    r = rng_for("sfo")
    from ofdm_uhd_tpu.golden.bits import pilot_polarity
    pol = pilot_polarity(spec.n_data_syms)
    # synth eq_occ: pilots with polarity, data = QPSK, all rotated by
    # exp(j(a_s + b_s * k)) per symbol
    a = r.uniform(-0.5, 0.5, spec.n_data_syms)
    b = r.uniform(-0.01, 0.01, spec.n_data_syms)
    k = np.arange(spec.n_occupied)
    base = np.ones((spec.n_data_syms, spec.n_occupied), dtype=complex)
    base[:, spec.pilot_positions] = pol[:, None]
    data_syms = (1 - 2 * r.integers(0, 2, (spec.n_data_syms, spec.n_data_sc))
                 + 1j * (1 - 2 * r.integers(0, 2, (spec.n_data_syms, spec.n_data_sc)))
                 ) / np.sqrt(2)
    base[:, spec.data_positions] = data_syms
    rot = np.exp(1j * (a[:, None] + b[:, None] * k[None, :]))
    eq = base * rot

    data_g, cpe_g = GM2.track_phase(spec, eq)
    # slope+cpe removed: recovered data matches the clean symbols closely
    np.testing.assert_allclose(data_g, data_syms, atol=1e-6)
    data_j, cpe_j = PF.track_phase(spec, eq[None].astype(np.complex64))
    np.testing.assert_allclose(np.asarray(data_j)[0], data_g, atol=1e-3)
    np.testing.assert_allclose(np.asarray(cpe_j)[0], cpe_g, atol=1e-4)
    # without sfo_track the slope is NOT removed (sanity that the flag acts)
    spec0 = spec.with_(sfo_track=False)
    data_g0, _ = GM2.track_phase(spec0, eq)
    assert np.abs(data_g0 - data_syms).max() > 0.01


def test_mmse_eq_matches_golden_and_decodes():
    from ofdm_uhd_tpu.core.spec import config, ChannelSpec
    from ofdm_uhd_tpu.channel import apply_channel
    from ofdm_uhd_tpu.pipeline import TxPipeline, RxPipeline
    from ofdm_uhd_tpu.golden import GoldenModem, modem as GM2
    from ofdm_uhd_tpu.phy import frame as PF
    spec = config("c2").with_(eq_mode="mmse")
    r = rng_for("mmse")
    p = r.integers(0, 2, (8, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.asarray(TxPipeline(spec)(p))
    ch = ChannelSpec(snr_db=12.0, multipath_taps=(1.0, 0.3 - 0.2j))
    rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=i)
                      for i in range(8)])
    out = RxPipeline(spec, shift=4).rx_aligned(rx_in)
    gold = GoldenModem(spec).rx_aligned(rx_in, shift=4)
    # noise estimate agrees between twins
    g = GM2.ofdm_demodulate(spec, rx_in[0].astype(np.complex128), shift=4)
    nv_g = GM2.estimate_noise(spec, g)
    gj = PF.ofdm_demodulate(spec, rx_in.astype(np.complex64), shift=4)
    nv_j = float(np.asarray(PF.estimate_noise(spec, gj))[0])
    assert abs(nv_j - nv_g) / nv_g < 1e-3
    # decodes and agrees with golden
    assert np.asarray(out["crc_ok"]).all()
    for i, gr in enumerate(gold):
        assert gr.crc_ok and np.array_equal(np.asarray(out["payload"])[i],
                                            gr.payload)


def test_tx_windowing_matches_golden_and_decodes():
    from ofdm_uhd_tpu.core.spec import config
    from ofdm_uhd_tpu.golden import GoldenModem
    from ofdm_uhd_tpu.pipeline import TxPipeline, RxPipeline
    spec = config("c2").with_(tx_window=6)
    r = rng_for("txwin")
    p = r.integers(0, 2, (4, spec.payload_bits_per_frame)).astype(np.uint8)
    fj = np.asarray(TxPipeline(spec)(p))
    fg = GoldenModem(spec).tx(p)
    np.testing.assert_allclose(fj, fg, atol=2e-5)
    # windowing must not break demod (taper sits inside the discarded CP)
    out = RxPipeline(spec).rx_aligned(fj)
    assert np.asarray(out["crc_ok"]).all()
    assert np.array_equal(np.asarray(out["payload"]), p)
    # spectral benefit: out-of-band power drops vs unwindowed
    spec0 = config("c2")
    f0 = np.asarray(TxPipeline(spec0)(p))
    def oob_power(sig):
        s = np.fft.fft(sig[0] * np.hanning(len(sig[0])))
        n = len(s)
        # deepest guard-band region (around +-fs/2, far from occupied edge)
        band = np.r_[n // 2 - n // 32 : n // 2 + n // 32]
        return np.mean(np.abs(s[band]) ** 2)
    assert oob_power(fj) < oob_power(f0) * 0.6


@pytest.mark.parametrize("rate", ["2/3", "3/4"])
def test_punctured_fec_loopback(rate):
    """Punctured rates decode bit-exact at clean SNR, golden == JAX."""
    from ofdm_uhd_tpu.core.spec import config, ChannelSpec
    from ofdm_uhd_tpu.channel import apply_channel
    from ofdm_uhd_tpu.pipeline import TxPipeline, RxPipeline
    from ofdm_uhd_tpu.golden import GoldenModem
    spec = config("c2").with_(fec_rate=rate)
    assert spec.payload_bits_per_frame > config("c2").payload_bits_per_frame
    r = rng_for("punct" + rate)
    p = r.integers(0, 2, (6, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.asarray(TxPipeline(spec)(p))
    gold_frames = GoldenModem(spec).tx(p)
    np.testing.assert_allclose(frames, gold_frames, atol=2e-5)
    ch = ChannelSpec(snr_db=24.0, multipath_taps=(1.0, 0.2 - 0.1j))
    rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=i)
                      for i in range(6)])
    out = RxPipeline(spec, shift=4).rx_aligned(rx_in)
    assert np.asarray(out["crc_ok"]).all()
    assert np.array_equal(np.asarray(out["payload"]), p)
    gold = GoldenModem(spec).rx_aligned(rx_in, shift=4)
    assert all(g.crc_ok and np.array_equal(g.payload, pp)
               for g, pp in zip(gold, p))


def test_viterbi_windowed_equals_scan():
    """Windowed-parallel Viterbi == sequential scan decoder on real encoded
    frames across SNRs (survivors merge within the 96-step overlap)."""
    import jax.numpy as jnp
    from ofdm_uhd_tpu.phy.bits import viterbi_decode, viterbi_decode_windowed
    from ofdm_uhd_tpu.golden.bits import conv_encode as g_encode
    r = rng_for("vitwin")
    for snr_db in (0.0, 3.0, 8.0):
        bits = r.integers(0, 2, (4, 3000)).astype(np.uint8)
        coded = np.stack([g_encode(b) for b in bits]).astype(np.float64)
        tx = 1.0 - 2.0 * coded
        sigma = 10 ** (-snr_db / 20.0)
        llr = (2.0 / sigma**2) * (tx + sigma * r.standard_normal(tx.shape))
        llr = jnp.asarray(llr, dtype=jnp.float32)
        a = np.asarray(viterbi_decode(llr))
        b = np.asarray(viterbi_decode_windowed(llr))
        assert np.array_equal(a, b), f"mismatch at {snr_db} dB"


def test_viterbi_windowed_geometry_sweep():
    """Property sweep over (window, overlap) geometries (VERDICT r2 weak
    #7): windowed == scan must hold for EVERY geometry the code paths can
    select (512/96, the default of the XLA and fused decoders, plus
    off-nominal pairs), at SNRs down to the coded waterfall, so a future
    geometry change cannot silently trade exactness.

    MEASURED BOUNDARY (this test found it): at 1 dB both 128/48 AND
    128/64 diverge from the scan decoder — survivor merge is
    probabilistic PER WINDOW BOUNDARY, so shrinking the window (more
    boundaries) erodes exactness even at the same overlap. The shipped
    geometry (512/96) and 256/64 pass at waterfall SNR on flagship
    lengths; any future geometry change must re-run this gate."""
    import jax.numpy as jnp
    from ofdm_uhd_tpu.phy.bits import viterbi_decode, viterbi_decode_windowed
    from ofdm_uhd_tpu.golden.bits import conv_encode as g_encode
    r = rng_for("vitwin-geom")
    bits = r.integers(0, 2, (3, 2500)).astype(np.uint8)
    coded = np.stack([g_encode(b) for b in bits]).astype(np.float64)
    tx = 1.0 - 2.0 * coded
    for snr_db in (1.0, 6.0):
        sigma = 10 ** (-snr_db / 20.0)
        llr = (2.0 / sigma**2) * (tx + sigma * r.standard_normal(tx.shape))
        llr = jnp.asarray(llr, dtype=jnp.float32)
        a = np.asarray(viterbi_decode(llr))
        for window, overlap in ((512, 96), (256, 64),
                                (384, 80), (1000, 96)):
            b = np.asarray(viterbi_decode_windowed(llr, window, overlap))
            assert np.array_equal(a, b), \
                f"mismatch at {snr_db} dB, geometry {window}/{overlap}"
    # the sub-floor geometries MUST keep failing at waterfall SNR — if
    # this ever starts passing, the boundary claim above needs
    # re-measurement (and the safe floor could be relaxed)
    sigma = 10 ** (-1.0 / 20.0)
    llr = jnp.asarray((2.0 / sigma**2)
                      * (tx + sigma * r.standard_normal(tx.shape)),
                      dtype=jnp.float32)
    a = np.asarray(viterbi_decode(llr))
    diverged = [
        (w, o) for w, o in ((128, 48), (128, 64))
        if not np.array_equal(a, np.asarray(viterbi_decode_windowed(
            llr, w, o)))]
    assert diverged, "sub-floor geometries unexpectedly exact at 1 dB " \
        "— boundary moved?"


def test_viterbi_pallas_geometry_sweep():
    """Same sweep through the fused Pallas kernel's windowed path
    (Pallas interpreter on CPU), at the default and off-nominal
    geometries."""
    import jax.numpy as jnp
    from ofdm_uhd_tpu.phy.bits import viterbi_decode
    from ofdm_uhd_tpu.kernels.viterbi import viterbi_fused
    from ofdm_uhd_tpu.golden.bits import conv_encode as g_encode
    r = rng_for("vitpal-geom")
    bits = r.integers(0, 2, (2, 1800)).astype(np.uint8)
    coded = np.stack([g_encode(b) for b in bits]).astype(np.float64)
    tx = 1.0 - 2.0 * coded
    sigma = 10 ** (-3.0 / 20.0)
    llr = (2.0 / sigma**2) * (tx + sigma * r.standard_normal(tx.shape))
    llr = jnp.asarray(llr, dtype=jnp.float32)
    a = np.asarray(viterbi_decode(llr))
    for window, overlap in ((512, 96), (256, 64), (128, 64)):
        b = np.asarray(viterbi_fused(llr, window, overlap, interpret=True))
        assert np.array_equal(a, b), (window, overlap)


def test_viterbi_windowed_chain_bit_exact():
    """Full RX chain with viterbi_mode='windowed' decodes bit-exactly."""
    from ofdm_uhd_tpu.core.spec import ChannelSpec, config
    from ofdm_uhd_tpu.channel import apply_channel
    from ofdm_uhd_tpu.pipeline import RxPipeline, TxPipeline
    spec = config("c3").with_(viterbi_mode="windowed")
    r = rng_for("vitwin2")
    p = r.integers(0, 2, (6, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.asarray(TxPipeline(spec)(p))
    rx_in = np.stack([apply_channel(frames[i], ChannelSpec(snr_db=25.0),
                                    spec.n_sc, seed=i) for i in range(6)])
    out = RxPipeline(spec).rx_aligned(rx_in)
    assert np.asarray(out["crc_ok"]).all()
    assert np.array_equal(np.asarray(out["payload"]), p)
    ref = RxPipeline(spec.with_(viterbi_mode="scan")).rx_aligned(rx_in)
    assert np.array_equal(np.asarray(out["payload"]),
                          np.asarray(ref["payload"]))
