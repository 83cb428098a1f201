"""Full-chain equality: the fused Viterbi kernel (Pallas interpreter) in
place of the XLA decoder, through RxPipeline (SURVEY.md M3 gate).

The decoded bits must be identical, for the aligned and capture paths.
The kernel is patched into the chain's decode step, since on a CPU the
'auto' routing keeps the XLA decoder (tests/kernels/test_viterbi_kernel).
"""

import zlib

import numpy as np

from ofdm_uhd_tpu.core.spec import ChannelSpec, config
from ofdm_uhd_tpu.channel import apply_channel, make_capture
from ofdm_uhd_tpu.golden import GoldenModem
from ofdm_uhd_tpu.kernels import viterbi as KV
from ofdm_uhd_tpu.pipeline import TxPipeline, RxPipeline


def rng_for(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


def _kernel_rx(spec, monkeypatch, **kw):
    """RxPipeline whose decode step runs the fused kernel."""
    monkeypatch.setattr(KV, "viterbi", lambda llr, backend, mode:
                        KV.viterbi_fused(llr, interpret=True))
    return RxPipeline(spec, **kw)


def test_c2_aligned_backend_equality(monkeypatch):
    spec = config("c2")
    r = rng_for("be_c2")
    p = r.integers(0, 2, (6, spec.payload_bits_per_frame)).astype(np.uint8)
    fx = np.asarray(TxPipeline(spec)(p))
    ch = ChannelSpec(snr_db=22.0, multipath_taps=(1.0, 0.35 - 0.15j))
    rx_in = np.stack([apply_channel(fx[i], ch, spec.n_sc, seed=i)
                      for i in range(len(p))])
    ox = RxPipeline(spec, shift=4).rx_aligned(rx_in)
    ok = _kernel_rx(spec, monkeypatch, shift=4).rx_aligned(rx_in)
    assert np.array_equal(np.asarray(ox["payload"]), np.asarray(ok["payload"]))
    assert np.asarray(ok["crc_ok"]).all()
    assert np.array_equal(np.asarray(ok["payload"]), p)
    np.testing.assert_array_equal(np.asarray(ox["data_syms"]),
                                  np.asarray(ok["data_syms"]))


def test_c4_resampled_backend_equality(monkeypatch):
    spec = config("c4").with_(n_data_syms=4)  # keep the CPU run short
    r = rng_for("be_c4")
    p = r.integers(0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
    fx = np.asarray(TxPipeline(spec)(p))
    ox = RxPipeline(spec).rx_aligned(fx)
    ok = _kernel_rx(spec, monkeypatch).rx_aligned(fx)
    assert np.asarray(ok["crc_ok"]).all()
    assert np.array_equal(np.asarray(ox["payload"]), np.asarray(ok["payload"]))
    assert np.array_equal(np.asarray(ok["payload"]), p)


def test_c3_capture_backend_equality(monkeypatch):
    spec = config("c3")
    r = rng_for("be_c3")
    gm = GoldenModem(spec)
    p = r.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(x) for x in p])
    cap = make_capture(frames, ChannelSpec(snr_db=28.0, cfo=0.9,
                                           timing_offset=150),
                       spec.n_sc, gap=200, seed=4).astype(np.complex64)
    ox = RxPipeline(spec).rx_capture(cap, max_frames=4)
    # two captures in one dispatch: the kernel decodes all 2 x 4 slots
    ok = _kernel_rx(spec, monkeypatch).rx_capture(np.stack([cap, cap]),
                                                  max_frames=4)
    for i in range(2):
        assert np.array_equal(np.asarray(ox["valid"]),
                              np.asarray(ok["valid"])[i])
        assert np.asarray(ok["valid"])[i].sum() == 3
        assert np.array_equal(np.asarray(ok["payload"])[i, :3], p)
        np.testing.assert_array_equal(np.asarray(ox["crc_ok"]),
                                      np.asarray(ok["crc_ok"])[i])
