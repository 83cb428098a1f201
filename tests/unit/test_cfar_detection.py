"""Noise-floor-adaptive (CFAR) S&C threshold (VERDICT r3 item 7).

The fixed threshold=0.5 misses preambles once the plateau height
(snr/(1+snr))^2 drops under it (~0 dB); CFAR keys the threshold off the
capture's own metric floor instead. Gates: (1) CFAR detects at an SNR
where fixed misses, (2) pure noise still yields ZERO detections (the
false-alarm side), (3) clean captures behave identically under both.
"""

import numpy as np
import pytest

from ofdm_uhd_tpu.channel import make_capture
from ofdm_uhd_tpu.core.spec import ChannelSpec, config
from ofdm_uhd_tpu.golden import GoldenModem
from ofdm_uhd_tpu.pipeline.rx import RxPipeline


def _capture(spec, n_frames, snr_db, seed):
    rng = np.random.default_rng(seed)
    gm = GoldenModem(spec)
    payloads = rng.integers(0, 2, (n_frames, spec.payload_bits_per_frame)
                            ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    ch = ChannelSpec(snr_db=snr_db, timing_offset=400)
    cap = make_capture(frames, ch, spec.n_sc, gap=800, seed=seed)
    return cap.astype(np.complex64), payloads


@pytest.mark.parametrize("cfg,snr_db", [("c1", 2.0), ("c3", 0.0)])
def test_cfar_detects_below_fixed_threshold(cfg, snr_db):
    """c1 (L=32): at 2 dB the plateau peaks (0.46-0.68, measured) dip
    under the fixed 0.5 while CFAR's 16x-median (~0.34) catches all.
    c3 (L=128): the metric floor is 4x lower, so CFAR detects at 0 dB.
    At L=32 the noise tail itself reaches ~18x median, so sub-0 dB
    detection there is physically threshold-ambiguous — the sweep bench
    measures that tradeoff instead of gating it."""
    spec = config(cfg)
    cap, _ = _capture(spec, 5, snr_db, seed=3)
    fixed = RxPipeline(spec)
    cfar = RxPipeline(spec, sync_threshold_mode="cfar")
    n_fixed = int(np.asarray(
        fixed.rx_capture(cap, max_frames=8)["valid"]).sum())
    n_cfar = int(np.asarray(
        cfar.rx_capture(cap, max_frames=8)["valid"]).sum())
    # the plateau at <=0 dB sits mostly under 0.5: the fixed threshold
    # drops frames, CFAR recovers every preamble (decode may still fail
    # CRC — that is the FEC's regime, not detection's)
    assert n_cfar == 5
    assert n_fixed < n_cfar


def test_cfar_pure_noise_no_false_alarms():
    spec = config("c1")
    rng = np.random.default_rng(9)
    noise = (rng.normal(size=50000) + 1j * rng.normal(size=50000)
             ).astype(np.complex64) * 0.3
    cfar = RxPipeline(spec, sync_threshold_mode="cfar")
    out = cfar.rx_capture(noise, max_frames=8)
    assert int(np.asarray(out["valid"]).sum()) == 0
    assert int(np.asarray(out["crc_ok"]).sum()) == 0


def test_cfar_matches_fixed_on_clean_capture():
    spec = config("c3")
    cap, payloads = _capture(spec, 4, 25.0, seed=5)
    fixed = RxPipeline(spec).rx_capture(cap, max_frames=6)
    cfar = RxPipeline(spec, sync_threshold_mode="cfar").rx_capture(
        cap, max_frames=6)
    np.testing.assert_array_equal(np.asarray(fixed["valid"]),
                                  np.asarray(cfar["valid"]))
    np.testing.assert_array_equal(np.asarray(fixed["d"]),
                                  np.asarray(cfar["d"]))
    assert np.asarray(cfar["crc_ok"]).sum() == 4
    assert np.array_equal(
        np.asarray(cfar["payload"])[np.asarray(cfar["valid"])], payloads)


def test_cfar_streaming_plumbing():
    """StreamRx(threshold_mode='cfar') reaches the shard detector (the
    (threshold, mode) tuple path) and decodes a clean stream identically
    to fixed mode."""
    import jax
    from ofdm_uhd_tpu.pipeline.stream import StreamRx
    from ofdm_uhd_tpu.shard.mesh import make_mesh
    spec = config("c5")
    gm = GoldenModem(spec)
    rng = np.random.default_rng(4)
    pls = rng.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    stream = np.concatenate(
        [np.zeros(400, np.complex64)]
        + [np.concatenate([gm.modulate_frame(p).astype(np.complex64),
                           np.zeros(500, np.complex64)]) for p in pls])
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    chunk = 2 * max(spec.frame_len + spec.n_sc, spec.frame_len + spec.cp)
    out = {}
    for mode in ("fixed", "cfar"):
        rx = StreamRx(spec, mesh=mesh, chunk_len=chunk, threshold_mode=mode)
        got = rx.process(stream) + rx.flush()
        assert len(got) == 3 and all(
            g.crc_ok and np.array_equal(g.payload, p)
            for g, p in zip(got, pls)), mode
        out[mode] = [(g.start, bytes(g.payload)) for g in got]
    assert out["fixed"] == out["cfar"]
