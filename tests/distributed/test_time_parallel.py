"""C5 semantics on the virtual 8-device CPU mesh (SURVEY.md §4).

The load-bearing invariant: the sharded streaming chain produces the SAME
decoded frames as (a) a 1-device mesh and (b) the golden capture receiver —
overlap-save halos and ownership rules must be exact.
"""

import zlib

import numpy as np
import pytest

import jax

from ofdm_uhd_tpu.core.spec import ChannelSpec, config
from ofdm_uhd_tpu.channel import make_capture
from ofdm_uhd_tpu.golden import GoldenModem
from ofdm_uhd_tpu.pipeline.stream import StreamRx
from ofdm_uhd_tpu.shard.mesh import make_mesh


def rng_for(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


def _make_stream(spec, n_frames, seed, gap=500, offset=700):
    r = rng_for(f"stream{seed}")
    gm = GoldenModem(spec)
    payloads = r.integers(0, 2, (n_frames, spec.payload_bits_per_frame)
                          ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    ch = ChannelSpec(snr_db=26.0, cfo=0.7, phase_noise_std=2e-4,
                     timing_offset=offset)
    cap = make_capture(frames, ch, spec.n_sc, gap=gap, seed=seed)
    return cap.astype(np.complex64), payloads


def _run(spec, cap, n_time, chunk_len):
    mesh = make_mesh(1, n_time, devices=jax.devices()[:n_time])
    rx = StreamRx(spec, mesh=mesh, chunk_len=chunk_len)
    frames = rx.process(cap)
    frames += rx.flush()
    return frames, rx


def test_sharded_equals_single_device():
    spec = config("c5")
    cap, payloads = _make_stream(spec, 10, seed=1)
    h = 4032 + 256
    chunk8 = 8 * max(2 * h, 4 * spec.frame_len)
    f8, rx8 = _run(spec, cap, 8, chunk8)
    f1, rx1 = _run(spec, cap, 1, chunk8)  # same chunking, one device
    assert len(f8) == len(f1) == 10
    for a, b in zip(f8, f1):
        assert a.start == b.start
        assert a.crc_ok and b.crc_ok
        assert np.array_equal(a.payload, b.payload)
    # and the decoded payloads are the transmitted ones, in order
    for fr, p in zip(f8, payloads):
        assert np.array_equal(fr.payload, p)
    # pod counters agree
    assert int(np.asarray(rx8.state.crc_ok)) == 10
    assert int(np.asarray(rx1.state.crc_ok)) == 10


def test_reshard_point_bit_exact():
    """SURVEY.md §2.3 Ulysses-analog reshard: all_to_all load-balancing of
    frame slots at the sync->demod boundary must not change a single bit —
    the exchange is inverted on the per-frame outputs after demod."""
    spec = config("c5")
    cap, payloads = _make_stream(spec, 10, seed=1)
    chunk = 8 * max(2 * (4032 + 256), 4 * spec.frame_len)
    mesh = make_mesh(1, 8)
    rx_r = StreamRx(spec, mesh=mesh, chunk_len=chunk, reshard=True)
    fr = rx_r.process(cap) + rx_r.flush()
    rx_p = StreamRx(spec, mesh=mesh, chunk_len=chunk)
    fp = rx_p.process(cap) + rx_p.flush()
    assert len(fr) == len(fp) == 10
    for a, b in zip(fr, fp):
        assert a.start == b.start
        assert a.crc_ok and b.crc_ok
        assert np.array_equal(a.payload, b.payload)
        assert a.evm_db == b.evm_db


def test_frames_straddling_all_boundaries():
    """Gap/offset chosen so frames land on shard and chunk boundaries."""
    spec = config("c5")
    h = 4032 + 256
    chunk = 8 * 2 * h
    cb = chunk // 8
    # place frames deliberately: one fully inside shard 0, one straddling
    # the shard-0/1 boundary, one straddling the chunk boundary
    gm = GoldenModem(spec)
    r = rng_for("straddle")
    payloads = r.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = [gm.modulate_frame(p) for p in payloads]
    stream = np.zeros(2 * chunk, dtype=np.complex64)
    starts = [500, cb - spec.frame_len // 2, chunk - spec.frame_len // 3]
    for s, f in zip(starts, frames):
        stream[s : s + spec.frame_len] += f.astype(np.complex64)
    noise = (rng_for("straddlen").standard_normal(len(stream))
             + 1j * rng_for("straddlen2").standard_normal(len(stream))
             ).astype(np.complex64) * 0.01
    stream = stream + noise
    rx = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk)
    got = rx.process(stream) + rx.flush()
    assert len(got) == 3, [g.start for g in got]
    for g, s, p in zip(got, starts, payloads):
        assert abs(g.start - s) <= spec.cp
        assert g.crc_ok
        assert np.array_equal(g.payload, p)


def test_stream_matches_golden_capture_rx():
    spec = config("c5")
    cap, payloads = _make_stream(spec, 6, seed=3)
    f8, _ = _run(spec, cap, 8, 8 * 2 * (4032 + 256))
    gold = GoldenModem(spec).rx_capture(cap.astype(np.complex128))
    assert len(f8) == len(gold) == 6
    for fr, (d, eps, res) in zip(f8, gold):
        assert abs(fr.start - d) <= spec.cp
        assert np.array_equal(fr.payload, res.payload)


def test_checkpoint_resume(tmp_path):
    """SURVEY.md §5.4: resume mid-stream reproduces the remaining frames."""
    spec = config("c5")
    cap, payloads = _make_stream(spec, 8, seed=4)
    chunk = 8 * 2 * (4032 + 256)
    rx = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk)
    # full run
    full = rx.process(cap) + rx.flush()
    # split run with save/restore between chunks
    rx1 = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk)
    cut = 2 * chunk
    part1 = rx1.process(cap[:cut])
    rx1.save_state(str(tmp_path / "st.npz"))
    rx2 = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk)
    rx2.load_state(str(tmp_path / "st.npz"))
    part2 = rx2.process(cap[cut:]) + rx2.flush()
    got = part1 + part2
    assert len(got) == len(full) == 8
    for a, b in zip(got, full):
        assert a.start == b.start and np.array_equal(a.payload, b.payload)


def test_multi_step_dispatch_bit_exact():
    """VERDICT r2 item 1: the device-resident K-step scan (one dispatch
    per K chunks) must reproduce the single-step path bit-for-bit —
    including the carried tracker state, ownership accounting, and the
    global sample timebase — under awkward feed boundaries."""
    spec = config("c5")
    cap, payloads = _make_stream(spec, 10, seed=6)
    chunk = 8 * 2 * (4032 + 256)
    rx1 = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk,
                   steps_per_dispatch=1)
    f1 = rx1.process(cap) + rx1.flush()
    rxk = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk,
                   steps_per_dispatch=3)
    fk = []
    step = len(cap) // 3 + 17                 # misaligned feed pieces
    for lo in range(0, len(cap), step):
        fk += rxk.process(cap[lo:lo + step])
    fk += rxk.flush()
    assert len(f1) == len(fk) == 10
    for a, b in zip(f1, fk):
        assert a.start == b.start and a.crc_ok == b.crc_ok
        assert np.array_equal(a.payload, b.payload)
        assert a.eps == b.eps and a.evm_db == b.evm_db
    for fr, p in zip(fk, payloads):
        assert np.array_equal(fr.payload, p)
    assert int(np.asarray(rxk.state.crc_ok)) == 10


def test_sc16_stream_matches_fc32():
    """Radio-native sc16 streaming (int16 IQ planes, on-device conversion)
    must decode the same frames as the fc32 path fed the identically
    quantized complex samples — single and K-step dispatch, sharded."""
    spec = config("c5")
    cap, payloads = _make_stream(spec, 8, seed=11)
    planes = np.stack([cap.real, cap.imag])
    iq = np.round(planes * (32767.0 / np.max(np.abs(planes)))
                  ).astype(np.int16)
    deq = ((iq[0].astype(np.float32) + 1j * iq[1].astype(np.float32))
           / 32767.0).astype(np.complex64)
    chunk = 8 * 2 * (4032 + 256)
    ref = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk,
                   steps_per_dispatch=2)
    f_ref = ref.process(deq) + ref.flush()
    rx = StreamRx(spec, mesh=make_mesh(1, 8), chunk_len=chunk,
                  steps_per_dispatch=2, input_format="sc16")
    # misaligned feed pieces exercise the [2, n] remainder buffer
    fk = []
    step = iq.shape[1] // 3 + 29
    for lo in range(0, iq.shape[1], step):
        fk += rx.process(iq[:, lo:lo + step])
    fk += rx.flush()
    assert len(f_ref) == len(fk) == 8
    for a, b in zip(f_ref, fk):
        assert a.start == b.start and a.crc_ok == b.crc_ok
        assert np.array_equal(a.payload, b.payload)
    for fr, p in zip(fk, payloads):
        assert np.array_equal(fr.payload, p)


def test_multi_step_rational_resample_and_resume(tmp_path):
    """K-step dispatch with the carried radio tail (rational L/M resample)
    plus checkpoint/resume cut mid-K-group."""
    spec = config("c4").with_(n_data_syms=4, resample_l=8, resample_m=3)
    r = rng_for("c4rat-k")
    gm = GoldenModem(spec)
    payloads = r.integers(0, 2, (4, spec.payload_bits_per_frame)).astype(np.uint8)
    from ofdm_uhd_tpu.golden import resample as GR
    h_proto = GR.design_lowpass(spec.resample_l, spec.resample_m)
    parts = [np.zeros(4000, complex)]
    for p in payloads:
        parts.append(GR.resample(gm.modulate_frame(p), spec.resample_l,
                                 spec.resample_m, h_proto))
        parts.append(np.zeros(6000, complex))
    stream = np.concatenate(parts).astype(np.complex64)

    h = spec.frame_len + spec.n_sc
    cb = -(-max(h + 64, 2 * h) // 3) * 3
    rx1 = StreamRx(spec, mesh=make_mesh(1, 4), chunk_len=4 * cb,
                   steps_per_dispatch=1)
    f1 = rx1.process(stream) + rx1.flush()
    rxk = StreamRx(spec, mesh=make_mesh(1, 4), chunk_len=4 * cb,
                   steps_per_dispatch=2)
    cut = 3 * rxk.radio_chunk  # not a multiple of K*radio_chunk
    fk = rxk.process(stream[:cut])
    rxk.save_state(str(tmp_path / "k.npz"))
    rxr = StreamRx(spec, mesh=make_mesh(1, 4), chunk_len=4 * cb,
                   steps_per_dispatch=2)
    rxr.load_state(str(tmp_path / "k.npz"))
    fk += rxr.process(stream[cut:]) + rxr.flush()
    assert len(f1) == len(fk) == 4
    for a, b in zip(f1, fk):
        assert a.start == b.start and np.array_equal(a.payload, b.payload)


def test_c4_radio_rate_stream_sharded():
    """BASELINE.json C4 as a continuous stream: 1024-SC frames at 8x radio
    rate, in-stream polyphase decimation + overlap-save sharding."""
    spec = config("c4").with_(n_data_syms=4)  # keep CPU runtime sane
    r = rng_for("c4stream")
    gm = GoldenModem(spec)
    payloads = r.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    # interpolate to radio rate like the TX does, with gaps
    from ofdm_uhd_tpu.golden import resample as GR
    h_proto = GR.design_lowpass(spec.resample_l, 1)
    parts = [np.zeros(4000, complex)]
    for f in frames:
        parts.append(GR.resample(f, spec.resample_l, 1, h_proto))
        parts.append(np.zeros(6000, complex))
    stream = np.concatenate(parts)
    noise = 0.003 * (rng_for("c4n").standard_normal(len(stream))
                     + 1j * rng_for("c4n2").standard_normal(len(stream)))
    stream = (stream + noise).astype(np.complex64)

    h = spec.frame_len + spec.n_sc
    rx = StreamRx(spec, mesh=make_mesh(1, 4), chunk_len=4 * max(h + 64, 2 * h))
    got = rx.process(stream) + rx.flush()
    assert len(got) == 3, [g.start for g in got]
    for g, p in zip(got, payloads):
        assert g.crc_ok
        assert np.array_equal(g.payload, p)
    # sharded == single-device on the same radio stream
    rx1 = StreamRx(spec, mesh=make_mesh(1, 1), chunk_len=rx.chunk_len)
    got1 = rx1.process(stream) + rx1.flush()
    assert len(got1) == 3
    for a, b in zip(got, got1):
        assert a.start == b.start and np.array_equal(a.payload, b.payload)


def test_rational_resample_stream_sharded():
    """SURVEY.md §2.1 #19 general case: rational L/M = 8/3 radio rate in
    the continuous stream — in-stream rational polyphase resampling with
    the carried radio tail, sharded == single-device bit-exact."""
    spec = config("c4").with_(n_data_syms=4, resample_l=8, resample_m=3)
    r = rng_for("c4rat")
    gm = GoldenModem(spec)
    payloads = r.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    from ofdm_uhd_tpu.golden import resample as GR
    h_proto = GR.design_lowpass(spec.resample_l, spec.resample_m)
    parts = [np.zeros(4000, complex)]
    for f in frames:
        parts.append(GR.resample(f, spec.resample_l, spec.resample_m, h_proto))
        parts.append(np.zeros(6000, complex))
    stream = np.concatenate(parts)
    noise = 0.003 * (rng_for("c4ratn").standard_normal(len(stream))
                     + 1j * rng_for("c4ratn2").standard_normal(len(stream)))
    stream = (stream + noise).astype(np.complex64)

    h = spec.frame_len + spec.n_sc
    cb = -(-max(h + 64, 2 * h) // 3) * 3
    rx = StreamRx(spec, mesh=make_mesh(1, 4), chunk_len=4 * cb)
    got = rx.process(stream) + rx.flush()
    assert len(got) == 3, [g.start for g in got]
    for g, p in zip(got, payloads):
        assert g.crc_ok
        assert np.array_equal(g.payload, p)
    rx1 = StreamRx(spec, mesh=make_mesh(1, 1), chunk_len=rx.chunk_len)
    got1 = rx1.process(stream) + rx1.flush()
    assert len(got1) == 3
    for a, b in zip(got, got1):
        assert a.start == b.start and np.array_equal(a.payload, b.payload)


def test_step_paths_share_one_compiled_state_layout():
    """A stream alternates the single-step and K-step executables (the
    K-step groups, then the stragglers and flush). The state either one
    returns must feed the other without a new compilation: on a GPU
    mesh each one is seconds, once per alternation."""
    spec = config("c1").with_(n_data_syms=4)
    rx = StreamRx(spec, mesh=make_mesh(1, 4, devices=jax.devices()[:4]),
                  steps_per_dispatch=2)
    one = rx._put_chunk(np.zeros(rx.radio_chunk, np.complex64))
    two = rx._put_chunk(np.zeros((2, rx.radio_chunk), np.complex64))
    state = rx.state
    for fn, chunk in ((rx._multi, two), (rx._step, one), (rx._multi, two),
                      (rx._step, one), (rx._step, one), (rx._multi, two)):
        state, _ = fn(state, chunk)
    assert rx._step._cache_size() == 1
    # the K-step executable also compiled once for the host-side initial
    # state of StreamState.init
    assert rx._multi._cache_size() <= 2
