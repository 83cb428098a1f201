"""complex64 crosses every executable boundary as itself: through jit
arguments and results, device_put, the StreamRx chunk feed and the
StreamState .npz checkpoint, with no planar re-encoding."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np

from ofdm_uhd_tpu.core.spec import ChannelSpec, config
from ofdm_uhd_tpu.core.state import StreamState
from ofdm_uhd_tpu.channel import apply_channel, make_capture
from ofdm_uhd_tpu.golden import GoldenModem


def _payloads(spec, n):
    rng = np.random.default_rng(zlib.crc32(b"complex-io") % 2**31)
    return rng.integers(0, 2, (n, spec.payload_bits_per_frame)
                        ).astype(np.uint8)


def test_jit_and_device_put_roundtrip():
    tree = {"c": (np.arange(6) + 1j * np.arange(6)).astype(np.complex64),
            "f": np.float32(3.5), "i": np.arange(4, dtype=np.int32)}
    dev = jax.device_put(tree)
    assert dev["c"].dtype == jnp.complex64
    out = jax.jit(lambda t: jax.tree.map(lambda v: v, t))(dev)
    host = jax.device_get(out)
    assert host["c"].dtype == np.complex64
    np.testing.assert_array_equal(host["c"], tree["c"])
    np.testing.assert_array_equal(np.asarray(jax.jit(jnp.conj)(tree["c"])),
                                  np.conj(tree["c"]))
    assert host["f"] == tree["f"]
    np.testing.assert_array_equal(host["i"], tree["i"])


def test_tx_rx_complex_bit_exact():
    from ofdm_uhd_tpu.pipeline import RxPipeline, TxPipeline
    spec = config("c2")
    payloads = _payloads(spec, 8)
    tx_out = TxPipeline(spec)(payloads)
    assert tx_out.dtype == jnp.complex64
    frames = np.asarray(tx_out)
    assert np.allclose(frames, GoldenModem(spec).tx(payloads), atol=2e-6)
    rx_in = np.stack([apply_channel(frames[i], ChannelSpec(snr_db=22.0),
                                    spec.n_sc, seed=i)
                      for i in range(8)]).astype(np.complex64)
    out = RxPipeline(spec).rx_aligned(rx_in)
    assert out["h"].dtype == jnp.complex64
    assert np.asarray(out["crc_ok"]).all()
    np.testing.assert_array_equal(np.asarray(out["payload"]), payloads)


def test_rx_capture_from_device_array():
    from ofdm_uhd_tpu.pipeline import RxPipeline
    spec = config("c3")
    payloads = _payloads(spec, 4)
    gm = GoldenModem(spec)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    cap = make_capture(frames, ChannelSpec(snr_db=28.0, cfo=0.6,
                                           timing_offset=80),
                       spec.n_sc, gap=250, seed=5).astype(np.complex64)
    out = RxPipeline(spec).rx_capture(jax.device_put(cap), max_frames=6)
    assert np.asarray(out["crc_ok"]).sum() == 4
    np.testing.assert_array_equal(np.asarray(out["payload"])[:4], payloads)


def test_stream_sharded_feed_bit_exact():
    """Complex chunks sharded over a 4-device time axis decode the same
    frames as one device."""
    from ofdm_uhd_tpu.pipeline.stream import StreamRx
    from ofdm_uhd_tpu.shard.mesh import make_mesh
    spec = config("c5")
    gm = GoldenModem(spec)
    payloads = _payloads(spec, 5)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    cap = make_capture(frames, ChannelSpec(snr_db=25.0, cfo=0.5,
                                           timing_offset=400),
                       spec.n_sc, gap=600, seed=9).astype(np.complex64)
    h = spec.frame_len + spec.n_sc
    chunk = 4 * max(2 * h, 4 * spec.frame_len)
    got = {}
    for t in (4, 1):
        rx = StreamRx(spec, mesh=make_mesh(1, t, devices=jax.devices()[:t]),
                      chunk_len=chunk)
        got[t] = rx.process(cap) + rx.flush()
    assert len(got[4]) == len(got[1]) == 5
    for a, b, p in zip(got[4], got[1], payloads):
        assert a.start == b.start and a.crc_ok and b.crc_ok
        np.testing.assert_array_equal(a.payload, b.payload)
        np.testing.assert_array_equal(a.payload, p)


def test_checkpoint_roundtrip_complex_state(tmp_path):
    from ofdm_uhd_tpu.pipeline.stream import StreamRx
    from ofdm_uhd_tpu.shard.mesh import make_mesh
    spec = config("c5")
    gm = GoldenModem(spec)
    payloads = _payloads(spec, 4)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    cap = make_capture(frames, ChannelSpec(snr_db=25.0), spec.n_sc,
                       gap=500, seed=3).astype(np.complex64)
    rx = StreamRx(spec, mesh=make_mesh(1, 2))
    cut = 2 * rx.radio_chunk
    got = rx.process(cap[:cut])
    rx.save_state(str(tmp_path / "st.npz"))
    z = np.load(tmp_path / "st.npz")
    assert z["tail"].dtype == np.complex64
    np.testing.assert_array_equal(z["h_track"], np.asarray(rx.state.h_track))
    rx2 = StreamRx(spec, mesh=make_mesh(1, 2))
    rx2.load_state(str(tmp_path / "st.npz"))
    got += rx2.process(cap[cut:]) + rx2.flush()
    assert len(got) == 4
    assert all(g.crc_ok and np.array_equal(g.payload, p)
               for g, p in zip(got, payloads))
    # StreamState's own save/load keeps complex leaves exactly
    rx2.state.save(str(tmp_path / "s2.npz"))
    back = StreamState.load(str(tmp_path / "s2.npz"))
    np.testing.assert_array_equal(back.h_track, np.asarray(rx2.state.h_track))
    assert back.tail.dtype == np.complex64
