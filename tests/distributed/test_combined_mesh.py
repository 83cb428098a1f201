"""Combined 2-D ('frame','time') mesh operation (VERDICT r3 item 6).

Every earlier test exercised degenerate meshes (frame x 1 or 1 x time).
SURVEY.md §2.3 defines the mesh as TWO first-class axes; these tests run
the frame-parallel batched RX and the time-parallel streaming receiver on
the SAME live (2, 4) mesh and assert both remain bit-exact vs their
unsharded references — i.e. the shardings compose (each workload's specs
leave the other axis replicated) rather than requiring a dedicated mesh
shape per workload.
"""

import numpy as np
import pytest

import jax

from ofdm_uhd_tpu.core.spec import ChannelSpec, config
from ofdm_uhd_tpu.channel import make_capture
from ofdm_uhd_tpu.golden import GoldenModem
from ofdm_uhd_tpu.pipeline.stream import StreamRx
from ofdm_uhd_tpu.pipeline.rx import RxPipeline
from ofdm_uhd_tpu.shard.mesh import make_mesh
from ofdm_uhd_tpu.shard.frame_parallel import rx_frames_sharded


@pytest.fixture(scope="module")
def mesh2d():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(2, 4)


def _tx_batch(spec, batch, seed=0, snr=25.0):
    rng = np.random.default_rng(seed)
    gm = GoldenModem(spec)
    payloads = rng.integers(0, 2, (batch, spec.payload_bits_per_frame)
                            ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    from ofdm_uhd_tpu.channel import apply_channel
    rx = np.stack([apply_channel(frames[i], ChannelSpec(snr_db=snr),
                                 spec.n_sc, seed=i) for i in range(batch)])
    return rx.astype(np.complex64), payloads


def test_frame_parallel_on_2d_mesh(mesh2d):
    """Batch sharded over 'frame' (size 2), replicated over 'time' (4):
    payloads and psum'd metrics match the unsharded pipeline exactly."""
    spec = config("c1").with_(n_data_syms=4)
    frames, payloads = _tx_batch(spec, batch=6)
    out = rx_frames_sharded(spec, mesh2d)(frames)
    assert int(jax.device_get(out["n_ok_global"])) == 6
    assert np.array_equal(np.asarray(out["payload"]), payloads)

    ref = RxPipeline(spec).rx_aligned(frames)
    assert np.array_equal(np.asarray(out["payload"]),
                          np.asarray(ref["payload"]))
    np.testing.assert_array_equal(np.asarray(out["crc_ok"]),
                                  np.asarray(ref["crc_ok"]))


def test_streaming_on_2d_mesh(mesh2d):
    """The time-parallel stream sharded over 'time' (4), replicated over
    'frame' (2), on the same mesh object: decoded frames identical to the
    1-device run (the r3 invariant, now on a non-degenerate mesh)."""
    spec = config("c5")
    rng = np.random.default_rng(11)
    gm = GoldenModem(spec)
    payloads = rng.integers(0, 2, (6, spec.payload_bits_per_frame)
                            ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    ch = ChannelSpec(snr_db=26.0, cfo=0.4, timing_offset=500)
    cap = make_capture(frames, ch, spec.n_sc, gap=600, seed=3
                       ).astype(np.complex64)

    h = spec.frame_len + spec.n_sc
    chunk = 4 * max(2 * h, 4 * spec.frame_len)

    rx2d = StreamRx(spec, mesh=mesh2d, chunk_len=chunk)
    got = rx2d.process(cap) + rx2d.flush()

    mesh1 = make_mesh(1, 1, devices=jax.devices()[:1])
    rx1 = StreamRx(spec, mesh=mesh1, chunk_len=chunk)
    ref = rx1.process(cap) + rx1.flush()

    assert len(got) == len(ref) == 6
    for a, b, p in zip(got, ref, payloads):
        assert a.start == b.start
        assert a.crc_ok and b.crc_ok
        assert np.array_equal(a.payload, b.payload)
        assert np.array_equal(a.payload, p)


def test_both_workloads_share_one_mesh(mesh2d):
    """Interleaved use: the same mesh serves a frame-sharded batch decode
    and a time-sharded stream step in one process, with no re-meshing."""
    spec_b = config("c1").with_(n_data_syms=4)
    frames, payloads = _tx_batch(spec_b, batch=4, seed=7)
    batch_fn = rx_frames_sharded(spec_b, mesh2d)

    spec_s = config("c5")
    h = spec_s.frame_len + spec_s.n_sc
    chunk = 4 * max(2 * h, 4 * spec_s.frame_len)
    stream_rx = StreamRx(spec_s, mesh=mesh2d, chunk_len=chunk)

    gm = GoldenModem(spec_s)
    pls = np.random.default_rng(8).integers(
        0, 2, (2, spec_s.payload_bits_per_frame)).astype(np.uint8)
    stream = np.concatenate(
        [np.zeros(300, np.complex64)]
        + [np.concatenate([gm.modulate_frame(p).astype(np.complex64),
                           np.zeros(400, np.complex64)]) for p in pls])

    out_b = batch_fn(frames)                  # frame-sharded dispatch
    got_s = stream_rx.process(stream) + stream_rx.flush()  # time-sharded
    assert np.array_equal(np.asarray(out_b["payload"]), payloads)
    assert len(got_s) == 2 and all(
        g.crc_ok and np.array_equal(g.payload, p)
        for g, p in zip(got_s, pls))


def test_halo_2d_mesh_coords(mesh2d):
    """The overlap-save halo exchange on the 2-D mesh: along 'time' each
    shard receives its right neighbour's head, independently in every
    'frame' row; the last time shard receives zeros."""
    from jax.sharding import PartitionSpec as P
    from ofdm_uhd_tpu.shard.time_parallel import halo_from_right
    h = 128
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4 * h))
         + 1j * rng.standard_normal((2, 4 * h))).astype(np.complex64)

    def body(block):
        return halo_from_right(block[0, :h], "time")[None]

    got = np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh2d, in_specs=P("frame", "time"),
        out_specs=P("frame", "time"), check_vma=False))(x))
    blocks = x.reshape(2, 4, h)                       # [frame, time, h]
    want = np.concatenate([blocks[:, 1:], np.zeros_like(blocks[:, :1])],
                          axis=1).reshape(2, 4 * h)
    np.testing.assert_array_equal(got, want)
