"""The fused Viterbi kernel (kernels/viterbi.py) through the Pallas
interpreter against the XLA scan and windowed decoders, and the routing
that picks it.

The kernel has no CPU compilation: interpret=True is requested here and
nowhere in the program, and on a CPU the routed decode never reaches it.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ofdm_uhd_tpu.core.spec import ChannelSpec, config
from ofdm_uhd_tpu.golden import bits as GB
from ofdm_uhd_tpu.kernels import viterbi as KV
from ofdm_uhd_tpu.phy import bits as PB

fused = functools.partial(KV.viterbi_fused, interpret=True)


def rng_for(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


def _llrs(name, batch, n, snr_db=3.0):
    """Encoded random messages (tail-terminated) through AWGN -> llr
    [batch, 2n] f32, and the messages [batch, n]."""
    r = rng_for(name)
    msgs = r.integers(0, 2, (batch, n)).astype(np.uint8)
    msgs[:, -6:] = 0
    coded = np.stack([GB.conv_encode(m) for m in msgs]).astype(np.float64)
    sigma = 10 ** (-snr_db / 20.0)
    llr = (2.0 / sigma ** 2) * ((1.0 - 2.0 * coded)
                                + sigma * r.standard_normal(coded.shape))
    return jnp.asarray(llr, jnp.float32), msgs


@pytest.mark.parametrize("cfg", ["c1", "c2", "c3", "c4", "c5"])
def test_kernel_matches_xla_at_config_trellis(cfg):
    """Each config's trellis length (uncoded bits per frame)."""
    n = config(cfg).uncoded_bits_per_frame
    llr, msgs = _llrs(f"vk{cfg}", 2, n, snr_db=5.0)     # decodable frames
    got = np.asarray(fused(llr))
    np.testing.assert_array_equal(got, np.asarray(
        PB.viterbi_decode_windowed(llr)))
    scan = np.asarray(PB.viterbi_decode(llr))
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(scan, msgs)


@pytest.mark.parametrize("n,batch", [
    (PB.WINDOW + 2 * PB.OVERLAP, 3),        # the longest one-window trellis
    (PB.WINDOW + 2 * PB.OVERLAP + 1, 3),    # the shortest two-window one
    (100, 33),                              # short; lanes pad past a block
    (2 * PB.WINDOW + 7, 1),                 # ragged last window
])
def test_kernel_tail_geometries(n, batch):
    llr, _ = _llrs(f"vktail{n}", batch, n, snr_db=1.0)
    got = np.asarray(fused(llr))
    assert got.shape == (batch, n) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(
        PB.viterbi_decode_windowed(llr)))
    if n <= PB.WINDOW + 2 * PB.OVERLAP:
        np.testing.assert_array_equal(got, np.asarray(
            PB.viterbi_decode(llr)))


@pytest.mark.parametrize("kind", ["zeros", "integer"])
def test_kernel_ties(kind):
    """Exact metric ties (every compare ties on all-zero LLRs; integer
    LLRs tie often) break toward predecessor 0 as in the XLA decoders,
    and an interior window's entry state is the first best one."""
    n, b = 1500, 2
    if kind == "zeros":
        llr = jnp.zeros((b, 2 * n), jnp.float32)
    else:
        llr = jnp.asarray(rng_for("vkties").integers(-2, 3, (b, 2 * n)),
                          jnp.float32)
    np.testing.assert_array_equal(np.asarray(fused(llr)), np.asarray(
        PB.viterbi_decode_windowed(llr)))


def test_auto_on_cpu_is_the_xla_decoder():
    """'auto' on a CPU-placed computation decodes with the XLA decoder
    that 'xla' picks, bit for bit, for both viterbi modes."""
    llr, _ = _llrs("vkauto", 3, 1200, snr_db=0.5)
    for mode in ("scan", "windowed"):
        a = jax.jit(functools.partial(KV.viterbi, backend="auto",
                                      mode=mode))(llr)
        x = jax.jit(functools.partial(KV.viterbi, backend="xla",
                                      mode=mode))(llr)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(x))


def _lowered_text(backend, platform):
    x = jax.ShapeDtypeStruct((4, 2 * 800), jnp.float32)
    f = jax.jit(functools.partial(KV.viterbi, backend=backend, mode="scan"))
    return f.trace(x).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("backend,platform,kernel", [
    ("auto", "cuda", True),
    ("auto", "cpu", False),
    ("xla", "cuda", False),
    ("xla", "cpu", False),
])
def test_routing_keys_on_the_lowering_platform(backend, platform, kernel):
    """The choice is made by the platform the computation is lowered
    for, not by the process's default backend: the fused kernel's Triton
    call appears only in an 'auto' lowering for CUDA, and there the XLA
    scan loop is gone."""
    txt = _lowered_text(backend, platform)
    assert ("viterbi_fused" in txt) == kernel
    assert ("stablehlo.while" in txt) == (not kernel)


def test_no_interpret_mode_unless_requested():
    """On a CPU the kernel runs only when the caller asks for the
    interpreter; a plain call fails instead of silently interpreting."""
    llr, _ = _llrs("vkinterp", 1, 200)
    with pytest.raises(Exception, match="interpret"):
        jax.block_until_ready(jax.jit(KV.viterbi_fused)(llr))
    np.testing.assert_array_equal(np.asarray(fused(llr)),
                                  np.asarray(PB.viterbi_decode(llr)))


def _aligned_case(cfg):
    from ofdm_uhd_tpu.channel import apply_channel
    from ofdm_uhd_tpu.pipeline import TxPipeline
    spec = config(cfg)
    if cfg == "c4":
        spec = spec.with_(n_data_syms=4)          # keep the CPU run short
    r = rng_for(f"vkchain{cfg}")
    p = r.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.asarray(TxPipeline(spec)(p))
    ch = ChannelSpec(snr_db=25.0, multipath_taps=(
        (1.0, 0.35 - 0.15j) if cfg == "c2" else ()))
    rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=i)
                      for i in range(len(p))]).astype(np.complex64)
    return spec, rx_in, p


@pytest.mark.parametrize("cfg", ["c1", "c2", "c3", "c4", "c5"])
def test_auto_equals_xla_through_the_chain(cfg):
    """configs/c*.json ship kernel_backend='auto': on a CPU its results
    are bit for bit those of 'xla' (aligned chain; c5 also streamed)."""
    from ofdm_uhd_tpu.cli.config import load_spec
    from ofdm_uhd_tpu.pipeline import RxPipeline
    assert load_spec(cfg).kernel_backend == "auto"
    spec, rx_in, p = _aligned_case(cfg)
    outs = [RxPipeline(spec.with_(kernel_backend=be),
                       shift=min(4, spec.cp // 4)).rx_aligned(rx_in)
            for be in ("auto", "xla")]
    for k in ("payload", "crc_ok", "evm_db", "data_syms"):
        np.testing.assert_array_equal(np.asarray(outs[0][k]),
                                      np.asarray(outs[1][k]))
    np.testing.assert_array_equal(np.asarray(outs[0]["payload"]), p)
    if cfg == "c5":
        from ofdm_uhd_tpu.pipeline.stream import StreamRx
        from ofdm_uhd_tpu.shard.mesh import make_mesh
        stream = np.concatenate([np.zeros(300, np.complex64)]
                                + [np.concatenate([f, np.zeros(500, f.dtype)])
                                   for f in rx_in])
        got = {}
        for be in ("auto", "xla"):
            rx = StreamRx(spec.with_(kernel_backend=be),
                          mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
            got[be] = [(g.start, bytes(g.payload), g.crc_ok)
                       for g in rx.process(stream) + rx.flush()]
        assert got["auto"] == got["xla"] and len(got["auto"]) == 3
