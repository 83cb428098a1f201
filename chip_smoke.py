"""Smoke run of the receive chain on NVIDIA GPUs, in one process.

    python chip_smoke.py               # one GPU: phases 1-3
    python chip_smoke.py --devices 4   # four GPUs: phase 4 only

Phase 1 prints the device, the card (nvidia-smi name and power limit), the
JAX version, XLA_FLAGS, the compile-cache directory and the f32 matmul
precision. Phase 2 compares the fused Viterbi kernel, compiled for the
card, with the XLA scan and windowed decoders at the C3 headline batch
and a C5 streaming step, bit for bit, and times all three. Phase 3 runs
the main path through RxPipeline and StreamRx at the sizes bench.py
judges: C3 sc16 captures (8 x 1024 frames), C1 and C2 aligned (4096
frames each), C4 radio-rate captures with 8x decimation, and C5 streamed
on one card over several dispatches at pod_rx's default chunk. Every
frame sent must decode bit-exact; EVM and rates are printed beside the
card. Phase 4 runs C5 time-parallel on four cards (ppermute halos, psum
tracking, and the reshard variant) and frame-parallel RX, each compared
bit for bit with one card.

Any failure exits non-zero; so does a machine where JAX finds no GPU, or
a directory without the ofdm_uhd_tpu package beside this script. The last
line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def _median_time(fn, arg, reps):
    import jax
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _compile_and_run(fn, arg):
    """(seconds of the first, compiling call, its output)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(arg))
    return time.perf_counter() - t0, out


# ------------------------------------------------------------ phase 1

def phase_device(n_devices):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py: JAX found no GPU (platform "
                 f"{devs[0].platform!r})")
    if len(devs) < n_devices:
        sys.exit(f"chip_smoke.py: {n_devices} GPUs requested, "
                 f"{len(devs)} found")
    from ofdm_uhd_tpu.core.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("== phase 1: device")
    log(f"devices: {[str(d) for d in devs]} kind={devs[0].device_kind!r}")
    log(f"card: {card}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    log(f"f32 matmul precision: {jax.config.jax_default_matmul_precision}")
    return card.splitlines()[0]


# ------------------------------------------------------------ phase 2

def _encoded_llrs(batch, n, seed, snr_db=6.0):
    """On-device random tail-terminated messages [batch, n], and their
    rate-1/2 K=7 codewords through AWGN as LLRs [batch, 2n]."""
    import jax
    import jax.numpy as jnp
    from ofdm_uhd_tpu.phy import bits as PB

    @jax.jit
    def make(key):
        k1, k2 = jax.random.split(key)
        msgs = jax.random.bernoulli(k1, 0.5, (batch, n)).astype(jnp.uint8)
        msgs = msgs.at[:, -6:].set(0)
        tx = 1.0 - 2.0 * PB.conv_encode(msgs).astype(jnp.float32)
        sigma = 10.0 ** (-snr_db / 20.0)
        noisy = tx + sigma * jax.random.normal(k2, tx.shape)
        return msgs, (2.0 / sigma ** 2) * noisy

    return make(jax.random.PRNGKey(seed))


def phase_kernels(card):
    import jax
    from ofdm_uhd_tpu.core.spec import config
    from ofdm_uhd_tpu.core.state import StreamState
    from ofdm_uhd_tpu.kernels.viterbi import viterbi_fused
    from ofdm_uhd_tpu.phy import bits as PB

    log("== phase 2: kernels (fused Viterbi vs the XLA decoders)")
    c5 = config("c5")
    # one C5 streaming step at pod_rx's default chunk decodes
    # max_frames_per_shard = block // frame_len + 2 slots
    cb = max(2 * StreamState.halo_len(c5), 4 * c5.frame_len)
    shapes = [("c3 headline 8x1026", 8 * 1026,
               config("c3").uncoded_bits_per_frame),
              ("c5 stream step", cb // c5.frame_len + 2,
               c5.uncoded_bits_per_frame)]
    impls = [("kernel", jax.jit(viterbi_fused)),
             ("xla-windowed", jax.jit(PB.viterbi_decode_windowed)),
             ("xla-scan", jax.jit(PB.viterbi_decode))]
    for i, (name, batch, n) in enumerate(shapes):
        msgs, llr = _encoded_llrs(batch, n, seed=i)
        outs, times = {}, {}
        for impl, f in impls:
            c, outs[impl] = _compile_and_run(f, llr)
            times[impl] = (c, _median_time(f, llr, 5))
        msgs = np.asarray(msgs)
        got = {k: np.asarray(v) for k, v in outs.items()}
        check(np.array_equal(got["kernel"], got["xla-windowed"]),
              f"{name}: kernel != windowed decoder")
        check(np.array_equal(got["xla-scan"], msgs),
              f"{name}: frames not decodable; the comparison needs them")
        check(np.array_equal(got["kernel"], got["xla-scan"]),
              f"{name}: kernel != scan decoder on decodable frames")
        log(f"viterbi {name} (B={batch}, n={n}): bit-exact vs windowed "
            f"and scan; " + "; ".join(
                f"{k} {t * 1e3:.3f} ms (compile {c:.1f} s)"
                for k, (c, t) in times.items()) + f" [{card}]")


# ------------------------------------------------------------ phase 3

def _load(name):
    from ofdm_uhd_tpu.cli.config import load_spec
    return load_spec(os.path.join(ROOT, "configs", f"{name}.json"))


def _report(name, n_ok, n_sent, evm, compile_s, dt, n_samples, card,
            unit="dispatch"):
    log(f"{name}: {n_ok}/{n_sent} frames bit-exact, EVM {evm:.2f} dB; "
        f"first call {compile_s:.1f} s; steady {dt * 1e3:.2f} ms/{unit}, "
        f"{n_samples / dt / 1e6:.2f} Msamples/s, {n_sent / dt:.1f} "
        f"frames/s [{card}]")


def _check_batch(name, out, payloads):
    crc = np.asarray(out["crc_ok"])[..., :payloads.shape[-2]]
    bits = np.asarray(out["payload"])[..., :payloads.shape[-2], :]
    check(int(crc.sum()) == crc.size, f"{name}: {int(crc.sum())}/"
          f"{crc.size} frames pass CRC")
    check(np.array_equal(bits, payloads), f"{name}: payload bits differ")
    return int(crc.sum()), float(np.mean(
        np.asarray(out["evm_db"])[..., :payloads.shape[-2]]))


def _timed_dispatch(fn, arg, reps=5):
    compile_s, out = _compile_and_run(fn, arg)
    return compile_s, _median_time(fn, arg, reps), out


def phase_main_path(card):
    import jax
    from bench_lib import build_captures, to_sc16
    from ofdm_uhd_tpu.channel import apply_channel, make_capture
    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.pipeline import RxPipeline, TxPipeline

    log("== phase 3: main path")

    # C3: capture chain on sc16 at bench.py's geometry
    spec = _load("c3")
    caps, pays = build_captures(spec, 8, 1024, 300)
    iq = jax.device_put(to_sc16(caps))
    rx = RxPipeline(spec, diag=False)
    c, dt, out = _timed_dispatch(
        lambda x: rx.rx_capture_sc16(x, max_frames=1026), iq)
    n_ok, evm = _check_batch("c3", out, pays)
    _report(f"c3 capture sc16 8x1024 ({caps.size} samples)", n_ok,
            pays.shape[0] * pays.shape[1], evm, c, dt, caps.size, card)
    del iq, out

    # C1 and C2: aligned frames (C2 through its static multipath)
    for name, taps in (("c1", ()), ("c2", (1.0, 0.35 - 0.15j))):
        spec = _load(name)
        rng = np.random.default_rng(1)
        pays = rng.integers(0, 2, (4096, spec.payload_bits_per_frame)
                            ).astype(np.uint8)
        frames = np.asarray(TxPipeline(spec)(pays))
        ch = ChannelSpec(snr_db=25.0, multipath_taps=taps)
        rx_in = np.stack([apply_channel(f, ch, spec.n_sc, seed=i)
                          for i, f in enumerate(frames)]
                         ).astype(np.complex64)
        rx = RxPipeline(spec, shift=min(4, spec.cp // 4), diag=False)
        c, dt, out = _timed_dispatch(rx.rx_aligned, jax.device_put(rx_in))
        n_ok, evm = _check_batch(name, out, pays)
        _report(f"{name} aligned 4096", n_ok, 4096, evm, c, dt, rx_in.size,
                card)

    # C4: radio-rate captures, 8x decimation in the chain
    spec = _load("c4")
    tx = TxPipeline(spec)
    caps, pays = [], []
    for s in range(8):
        p = np.random.default_rng(10 + s).integers(
            0, 2, (32, spec.payload_bits_per_frame)).astype(np.uint8)
        ch = ChannelSpec(snr_db=28.0, cfo=0.8 / spec.resample_l,
                         timing_offset=100)
        caps.append(make_capture(np.asarray(tx(p)), ch, spec.n_sc, gap=300,
                                 seed=s).astype(np.complex64))
        pays.append(p)
    caps, pays = np.stack(caps), np.stack(pays)
    rx = RxPipeline(spec, diag=False)
    c, dt, out = _timed_dispatch(
        lambda x: rx.rx_capture(x, max_frames=34), jax.device_put(caps))
    n_ok, evm = _check_batch("c4", out, pays)
    _report(f"c4 radio-rate capture 8x32 ({caps.size} samples)", n_ok,
            pays.shape[0] * pays.shape[1], evm, c, dt, caps.size, card)

    # C5: one card streamed at pod_rx's default chunk
    _phase_stream(card)


def _c5_stream(n_frames=256, seed=5):
    from ofdm_uhd_tpu.channel import make_capture
    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.pipeline import TxPipeline
    spec = _load("c5")
    pays = np.random.default_rng(seed).integers(
        0, 2, (n_frames, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.asarray(TxPipeline(spec)(pays))
    cap = make_capture(frames, ChannelSpec(snr_db=26.0, cfo=0.4,
                                           timing_offset=500),
                       spec.n_sc, gap=300, seed=seed).astype(np.complex64)
    return spec, cap, pays


def _run_stream(rx, cap):
    t0 = time.perf_counter()
    got = rx.process(cap) + rx.flush()
    return time.perf_counter() - t0, got


def _check_stream(name, got, pays):
    check(len(got) == len(pays), f"{name}: {len(got)} frames out of "
          f"{len(pays)} sent")
    for g, p in zip(got, pays):
        check(g.crc_ok and np.array_equal(g.payload, p),
              f"{name}: frame at {g.start} is not bit-exact")
    return float(np.mean([g.evm_db for g in got]))


def _phase_stream(card):
    import jax
    from ofdm_uhd_tpu.pipeline.stream import StreamRx
    from ofdm_uhd_tpu.shard.mesh import make_mesh
    spec, cap, pays = _c5_stream()
    rx = StreamRx(spec, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    c, got = _run_stream(rx, cap)             # compiles both step paths
    _check_stream("c5 stream", got, pays)
    dt, got = _run_stream(rx, cap)            # the same stream again
    evm = _check_stream("c5 stream (second pass)", got, pays)
    n_disp = -(-len(cap) // (rx.radio_chunk * rx.steps_per_dispatch))
    log(f"c5 stream: chunk {rx.chunk_len}, {rx.steps_per_dispatch} "
        f"chunks/dispatch, ~{n_disp} dispatches per pass")
    _report(f"c5 stream 1 card ({len(cap)} samples/pass)", len(got),
            len(pays), evm, c, dt, len(cap), card, unit="pass")


# ------------------------------------------------------------ phase 4

def _shard_devices(arr):
    return sorted({(s.device.id, str(s.index)) for s in arr.addressable_shards})


def phase_four(card):
    import jax
    from ofdm_uhd_tpu.channel import apply_channel
    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.pipeline import RxPipeline, TxPipeline
    from ofdm_uhd_tpu.pipeline.stream import StreamRx
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ofdm_uhd_tpu.shard import make_mesh, rx_frames_sharded

    log("== phase 4: four cards")
    devs = jax.devices()[:4]
    spec, cap, pays = _c5_stream()
    one = StreamRx(spec, mesh=make_mesh(1, 1, devices=devs[:1]))
    _, ref = _run_stream(one, cap)
    _check_stream("c5 stream 1 card", ref, pays)
    key = [(g.start, bytes(g.payload), g.crc_ok, g.eps, g.evm_db)
           for g in ref]
    for reshard in (False, True):
        name = f"c5 time-parallel 4 cards{' reshard' if reshard else ''}"
        rx = StreamRx(spec, mesh=make_mesh(1, 4, devices=devs),
                      reshard=reshard)
        c, got = _run_stream(rx, cap)
        check([(g.start, bytes(g.payload), g.crc_ok) for g in got]
              == [k[:3] for k in key], f"{name}: frames differ from 1 card")
        eps_diff = max(abs(a.eps - b[3]) for a, b in zip(got, key))
        evm_diff = max(abs(a.evm_db - b[4]) for a, b in zip(got, key))
        dt, got = _run_stream(rx, cap)        # the same stream again
        evm = _check_stream(name, got, pays)
        probe = rx._put_chunk(np.zeros(rx.radio_chunk, np.complex64))
        log(f"{name}: mesh {rx.mesh.devices.tolist()}; chunk shards on "
            f"(device id, index) {_shard_devices(probe)}")
        log(f"{name}: bit-exact vs 1 card (start, payload, crc); max |eps "
            f"diff| {eps_diff:.2e}, max |EVM diff| {evm_diff:.2e} dB")
        _report(name, len(got), len(pays), evm, c, dt, len(cap), card,
                unit="pass")

    fspec = _load("c2")
    fp = np.random.default_rng(3).integers(
        0, 2, (4096, fspec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.asarray(TxPipeline(fspec)(fp))
    ch = ChannelSpec(snr_db=25.0, multipath_taps=(1.0, 0.35 - 0.15j))
    rx_in = np.stack([apply_channel(f, ch, fspec.n_sc, seed=i)
                      for i, f in enumerate(frames)]).astype(np.complex64)
    with jax.default_device(devs[0]):
        ref = RxPipeline(fspec).rx_aligned(rx_in)
    mesh = make_mesh(4, 1, devices=devs)
    fn = rx_frames_sharded(fspec, mesh)
    x = jax.device_put(rx_in, NamedSharding(mesh, P("frame", None)))
    c, dt, out = _timed_dispatch(fn, x)
    for k in ("payload", "crc_ok"):
        check(np.array_equal(np.asarray(out[k]), np.asarray(ref[k])),
              f"c2 frame-parallel: {k} differs from 1 card")
    n_ok, evm = _check_batch("c2 frame-parallel", out, fp)
    check(int(out["n_ok_global"]) == 4096, "c2 frame-parallel: psum count")
    log(f"c2 frame-parallel 4 cards: payload shards on (device id, index) "
        f"{_shard_devices(out['payload'])}; bit-exact vs 1 card")
    _report("c2 frame-parallel 4 cards 4096", n_ok, 4096, evm, c, dt,
            rx_in.size, card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card phase")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        import ofdm_uhd_tpu
    except ImportError:
        sys.exit("chip_smoke.py: the ofdm_uhd_tpu package is not beside "
                 "this script")
    if os.path.dirname(os.path.dirname(ofdm_uhd_tpu.__file__)) != ROOT:
        sys.exit("chip_smoke.py: ofdm_uhd_tpu was imported from outside "
                 "this checkout")
    import jax

    t0 = time.perf_counter()
    card = phase_device(args.devices)
    if args.devices == 4:
        phase_four(card)
    else:
        phase_kernels(card)
        phase_main_path(card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
