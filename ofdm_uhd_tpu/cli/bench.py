"""Bench tool: per-config throughput/EVM with optional profiler trace
(SURVEY.md §3.6, §5.1). The repo-root bench.py wraps this for the judged
one-line JSON output."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..core.compile_cache import enable_compile_cache
from . import config as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    C.add_common_args(p)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--caps", type=int, default=1,
                   help="captures per dispatch (capture mode)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--mode", choices=["aligned", "capture", "stream"],
                   default="capture")
    p.add_argument("--input", choices=["fc32", "sc16"], default="fc32",
                   help="capture-mode input format (sc16 = radio-native "
                        "int16 IQ, 4x less host->device traffic)")
    p.add_argument("--chunk", type=int, default=None,
                   help="stream-mode chunk length in baseband samples")
    p.add_argument("--ksteps", type=int, default=8,
                   help="stream-mode chunks per dispatch (device-resident "
                        "lax.scan; amortizes the per-step host round trip)")
    p.add_argument("--no-track", action="store_true",
                   help="stream-mode: disable the TRACK-mode retry pass "
                        "(for quantifying its cost)")
    p.add_argument("--resident", action="store_true",
                   help="stream-mode: pre-stage the K-step chunk buffers "
                        "on-device and time only dispatch+state-carry+"
                        "small-leaf fetch — the chain's streaming capacity "
                        "without the host->device feed")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace (Perfetto) here")
    p.add_argument("--jsonl", default=None, help="append results to JSONL")
    args = p.parse_args(argv)
    enable_compile_cache()

    import jax
    from ..core.spec import ChannelSpec
    from ..channel import apply_channel, make_capture
    from ..pipeline import TxPipeline, RxPipeline
    from ..metrics import JsonlLogger

    spec = C.spec_from_args(args)
    rng = np.random.default_rng(args.seed)
    payloads = rng.integers(
        0, 2, (args.frames, spec.payload_bits_per_frame)).astype(np.uint8)
    # CFO is expressed in subcarrier spacings at BASEBAND; captures carry it
    # at the radio rate, where the same per-sample ramp reads 1/L as large.
    cfo_bb = 0.8 if args.mode != "aligned" else 0.0
    ch = ChannelSpec(snr_db=28.0, cfo=cfo_bb / spec.resample_l,
                     timing_offset=100 if args.mode != "aligned" else 0)

    if args.mode == "aligned":
        frames = np.asarray(TxPipeline(spec)(payloads))
        rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=i)
                          for i in range(args.frames)])
        rx = RxPipeline(spec, shift=min(4, spec.cp // 4))
        x = jax.device_put(rx_in.astype(np.complex64))
        run = rx.rx_aligned
        n_samples = rx_in.size
    elif args.mode == "stream":
        return _bench_stream(args, spec, payloads, ch)
    else:
        fr = np.asarray(TxPipeline(spec)(payloads))  # radio rate
        caps = np.stack([
            make_capture(np.asarray(fr), ch, spec.n_sc, gap=300, seed=s)
            for s in range(args.caps)]).astype(np.complex64)
        cap_in = caps[0] if args.caps == 1 else caps
        rx = RxPipeline(spec)
        if args.input == "sc16":
            planes = np.stack([cap_in.real, cap_in.imag])
            iq = np.round(planes * (32767.0 / np.max(np.abs(planes)))
                          ).astype(np.int16)
            x = jax.device_put(iq)
            run = lambda x: rx.rx_capture_sc16(x, max_frames=args.frames + 2)
        else:
            x = jax.device_put(cap_in)
            run = lambda x: rx.rx_capture(x, max_frames=args.frames + 2)
        n_samples = cap_in.size

    jax.block_until_ready(run(x))              # compile + warm-up
    if args.trace_dir:
        with jax.profiler.trace(args.trace_dir):
            dt, out = _timed(run, x, args.iters)
    else:
        dt, out = _timed(run, x, args.iters)
    n_ok = int(np.asarray(out["crc_ok"]).sum())

    sps = n_samples / dt
    rec = {
        "config": args.config, "mode": args.mode,
        "backend": spec.kernel_backend, "input": args.input,
        "device": jax.devices()[0].device_kind,
        "caps_per_dispatch": args.caps,
        "msamples_per_s": round(sps / 1e6, 3),
        "frames_per_s": round(n_ok / dt, 1),
        "frames_ok": n_ok,
        "frames": args.frames * (args.caps if args.mode == "capture" else 1),
        "evm_db": round(float(np.mean(np.asarray(out["evm_db"]))), 2),
    }
    if args.jsonl:
        JsonlLogger(args.jsonl).log(rec)
    print(json.dumps(rec))


def _timed(run, x, iters):
    """(seconds per call, last output) of a warmed-up run(x)."""
    import jax
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def _bench_stream(args, spec, payloads, ch):
    """Continuous-stream throughput: StreamRx over a radio-rate capture,
    steady-state, counting input samples at the RADIO rate (the judged
    frames/s + Msamples/s for C4/C5's streaming configurations)."""
    import jax
    from ..channel import make_capture
    from ..metrics import JsonlLogger
    from ..pipeline import TxPipeline
    from ..pipeline.stream import StreamRx

    fr = np.asarray(TxPipeline(spec)(payloads))
    cap = make_capture(fr, ch, spec.n_sc, gap=300,
                       seed=args.seed).astype(np.complex64)
    rx = StreamRx(spec, chunk_len=args.chunk,
                  steps_per_dispatch=args.ksteps,
                  track_mode=not args.no_track,
                  input_format=args.input)
    if args.input == "sc16":
        planes = np.stack([cap.real, cap.imag])
        feed = np.round(planes * (32767.0 / np.max(np.abs(planes)))
                        ).astype(np.int16)
        n_cap = feed.shape[1]
    else:
        feed, n_cap = cap, len(cap)
    # pad the tail so every iteration feeds whole K-groups of chunks
    # (steady state: every dispatch in the timed loop is the K-step one)
    pad = (-n_cap) % (rx.radio_chunk * args.ksteps)
    if args.input == "sc16":
        feed = np.concatenate([feed, np.zeros((2, pad), np.int16)], axis=1)
    else:
        feed = np.concatenate([feed, np.zeros(pad, np.complex64)])
    n_cap += pad

    if args.resident:
        return _bench_stream_resident(args, spec, rx, feed, n_cap)

    got = rx.process(feed)                     # compile + warmup pass
    t0 = time.perf_counter()
    n_ok = 0
    for _ in range(args.iters):
        got = rx.process(feed)
        n_ok += sum(g.crc_ok for g in got)
    dt = time.perf_counter() - t0
    got = rx.flush()
    n_ok += sum(g.crc_ok for g in got)

    sps = n_cap * args.iters / dt
    rec = {
        "config": args.config, "mode": "stream",
        "backend": spec.kernel_backend, "input": args.input,
        "device": jax.devices()[0].device_kind,
        "n_devices": rx.mesh.size,
        "chunk_len": rx.chunk_len,
        "ksteps": args.ksteps,
        "track_mode": not args.no_track,
        "msamples_per_s": round(sps / 1e6, 3),
        "frames_per_s": round(n_ok / dt, 1),
        "frames_ok": n_ok, "frames": args.frames * args.iters,
    }
    if args.jsonl:
        JsonlLogger(args.jsonl).log(rec)
    print(json.dumps(rec))


def _bench_stream_resident(args, spec, rx, feed, n_cap):
    """Device-resident streaming: stage the K-step chunk stacks once, then
    time dispatch + carried StreamState + the small-leaf fetch only — the
    chain's streaming capacity without the host->device feed, which the
    host-fed mode includes."""
    import jax
    from ..metrics import JsonlLogger

    k, rc = args.ksteps, rx.radio_chunk
    n_disp = n_cap // (k * rc)
    if args.input == "sc16":
        stack = np.ascontiguousarray(
            feed[:, :n_disp * k * rc].reshape(2, n_disp * k, rc)
            .swapaxes(0, 1).reshape(n_disp, k, 2, rc))
    else:
        stack = feed[:n_disp * k * rc].reshape(n_disp, k, rc)
    bufs = [rx._put_chunk(stack[d]) for d in range(n_disp)]

    def run_pass(bufs):
        n_ok = 0
        outs_l = []
        for d in bufs:
            rx.state, outs = rx._multi(rx.state, d)
            outs_l.append(outs)
        for o in outs_l:
            mi = np.asarray(o["meta_i"])
            n_ok += int((mi[:, :, 0] * mi[:, :, 1]).sum())
        return n_ok

    run_pass(bufs)                             # compile + warmup
    t0 = time.perf_counter()
    n_ok = 0
    for i in range(args.iters):
        n_ok += run_pass(bufs)
    dt = time.perf_counter() - t0

    sps = n_disp * k * rc * args.iters / dt
    rec = {
        "config": args.config, "mode": "stream-resident",
        "backend": spec.kernel_backend, "input": args.input,
        "device": jax.devices()[0].device_kind,
        "n_devices": rx.mesh.size, "chunk_len": rx.chunk_len,
        "ksteps": k, "track_mode": not args.no_track,
        "msamples_per_s": round(sps / 1e6, 3),
        "frames_per_s": round(n_ok / dt, 1),
        "frames_ok": n_ok,
    }
    if args.jsonl:
        JsonlLogger(args.jsonl).log(rec)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
