"""Per-stage timing of the capture RX chain — where does the time go?

Each stage runs as its own jitted function on the default device over a
batch of captures (vmapped, as RxPipeline.rx_capture runs them). The host
clock times it around work that ends in jax.block_until_ready, after one
warm-up call. With --trace DIR each stage is also traced with
jax.profiler, and the device time per call is read from the trace: the
union of the device's kernel intervals (busy time) and the sum of kernel
durations, with the longest kernels named.

Stages (pipeline/rx._capture_front and _decode):
  corr      sc_correlate + sc_metric (the S&C front end)
  detect    detect_frames (includes corr; the delta is the slot search)
  localize  plateau localization of every candidate (phy.sync.localize)
  extract   frame extraction gather (phy.sync.extract_frames)
  cfo       fractional + integer CFO correction of the extracted frames
  cpfft     CP strip + FFT of the frames (phy.frame.ofdm_demodulate)
  ifftcp    IFFT + CP insertion of as many frames (TX, ofdm_modulate)
  frontend  FFT -> chanest/EQ/CPE -> LLR demap
  decode    deinterleave + Viterbi (spec.kernel_backend) + CRC
  vit-*     the decoders alone: XLA scan, XLA windowed, fused kernel (GPU)
  full      the whole rx_capture graph
  decim/interp  (configs with resampling) the polyphase filters

Usage: python bench/stages.py [--config c3] [--backend xla|auto]
       [--frames 1024] [--batch 8] [--iters 5] [--trace DIR]
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_fn(fn, args, iters):
    """Seconds per call of fn(*args) after one warm-up (compiling) call."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def device_time(trace_dir: str, iters: int) -> dict:
    """Reduce one stage's trace: per call, the device busy time (union of
    the intervals of every event on the GPU planes), the sum of kernel
    durations on the stream lines, and the five longest kernels."""
    from jax.profiler import ProfileData
    pb = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True))[-1]
    spans, kernels = [], {}
    for plane in ProfileData.from_file(pb).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            derived = line.name.startswith(("XLA", "Steps", "Framework",
                                            "Launch"))
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if not derived:
                    kernels[ev.name] = kernels.get(ev.name, 0.0) \
                        + ev.duration_ns
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_ms": busy / iters / 1e6,
            "kernel_ms": sum(kernels.values()) / iters / 1e6,
            "top": [(k[:60], round(v / iters / 1e6, 4)) for k, v in top]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="c3")
    ap.add_argument("--backend", default="auto", choices=["xla", "auto"],
                    help="spec.kernel_backend for 'decode' and 'full'")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1,
                    help="captures per dispatch (vmapped)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="trace each stage into DIR/<stage> and report "
                         "its device time")
    ap.add_argument("--jsonl", default=None,
                    help="append the per-stage profile (ms) as one JSONL "
                         "record — bench/roofline.py --stages-jsonl "
                         "cross-checks its cost model against it")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench_lib import build_captures
    from ofdm_uhd_tpu.cli.config import load_spec
    from ofdm_uhd_tpu.core.compile_cache import enable_compile_cache
    from ofdm_uhd_tpu.kernels import fir as K2
    from ofdm_uhd_tpu.kernels import viterbi as KV
    from ofdm_uhd_tpu.kernels.sync import sc_correlate, sc_metric
    from ofdm_uhd_tpu.phy import bits as PB
    from ofdm_uhd_tpu.phy import frame as PF
    from ofdm_uhd_tpu.phy import sync as PS
    from ofdm_uhd_tpu.phy import tables as T
    from ofdm_uhd_tpu.pipeline import rx as RXP

    enable_compile_cache()
    spec = load_spec(args.config).with_(kernel_backend=args.backend)
    caps, _ = build_captures(spec, args.batch, args.frames, 300)
    # decimation needs whole radio-rate periods (as _capture_front pads)
    caps = np.pad(caps, ((0, 0), (0, (-caps.shape[1]) % spec.resample_l)))
    mf = args.frames + 2
    dev = jax.devices()[0]
    log(f"# device={dev.device_kind} config={args.config} batch="
        f"{args.batch} capture={caps.shape[1]} samples "
        f"backend={args.backend}")
    results, device = {}, {}

    def stage(name, fn, *xs):
        f = jax.jit(fn)
        dt = time_fn(f, xs, args.iters)
        results[name] = dt
        txt = ""
        if args.trace:
            d = os.path.join(args.trace, name)
            with jax.profiler.trace(d):
                for _ in range(args.iters):
                    out = f(*xs)
                jax.block_until_ready(out)
            device[name] = device_time(d, args.iters)
            txt = (f"  device busy {device[name]['busy_ms']:8.3f} ms, "
                   f"kernels {device[name]['kernel_ms']:8.3f} ms; top "
                   f"{device[name]['top'][:3]}")
        log(f"# {name:<10} host {dt * 1e3:8.3f} ms{txt}")

    vm = jax.vmap
    l_half = spec.n_sc // 2
    base = jax.device_put(caps)
    if (spec.resample_l, spec.resample_m) != (1, 1):
        taps = T.resample_filter(spec.resample_l, spec.resample_m)
        stage("decim", lambda c: K2.polyphase_decim(
            c, spec.resample_l, taps), base)
        x = jax.jit(lambda c: RXP._to_baseband(spec, c))(base)
    else:
        x = base

    stage("corr", vm(lambda c: sc_metric(*sc_correlate(c, l_half))), x)
    stage("detect", vm(functools.partial(PS.detect_frames, spec,
                                         max_frames=mf)), x)

    def candidates(c):
        p, rr = sc_correlate(c, l_half)
        m = sc_metric(p, rr)
        rise = (m >= 0.5) & ~jnp.concatenate([jnp.zeros(1, bool),
                                              m[:-1] >= 0.5])
        cand = PS._first_k_indices(rise, min(4 * mf + 16, m.shape[-1]),
                                   sentinel=m.shape[-1])
        return m, p, cand
    m, p, cand = jax.jit(vm(candidates))(x)
    stage("localize", vm(lambda m, p, c: PS.localize(
        m, p, c, spec.sym_len, spec.cp)), m, p, cand)

    ds, eps_f, _ = jax.jit(vm(functools.partial(
        PS.detect_frames, spec, max_frames=mf)))(x)
    stage("extract", vm(lambda c, d: PS.extract_frames(spec, c, d)), x, ds)
    frames = jax.jit(vm(lambda c, d: PS.extract_frames(spec, c, d)))(x, ds)

    def cfo(fr, e):
        fr = PS.cfo_correct(fr, e, spec.n_sc)
        k = PS.integer_cfo(spec, fr)
        return PS.cfo_correct(fr, k.astype(jnp.float32), spec.n_sc)
    stage("cfo", vm(cfo), frames, eps_f)

    flat = frames.reshape(-1, frames.shape[-1])
    stage("cpfft", lambda f: PF.ofdm_demodulate(spec, f, shift=4), flat)
    grid = jax.jit(lambda f: PF.ofdm_demodulate(spec, f, shift=4))(flat)
    stage("ifftcp", lambda g: PF.ofdm_modulate(spec, g), grid)
    stage("frontend", lambda f: RXP._frontend(spec, f, shift=4), flat)
    llr = jax.jit(lambda f: RXP._frontend(spec, f, shift=4)["llr"])(flat)
    stage("decode", lambda v: RXP._decode(spec, v), llr)
    llr_d = jax.jit(lambda v: PB.deinterleave_soft(
        v, spec.coded_bits_per_sym))(llr)
    stage("vit-scan", PB.viterbi_decode, llr_d)
    stage("vit-win", PB.viterbi_decode_windowed, llr_d)
    if dev.platform == "gpu":
        stage("vit-kernel", KV.viterbi_fused, llr_d)
    if (spec.resample_l, spec.resample_m) != (1, 1):
        # TX side: interpolate as many baseband frames to the radio rate
        stage("interp", lambda f: K2.polyphase_interp(
            f, spec.resample_l, taps), flat)
    stage("full", functools.partial(RXP._rx_capture, spec, 0.5, False,
                                    max_frames=mf), base)
    log(f"# full: {caps.size / results['full'] / 1e6:.1f} Msamples/s")

    if args.jsonl:
        from ofdm_uhd_tpu.metrics import JsonlLogger
        JsonlLogger(args.jsonl).log({
            "config": args.config, "backend": args.backend,
            "device": dev.device_kind,
            "n_samples": caps.shape[1], "batch": args.batch,
            "frames": args.frames, "mf": mf, "frame_len": spec.frame_len,
            "stages_ms": {k: round(v * 1e3, 4) for k, v in results.items()},
            "stages_device_ms": device,
        })


if __name__ == "__main__":
    main()
