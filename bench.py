"""Headline benchmark — prints ONE JSON line on stdout.

Judged metric (BASELINE.json:2): OFDM demod Msamples/s per device, measured
on the full capture-mode RX chain (Schmidl-Cox sync -> CFO -> FFT ->
chanest/EQ/CPE -> LLR -> Viterbi -> CRC) for the C3 waveform (256-SC
QAM-64), steady-state, best of the VARIANTS below.

vs_baseline: ratio against the single-stream CPU reference chain (the
comparison target BASELINE.json C1 defines; the reference repo publishes no
numbers and its mount is empty — SURVEY.md §0/§6), measured as the golden
NumPy chain's samples/s on this host.

Needs a GPU: with no accelerator it exits non-zero before measuring. Every
variant must decode every frame bit-exact or the run fails. Diagnostics go
to stderr; stdout carries exactly one JSON line.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


VARIANTS = {
    # name -> (spec overrides, input format). sc16 = radio-native int16 IQ
    # planes converted on-device (4x less host->device traffic); the chain
    # after the conversion is identical. 'auto' decodes with the fused
    # Viterbi kernel; the xla variants with the XLA scan or windowed scan.
    "auto-sc16": ({"kernel_backend": "auto"}, "sc16"),
    "xla-sc16": ({"kernel_backend": "xla"}, "sc16"),
    "xla": ({"kernel_backend": "xla"}, "fc32"),
    "xla-windowed-viterbi-sc16": ({"kernel_backend": "xla",
                                   "viterbi_mode": "windowed"}, "sc16"),
}


def bench_variant(spec, caps, payloads, variant, iters=8):
    """caps [C, n] captures, payloads [C, F, bits] -> (Msamples/s, EVM dB).

    One dispatch processes all C captures (vmapped chain). Raises unless
    every frame decodes bit-exact."""
    import jax
    from bench_lib import to_sc16
    from ofdm_uhd_tpu.pipeline import RxPipeline

    n_caps, n_frames = payloads.shape[0], payloads.shape[1]
    mf = n_frames + 2
    overrides, fmt = VARIANTS[variant]
    rx = RxPipeline(spec.with_(**overrides), diag=False)
    if fmt == "sc16":
        x = jax.device_put(to_sc16(caps))
        run = functools.partial(rx.rx_capture_sc16, max_frames=mf)
    else:
        x = jax.device_put(caps)
        run = functools.partial(rx.rx_capture, max_frames=mf)
    out = jax.block_until_ready(run(x))          # compile + warm-up
    crc = np.asarray(out["crc_ok"])[:, :n_frames]
    bits = np.asarray(out["payload"])[:, :n_frames]
    n_ok = int(crc.sum())
    if n_ok != n_caps * n_frames or not np.array_equal(bits, payloads):
        raise RuntimeError(f"{variant}: correctness gate failed "
                           f"({n_ok}/{n_caps * n_frames} crc-ok)")
    evm = float(np.mean(np.asarray(out["evm_db"])[:, :n_frames]))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(x)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return caps.size * iters / dt / 1e6, evm


def bench_cpu_reference(spec, cap):
    from ofdm_uhd_tpu.golden import GoldenModem

    gm = GoldenModem(spec)
    n = min(len(cap), 5 * spec.frame_len)
    t0 = time.perf_counter()
    gm.rx_capture(cap[:n].astype(np.complex128))
    dt = time.perf_counter() - t0
    return n / dt


def main():
    import jax
    from bench_lib import build_captures
    from ofdm_uhd_tpu.core.compile_cache import enable_compile_cache
    from ofdm_uhd_tpu.core.spec import config

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    spec = config("c3")
    # 8 captures x ~4.4M samples (35M) per dispatch: every frame across
    # all captures must decode bit-exact.
    n_caps, n_frames, gap = 8, 1024, 300
    caps, payloads = build_captures(spec, n_caps, n_frames, gap)
    log(f"# captures: {n_caps} x {caps.shape[1]} samples, "
        f"{n_frames} frames each, device={dev.device_kind} ({card})")

    best, best_name = 0.0, None
    for variant in VARIANTS:
        msps, evm = bench_variant(spec, caps, payloads, variant)
        log(f"# {variant}: {msps:.1f} Msamples/s, EVM {evm:.1f} dB "
            f"({card})")
        if msps > best:
            best, best_name = msps, variant

    cpu_sps = bench_cpu_reference(spec, caps[0])
    log(f"# best={best_name} cpu_ref={cpu_sps/1e6:.3f} Msps")

    print(json.dumps({
        "metric": "ofdm_demod_rx_chain_c3",
        "value": round(best, 3),
        "unit": "Msamples/s/chip",
        "vs_baseline": round(best * 1e6 / max(cpu_sps, 1e-9), 1),
    }))


if __name__ == "__main__":
    main()
