"""Detection-rate / false-alarm vs SNR sweep (VERDICT r3 item 7).

Stresses the S&C detector below the C2 sweep's 10 dB point, comparing the
fixed threshold against the CFAR (noise-floor-adaptive) mode, and
measures the streaming TRACK-mode rescue rate on the same low-SNR
captures.

    python bench/detect_sweep.py \
        [--config c3] [--snrs -2,0,2,5,8,10] [--trials 8] [--jsonl out]

Columns per SNR point and mode:
  det_rate    detected preambles / transmitted frames
  fer         post-FEC frame error rate among detections
  fa_noise    false 'valid' slots per 100k pure-noise samples (same
              detector, signal-free captures)
  rescued     TRACK-mode retries that recovered a CRC (streaming path)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="c3")
    ap.add_argument("--snrs", default="-2,0,2,5,8,10")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--jsonl", default=None)
    args = ap.parse_args()

    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.channel import make_capture
    from ofdm_uhd_tpu.golden import GoldenModem
    from ofdm_uhd_tpu.pipeline.rx import RxPipeline
    from ofdm_uhd_tpu.pipeline.stream import StreamRx
    from ofdm_uhd_tpu.shard.mesh import make_mesh
    from ofdm_uhd_tpu.metrics import JsonlLogger

    spec = __import__("ofdm_uhd_tpu.cli.config", fromlist=["load_spec"]
                      ).load_spec(args.config)
    gm = GoldenModem(spec)
    rng = np.random.default_rng(0)
    rx = {"fixed": RxPipeline(spec),
          "cfar": RxPipeline(spec, sync_threshold_mode="cfar")}
    lg = JsonlLogger(args.jsonl) if args.jsonl else None
    mf = args.frames + 2

    # false-alarm side: pure noise through both detectors
    fa = {}
    for mode in rx:
        n_fa, n_samp = 0, 0
        for t in range(args.trials):
            r = np.random.default_rng(500 + t)
            noise = (r.normal(size=100_000) + 1j * r.normal(size=100_000)
                     ).astype(np.complex64) * 0.5
            out = rx[mode].rx_capture(noise, max_frames=mf)
            n_fa += int(np.asarray(out["valid"]).sum())
            n_samp += noise.size
        fa[mode] = 1e5 * n_fa / n_samp

    print(f"{'SNR':>5} {'mode':>6} {'det_rate':>9} {'fer':>7} "
          f"{'fa/100k':>8} {'rescued':>8}")
    for snr in [float(s) for s in args.snrs.split(",")]:
        for mode in ("fixed", "cfar"):
            det, ok_n, tx_n = 0, 0, 0
            for t in range(args.trials):
                payloads = rng.integers(
                    0, 2, (args.frames, spec.payload_bits_per_frame)
                ).astype(np.uint8)
                frames = np.stack([gm.modulate_frame(p) for p in payloads])
                ch = ChannelSpec(snr_db=snr, cfo=0.2,
                                 timing_offset=300 + 50 * t)
                cap = make_capture(frames, ch, spec.n_sc, gap=900,
                                   seed=100 + t).astype(np.complex64)
                out = rx[mode].rx_capture(cap, max_frames=mf)
                det += int(np.asarray(out["valid"]).sum())
                ok_n += int(np.asarray(out["crc_ok"]).sum())
                tx_n += args.frames
            det_rate = det / tx_n
            fer = 1.0 - ok_n / max(det, 1)
            # TRACK rescue on the streaming path (cfar mode only: the
            # retry needs detections to exist at low SNR first)
            rescued = None
            if mode == "cfar" and snr <= 5:
                mesh = make_mesh(1, 1)
                srx = StreamRx(spec, mesh=mesh,
                               chunk_len=4 * spec.frame_len + 4096,
                               threshold_mode="cfar", track_mode=True)
                payloads = rng.integers(
                    0, 2, (args.frames, spec.payload_bits_per_frame)
                ).astype(np.uint8)
                frames = np.stack([gm.modulate_frame(p) for p in payloads])
                cap = make_capture(frames,
                                   ChannelSpec(snr_db=snr, cfo=0.2,
                                               timing_offset=400),
                                   spec.n_sc, gap=900, seed=77
                                   ).astype(np.complex64)
                got = srx.process(cap) + srx.flush()
                rescued = sum(1 for g in got if getattr(g, "rescued", False))
            row = {"config": args.config, "snr_db": snr, "mode": mode,
                   "det_rate": round(det_rate, 4), "fer": round(fer, 4),
                   "fa_per_100k": round(fa[mode], 3),
                   "rescued": rescued}
            if lg:
                lg.log(row)
            print(f"{snr:>5.1f} {mode:>6} {det_rate:>9.3f} {fer:>7.3f} "
                  f"{fa[mode]:>8.3f} {str(rescued):>8}")


if __name__ == "__main__":
    main()
