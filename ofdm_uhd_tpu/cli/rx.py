"""RX tool: capture file -> decoded bits + metrics (SURVEY.md §3.3).

Uses the jitted capture pipeline (Schmidl-Cox detection) by default;
--aligned decodes back-to-back frames at known boundaries.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.compile_cache import enable_compile_cache
from . import config as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    C.add_common_args(p)
    p.add_argument("--capture", required=True)
    p.add_argument("--bits-out", default=None)
    p.add_argument("--expect-bits", default=None,
                   help="payload npy to compare against (reports BER)")
    p.add_argument("--max-frames", type=int, default=64)
    p.add_argument("--aligned", action="store_true",
                   help="frames are back-to-back from sample 0 (loopback)")
    p.add_argument("--threshold", type=float, default=0.5)
    args = p.parse_args(argv)
    enable_compile_cache()

    from ..pipeline import RxPipeline
    from ..io import read_capture
    from ..metrics import RunMetrics

    spec = C.spec_from_args(args)
    samples, meta = read_capture(args.capture)
    rx = RxPipeline(spec, sync_threshold=args.threshold)
    m = RunMetrics()
    if args.aligned:
        flen = spec.frame_len_radio
        gap = meta.get("gap", 0)
        n = len(samples) // (flen + gap)
        frames = samples[: n * (flen + gap)].reshape(n, flen + gap)[:, :flen]
        out = rx.rx_aligned(frames)
        out["valid"] = np.ones(n, dtype=bool)
    else:
        out = rx.rx_capture(samples, max_frames=args.max_frames)
    m.update_batch(out, len(samples))
    valid = np.asarray(out["valid"]).astype(bool)
    payloads = np.asarray(out["payload"])[valid]
    if args.bits_out:
        np.save(args.bits_out, payloads)
    if args.expect_bits:
        expect = np.load(args.expect_bits)
        nf = min(len(expect), len(payloads))
        nbit = np.prod(expect[:nf].shape)
        nerr = int(np.sum(payloads[:nf] != expect[:nf]))
        print(f"post-FEC BER: {nerr}/{nbit} = {nerr/max(nbit,1):.2e} "
              f"({'bit-exact' if nerr == 0 and nf == len(expect) else 'ERRORS'})",
              file=sys.stderr)
    s = m.summary()
    print(f"frames: {s['frames_detected']} detected, {s['frames_ok']} crc-ok; "
          f"EVM {s['mean_evm_db']:.1f} dB; "
          f"{s['msamples_per_s']:.2f} Msamples/s", file=sys.stderr)


if __name__ == "__main__":
    main()
