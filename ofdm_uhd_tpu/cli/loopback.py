"""Loopback tool: TX -> channel -> RX in one process, reports post-FEC
exactness (the reference-class repo's loopback test binary, SURVEY.md §4)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.compile_cache import enable_compile_cache
from . import config as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    C.add_common_args(p)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--snr", type=float, default=30.0)
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--phase-noise", type=float, default=0.0)
    p.add_argument("--multipath", default="",
                   help="comma-separated complex taps, e.g. '1,0.4-0.2j'")
    p.add_argument("--sync", action="store_true",
                   help="run the capture/sync RX path instead of aligned")
    args = p.parse_args(argv)
    enable_compile_cache()

    from ..pipeline import TxPipeline, RxPipeline
    from ..channel import apply_channel, make_capture
    from ..core.spec import ChannelSpec

    spec = C.spec_from_args(args)
    taps = tuple(complex(t) for t in args.multipath.split(",") if t)
    ch = ChannelSpec(snr_db=args.snr, cfo=args.cfo,
                     phase_noise_std=args.phase_noise, multipath_taps=taps)
    rng = np.random.default_rng(args.seed)
    payloads = rng.integers(
        0, 2, (args.frames, spec.payload_bits_per_frame)).astype(np.uint8)
    tx = TxPipeline(spec)
    frames = np.asarray(tx(payloads))

    if args.sync:
        cap = make_capture(frames.astype(np.complex128), ch, spec.n_sc,
                           gap=spec.n_sc, seed=args.seed).astype(np.complex64)
        out = RxPipeline(spec).rx_capture(cap, max_frames=args.frames + 4)
        valid = np.asarray(out["valid"]).astype(bool)
        got = np.asarray(out["payload"])[valid]
    else:
        rx_in = np.stack([
            apply_channel(frames[i], ch, spec.n_sc, seed=args.seed + i)
            for i in range(args.frames)])
        out = RxPipeline(spec, shift=min(4, spec.cp // 4)).rx_aligned(rx_in)
        got = np.asarray(out["payload"])

    n_ok = int(np.asarray(out["crc_ok"]).sum())
    exact = (len(got) == args.frames
             and np.array_equal(got, payloads))
    evm = float(np.mean(np.asarray(out["evm_db"])))
    print(f"{n_ok}/{args.frames} frames crc-ok; post-FEC "
          f"{'BIT-EXACT' if exact else 'ERRORS'}; mean EVM {evm:.1f} dB",
          file=sys.stderr)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
