"""Pod streaming RX: continuous time-block stream over the device mesh
(SURVEY.md §3.4, config C5).

Single-host: uses all local devices on the 'time' axis (XLA hands the
collectives to NCCL). Multi-host: pass --distributed
(jax.distributed.initialize per host, from a cluster the environment
describes). Supports --resume/--save-state checkpointing (SURVEY.md §5.4).
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
    p.add_argument("--chunk", type=int, default=None,
                   help="chunk length in samples (default: auto)")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices on the time axis (default: all)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: jax.distributed.initialize() first")
    p.add_argument("--resume", default=None, help="state .npz to resume from")
    p.add_argument("--save-state", default=None, help="write state .npz at end")
    p.add_argument("--bits-out", default=None)
    args = p.parse_args(argv)
    enable_compile_cache()

    import jax
    from ..io import read_capture
    from ..pipeline.stream import StreamRx
    from ..shard.mesh import make_mesh, init_distributed
    from ..metrics import RunMetrics

    if args.distributed:
        init_distributed()
    spec = C.spec_from_args(args)
    n_dev = args.devices or len(jax.devices())
    mesh = make_mesh(1, n_dev, devices=jax.devices()[:n_dev])
    rx = StreamRx(spec, mesh=mesh, chunk_len=args.chunk)
    if args.resume:
        rx.load_state(args.resume)

    samples, _ = read_capture(args.capture)
    m = RunMetrics()
    frames = rx.process(samples)
    frames += rx.flush()
    m.update_stream(frames)
    m.samples = len(samples)
    m.tracking = rx.tracking()
    if args.save_state:
        rx.save_state(args.save_state)
    if args.bits_out and frames:
        np.save(args.bits_out, np.stack([f.payload for f in frames]))
    s = m.summary()
    print(f"mesh time={n_dev}: {s['frames_detected']} frames, "
          f"{s['frames_ok']} crc-ok; EVM {s['mean_evm_db']:.1f} dB; "
          f"{s['msamples_per_s']:.2f} Msamples/s, "
          f"{s['frames_per_s']:.1f} frames/s", file=sys.stderr)


if __name__ == "__main__":
    main()
