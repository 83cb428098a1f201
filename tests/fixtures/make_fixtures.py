"""Regenerate the golden-vector regression fixtures (SURVEY.md §4).

Run manually: JAX_PLATFORMS=cpu python tests/fixtures/make_fixtures.py
The .npz files pin demod outputs for PRNG-keyed captures; CI compares.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from ofdm_uhd_tpu.core.spec import ChannelSpec, config  # noqa: E402
from ofdm_uhd_tpu.channel import make_capture  # noqa: E402
from ofdm_uhd_tpu.golden import GoldenModem  # noqa: E402

FIXDIR = os.path.dirname(os.path.abspath(__file__))

CASES = {
    "c1": (config("c1"), ChannelSpec(snr_db=14.0), 4),
    "c2": (config("c2"), ChannelSpec(snr_db=24.0,
                                     multipath_taps=(1.0, 0.35 - 0.2j)), 4),
    "c3": (config("c3"), ChannelSpec(snr_db=28.0, cfo=1.1,
                                     phase_noise_std=3e-4,
                                     timing_offset=222), 4),
}


def build(name):
    spec, ch, n = CASES[name]
    rng = np.random.default_rng(1234)
    gm = GoldenModem(spec)
    payloads = rng.integers(0, 2, (n, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    cap = make_capture(frames, ch, spec.n_sc, gap=250, seed=99)
    results = gm.rx_capture(cap)
    assert len(results) == n and all(r.crc_ok for _, _, r in results), name
    return {
        "capture": cap.astype(np.complex64),
        "payloads": payloads,
        "starts": np.array([d for d, _, _ in results]),
        "eps": np.array([e for _, e, _ in results]),
        "evm_db": np.array([r.evm_db for _, _, r in results]),
    }


if __name__ == "__main__":
    for name in CASES:
        data = build(name)
        np.savez_compressed(os.path.join(FIXDIR, f"golden_{name}.npz"), **data)
        print(f"wrote golden_{name}.npz "
              f"({len(data['capture'])} samples, {len(data['payloads'])} frames)")
