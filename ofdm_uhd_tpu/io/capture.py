"""IQ capture file I/O and stream sources — the UHD replacement (T0).

The reference-class system's L0 is libuhd streaming from a USRP
(SURVEY.md §1.1, §2.2-K4; mount empty, §0). BASELINE.json [B:5] replaces it
with file/stream sample sources. Formats:

* `.npy`            — complex64/complex128 numpy array (native path)
* `.iq` / `.bin`    — interleaved int16 I/Q (the on-the-wire format UHD
                      calls 'sc16'; scale 32767) or interleaved float32
                      ('fc32'), chosen by the JSON sidecar
* `<file>.json`     — SigMF-style sidecar: {"format": "sc16"|"fc32",
                      "sample_rate": float, "center_freq": float, ...}

The int16 path can use the native C deframer (ofdm_uhd_tpu.io.native) when
built — the one host-side component where native code pays (SURVEY.md §2.2
note) — with a NumPy fallback that is always available.
"""

from __future__ import annotations

import json
import os

import numpy as np

SC16_SCALE = 32767.0


def _sidecar(path: str) -> str:
    return path + ".json"


def write_capture(path: str, samples: np.ndarray, fmt: str = "auto",
                  meta: dict | None = None) -> None:
    """Write samples; format from extension ('.npy') or sidecar fmt."""
    samples = np.asarray(samples)
    if path.endswith(".npy"):
        np.save(path, samples.astype(np.complex64))
        if meta:
            with open(_sidecar(path), "w") as f:
                json.dump(meta, f)
        return
    if fmt == "auto":
        fmt = "sc16"
    if fmt == "sc16":
        scaled = np.clip(samples * SC16_SCALE, -32768, 32767)
        inter = np.empty(2 * len(samples), dtype=np.int16)
        inter[0::2] = np.round(scaled.real).astype(np.int16)
        inter[1::2] = np.round(scaled.imag).astype(np.int16)
    elif fmt == "fc32":
        inter = np.empty(2 * len(samples), dtype=np.float32)
        inter[0::2] = samples.real.astype(np.float32)
        inter[1::2] = samples.imag.astype(np.float32)
    else:
        raise ValueError(f"unknown format {fmt!r}")
    inter.tofile(path)
    side = {"format": fmt, **(meta or {})}
    with open(_sidecar(path), "w") as f:
        json.dump(side, f)


def read_capture(path: str) -> tuple[np.ndarray, dict]:
    """Read a capture -> (complex64 samples, metadata dict)."""
    meta = {}
    if os.path.exists(_sidecar(path)):
        with open(_sidecar(path)) as f:
            meta = json.load(f)
    if path.endswith(".npy"):
        return np.load(path).astype(np.complex64), meta
    fmt = meta.get("format", "sc16")
    if fmt == "sc16":
        try:
            from .native import deframe_sc16
            with open(path, "rb") as f:
                return deframe_sc16(f.read()), meta
        except ImportError:
            raw = np.fromfile(path, dtype=np.int16).astype(np.float32)
            return ((raw[0::2] + 1j * raw[1::2]) / SC16_SCALE
                    ).astype(np.complex64), meta
    elif fmt == "fc32":
        raw = np.fromfile(path, dtype=np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64), meta
    raise ValueError(f"unknown format {fmt!r}")


class CaptureReader:
    """Block-oriented reader — the RX stream source (UHD recv analog).

    Emits fixed-size blocks; the final partial block is zero-padded, with
    `exhausted` set, mirroring end-of-burst semantics.
    """

    def __init__(self, path: str, block: int = 65536):
        self.samples, self.meta = read_capture(path)
        self.block = block
        self.pos = 0

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.samples)

    def read_block(self) -> np.ndarray:
        out = np.zeros(self.block, dtype=np.complex64)
        take = min(self.block, len(self.samples) - self.pos)
        if take > 0:
            out[:take] = self.samples[self.pos : self.pos + take]
        self.pos += take if take > 0 else self.block
        return out

    def __iter__(self):
        while not self.exhausted:
            yield self.read_block()


class CaptureWriter:
    """Block-oriented writer — the TX sink (UHD send analog)."""

    def __init__(self, path: str, fmt: str = "auto", meta: dict | None = None):
        self.path, self.fmt, self.meta = path, fmt, meta
        self._parts: list[np.ndarray] = []

    def write_block(self, samples: np.ndarray) -> None:
        self._parts.append(np.asarray(samples).astype(np.complex64))

    def close(self) -> None:
        allsam = (np.concatenate(self._parts) if self._parts
                  else np.zeros(0, np.complex64))
        write_capture(self.path, allsam, self.fmt, self.meta)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SyntheticSource:
    """Deterministic fake radio: frames + impairments on demand (the test
    double for over-the-air input, SURVEY.md §4 fixtures)."""

    def __init__(self, spec, channel, n_frames: int, gap: int = 300,
                 seed: int = 0, block: int = 65536):
        from ..golden import GoldenModem
        from ..channel import make_capture
        rng = np.random.default_rng(seed)
        gm = GoldenModem(spec)
        self.payloads = rng.integers(
            0, 2, (n_frames, spec.payload_bits_per_frame)).astype(np.uint8)
        frames = np.stack([gm.modulate_frame(p) for p in self.payloads])
        self.samples = make_capture(frames, channel, spec.n_sc, gap=gap,
                                    seed=seed).astype(np.complex64)
        self.block = block
        self.pos = 0

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.samples)

    def read_block(self) -> np.ndarray:
        out = np.zeros(self.block, dtype=np.complex64)
        take = min(self.block, len(self.samples) - self.pos)
        if take > 0:
            out[:take] = self.samples[self.pos : self.pos + take]
        self.pos += take if take > 0 else self.block
        return out
