"""Metrics and observability (SURVEY.md §5.5).

The reference-class system prints frames/EVM to stdout from the RX loop.
Here every jitted step already returns a metrics pytree (counters are step
OUTPUTS, never side effects — jit-safe); this module aggregates them
host-side, computes the judged quantities (EVM dB, BER pre/post FEC, frame
detection rate, Msamples/s, frames/s — BASELINE.json:2) and logs JSONL.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np


def evm_db(measured: np.ndarray, ideal: np.ndarray) -> float:
    err = np.mean(np.abs(measured - ideal) ** 2)
    ref = np.mean(np.abs(ideal) ** 2)
    return float(10.0 * np.log10(err / ref + 1e-300))


def ber(bits_rx: np.ndarray, bits_tx: np.ndarray) -> float:
    assert bits_rx.shape == bits_tx.shape
    return float(np.mean(bits_rx != bits_tx))


@dataclasses.dataclass
class RunMetrics:
    """Host-side aggregator over streaming/batched RX outputs."""

    samples: int = 0
    frames_detected: int = 0
    frames_ok: int = 0
    evm_sum: float = 0.0
    evm_n: int = 0
    tracking: dict | None = None   # StreamRx.tracking() snapshot (§5.3)
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    def update_batch(self, out: dict, n_samples: int) -> None:
        crc = np.asarray(out["crc_ok"])
        valid = np.asarray(out.get("valid", np.ones_like(crc)))
        self.samples += int(n_samples)
        self.frames_detected += int(valid.sum())
        self.frames_ok += int(crc.sum())
        ev = np.asarray(out["evm_db"])[valid.astype(bool)]
        self.evm_sum += float(ev.sum())
        self.evm_n += len(ev)

    def update_stream(self, frames: list) -> None:
        self.frames_detected += len(frames)
        self.frames_ok += sum(f.crc_ok for f in frames)
        self.evm_sum += sum(f.evm_db for f in frames)
        self.evm_n += len(frames)

    def summary(self) -> dict:
        dt = time.perf_counter() - self.t0
        extra = {"tracking": self.tracking} if self.tracking else {}
        return {
            **extra,
            "samples": self.samples,
            "frames_detected": self.frames_detected,
            "frames_ok": self.frames_ok,
            "frame_ok_rate": (self.frames_ok / self.frames_detected
                              if self.frames_detected else 0.0),
            "mean_evm_db": (self.evm_sum / self.evm_n if self.evm_n else 0.0),
            "wall_s": dt,
            "msamples_per_s": self.samples / dt / 1e6 if dt > 0 else 0.0,
            "frames_per_s": self.frames_ok / dt if dt > 0 else 0.0,
        }


class JsonlLogger:
    """Append-only JSONL sink for benchmark records."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **record}) + "\n")
