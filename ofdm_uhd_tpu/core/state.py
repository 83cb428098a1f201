"""StreamState — the carried state of the continuous-stream receiver.

The reference-class system keeps this state implicitly in its C++ objects
(NCO phase, AGC level, ring-buffer remainder; SURVEY.md §5.4 — mount empty,
§0). Here it is an explicit pytree carried through the jitted streaming
step, which makes checkpoint/resume trivial (np.savez of the leaves) and
keeps the step function pure.

Fields:
  tail       [H] complex64   — last H baseband samples of the previous chunk
                               (overlap-save continuation, §5.7)
  rtail      [nt-1] c64      — radio-rate filter carry for in-stream
                               polyphase decimation (empty when the spec
                               has no resampling)
  h_track    [n_occ] c64     — pod-averaged EMA channel estimate (psum'd)
  eps_track  scalar f32      — pod-averaged EMA CFO estimate (psum'd)
  track_wt   scalar f32      — EMA accumulated weight (0 until first frame)
  steps      scalar i32      — stream steps (chunks) consumed. The global
                               sample timebase is steps * chunk_len,
                               composed HOST-SIDE with unbounded Python
                               ints (StreamRx); keeping only the step
                               count on-device makes the timebase
                               wrap-free for > 10^13 samples without
                               needing x64 inside jit.
  frames     scalar i32      — frames detected (owned detections only)
  crc_ok     scalar i32      — frames passing CRC
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .spec import WaveformSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StreamState:
    tail: jax.Array
    rtail: jax.Array
    h_track: jax.Array
    eps_track: jax.Array
    track_wt: jax.Array
    steps: jax.Array
    frames: jax.Array
    crc_ok: jax.Array

    @staticmethod
    def halo_len(spec: WaveformSpec) -> int:
        """Halo: a frame detected at the last owned sample must complete,
        and its S&C metric window (2L = n_sc) must be computable."""
        return spec.frame_len + spec.n_sc

    @staticmethod
    def rtail_len(spec: WaveformSpec) -> int:
        if (spec.resample_l, spec.resample_m) == (1, 1):
            return 0
        from ..phy.tables import resample_filter
        return len(resample_filter(spec.resample_l, spec.resample_m)) - 1

    @classmethod
    def init(cls, spec: WaveformSpec) -> "StreamState":
        h = cls.halo_len(spec)
        return cls(
            tail=np.zeros(h, dtype=np.complex64),
            rtail=np.zeros(cls.rtail_len(spec), dtype=np.complex64),
            h_track=np.zeros(spec.n_occupied, dtype=np.complex64),
            eps_track=np.zeros((), dtype=np.float32),
            track_wt=np.zeros((), dtype=np.float32),
            steps=np.zeros((), dtype=np.int32),
            frames=np.zeros((), dtype=np.int32),
            crc_ok=np.zeros((), dtype=np.int32),
        )

    # ---- checkpoint / resume (SURVEY.md §5.4) ----

    def save(self, path: str) -> None:
        leaves, _ = jax.tree_util.tree_flatten(self)
        names = [f.name for f in dataclasses.fields(self)]
        np.savez(path, **{n: np.asarray(v) for n, v in zip(names, leaves)})

    @classmethod
    def load(cls, path: str) -> "StreamState":
        z = np.load(path)
        kw = {f.name: z[f.name] for f in dataclasses.fields(cls)}
        return cls(**kw)
