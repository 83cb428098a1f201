"""Continuous-stream receiver: host loop around the sharded streaming step.

Target call stack SURVEY.md §3.4 (pod_rx): the host feeds fixed-size chunks
(the UHD ring buffer's replacement is the double-buffered device_put of the
next chunk while the current one computes); the jitted step shards time
blocks over the mesh, exchanges ppermute halos, psum-averages channel/CFO
tracking, and returns fixed-capacity decoded-frame slots that the host
filters and orders.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from ..core.spec import WaveformSpec
from ..core.state import StreamState
from ..shard.mesh import make_mesh
from ..shard.time_parallel import make_stream_step


@dataclasses.dataclass
class StreamFrame:
    start: int          # global sample offset of the frame
    payload: np.ndarray
    crc_ok: bool
    eps: float
    evm_db: float


class StreamRx:
    """Streaming OFDM receiver over a ('frame','time') mesh's time axis."""

    def __init__(self, spec: WaveformSpec, mesh=None, chunk_len: int | None = None,
                 max_frames_per_shard: int | None = None,
                 threshold: float = 0.5, threshold_mode: str = "fixed",
                 reshard: bool = False, track_mode: bool = True,
                 agc: bool = True, steps_per_dispatch: int = 8,
                 input_format: str = "fc32"):
        self.spec = spec
        self.mesh = mesh if mesh is not None else make_mesh(
            1, len(jax.devices()))
        t = self.mesh.shape["time"]
        h = StreamState.halo_len(spec)
        m = spec.resample_m
        if chunk_len is None:
            # per-shard block rounded up to a multiple of M so the radio
            # chunk (chunk_len * L / M) is integral and L-aligned
            cb = -(-max(2 * h, 4 * spec.frame_len) // m) * m
            chunk_len = t * cb
        if (chunk_len * spec.resample_l) % m:
            raise ValueError("chunk_len*L must be divisible by M")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self.chunk_len = chunk_len              # baseband samples per step
        # radio-rate samples per step (rational: radio = baseband * L / M)
        self.radio_chunk = chunk_len * spec.resample_l // m
        # device-resident K-step dispatch (VERDICT r2 item 1): whenever >=K
        # chunks are buffered they run as ONE lax.scan executable, so the
        # per-step host round trip amortizes K-fold; stragglers use the
        # single-step executable. Numerics are identical either way.
        self.steps_per_dispatch = steps_per_dispatch
        if input_format not in ("fc32", "sc16"):
            raise ValueError(f"unknown input_format {input_format!r}")
        self.input_format = input_format
        self._step, self._multi, self.cb, self.h = make_stream_step(
            spec, self.mesh, chunk_len, max_frames_per_shard,
            (threshold, threshold_mode),
            reshard=reshard, track_mode=track_mode,
            agc=agc, input_format=input_format)
        self.state = StreamState.init(spec)
        self.rescued = 0       # frames recovered by the TRACK-mode retry
        # host-side remainder buffer: complex64 samples, or int16 IQ
        # planes [2, n] when streaming radio-native sc16 (4x fewer
        # host->device bytes)
        self._buf = (np.zeros(0, dtype=np.complex64)
                     if input_format == "fc32"
                     else np.zeros((2, 0), dtype=np.int16))
        # host mirror of state.steps (unbounded Python int): composes the
        # wrap-free global timebase base = steps * chunk_len without
        # fetching device state mid-stream
        self._steps = 0

    def tracking(self) -> dict:
        """Mesh-tracked channel/CFO state (SURVEY.md §5.3/§5.5)."""
        h_t = np.asarray(self.state.h_track)
        return {
            "eps_track": float(np.asarray(self.state.eps_track)),
            "track_wt": float(np.asarray(self.state.track_wt)),
            "h_track_rms": float(np.sqrt(np.mean(np.abs(h_t) ** 2))),
            "rescued": self.rescued,
        }

    def _put_chunk(self, chunk: np.ndarray) -> jax.Array:
        """Build the (possibly multi-host) global sharded chunk array.

        chunk [radio_chunk] (single step) or [K, radio_chunk] (K-step
        dispatch). Every process holds the full chunk host-side (the
        stream source is shared/replicated, as with a common capture
        file); each device receives only its own time-block.
        make_array_from_callback works identically in single- and
        multi-process SPMD (SURVEY.md §5.8).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P
        if chunk.dtype == np.int16:
            # sc16 planes: [2, rc] or [K, 2, rc]; shard the sample axis
            lead = chunk.shape[:-1]
            sh = NamedSharding(self.mesh, P(*(None,) * len(lead), "time"))
            return jax.make_array_from_callback(
                chunk.shape, sh, lambda idx: chunk[idx])
        lead = chunk.shape[:-1]
        sh = NamedSharding(self.mesh, P(*(None,) * len(lead), "time"))
        return jax.make_array_from_callback(
            (*lead, self.radio_chunk), sh, lambda idx: chunk[idx])

    def process(self, samples: np.ndarray) -> list[StreamFrame]:
        """Feed samples at the RADIO rate (any length); returns frames
        completed so far (decoded at baseband).

        Double-buffered feed (the UHD ring buffer's replacement, SURVEY.md
        §2.2-K4): the next dispatch's chunks are device_put and the
        dispatch issued before the previous dispatch's outputs are fetched,
        so host transfers overlap device compute (jit dispatch is async).
        Buffered chunks run K = steps_per_dispatch at a time through the
        device-resident scan; the remainder runs single-step.
        """
        if self.input_format == "sc16":
            if samples.dtype != np.int16 or samples.ndim != 2:
                raise ValueError("sc16 stream expects int16 IQ planes [2, n]")
            self._buf = np.concatenate([self._buf, samples], axis=1)
            n_have = self._buf.shape[1]
        else:
            self._buf = np.concatenate(
                [self._buf, samples.astype(np.complex64)])
            n_have = len(self._buf)
        n_chunks = n_have // self.radio_chunk
        out: list[StreamFrame] = []
        pending = None
        k = self.steps_per_dispatch
        rc = self.radio_chunk
        i = 0
        while i < n_chunks:
            kk = k if (n_chunks - i >= k and k > 1) else 1
            if self.input_format == "sc16":
                flat = self._buf[:, i * rc:(i + kk) * rc]
                dev = self._put_chunk(
                    np.ascontiguousarray(
                        flat.reshape(2, kk, rc).swapaxes(0, 1))
                    if kk > 1 else flat)
            else:
                flat = self._buf[i * rc:(i + kk) * rc]
                dev = self._put_chunk(flat.reshape(kk, rc)
                                      if kk > 1 else flat)
            if kk > 1:
                self.state, outs = self._multi(self.state, dev)
            else:
                self.state, outs = self._step(self.state, dev)
            base = self._steps * self.chunk_len
            self._steps += kk
            i += kk
            if pending is not None:
                out.extend(self._collect(*pending))
            pending = (outs, base, kk)
            # start the device->host copies NOW, so they overlap the next
            # dispatch's compute instead of serializing in _collect
            for v in outs.values():
                v.copy_to_host_async()
        self._buf = (self._buf[:, n_chunks * rc:]
                     if self.input_format == "sc16"
                     else self._buf[n_chunks * rc:])
        if pending is not None:
            out.extend(self._collect(*pending))
        return out

    def flush(self) -> list[StreamFrame]:
        """Zero-pad the remainder (plus one extra chunk so the delayed tail
        is fully processed) and drain."""
        if self.input_format == "sc16":
            pad = (-self._buf.shape[1]) % self.radio_chunk
            return self.process(
                np.zeros((2, pad + self.radio_chunk), dtype=np.int16))
        pad = (-len(self._buf)) % self.radio_chunk
        filler = np.zeros(pad + self.radio_chunk, dtype=np.complex64)
        return self.process(filler)

    def _collect(self, outs, base: int, k: int = 1) -> list[StreamFrame]:
        # fetch the two packed metadata tensors first; the payload bits
        # (the only large array) are fetched only when frames exist. A
        # K-step dispatch pays these fetches once for K chunks (leading
        # [K] axis on every output).
        meta_i = np.asarray(outs["meta_i"])
        if k == 1:
            meta_i = meta_i[None]
        # n_rescued is a per-step broadcast column; read one slot per step
        self.rescued += int(meta_i[:, 0, 3].sum())
        owned = meta_i[:, :, 1].astype(bool)
        if not owned.any():
            return []
        meta_f = np.asarray(outs["meta_f"])
        payload = np.asarray(outs["payload"])
        if k == 1:
            meta_f, payload = meta_f[None], payload[None]
        nb = self.spec.payload_bits_per_frame
        bits = np.unpackbits(payload, axis=-1)[..., :nb]
        res = []
        for kk in range(meta_i.shape[0]):
            idx = np.nonzero(owned[kk])[0]
            if not len(idx):
                continue
            order = np.argsort(meta_i[kk, idx, 2])
            b = base + kk * self.chunk_len
            for i in idx[order]:
                res.append(StreamFrame(
                    start=b + int(meta_i[kk, i, 2]),
                    payload=bits[kk, i],
                    crc_ok=bool(meta_i[kk, i, 0]),
                    eps=float(meta_f[kk, i, 0]),
                    evm_db=float(meta_f[kk, i, 1]),
                ))
        return res

    # ---- checkpoint / resume (SURVEY.md §5.4) ----

    def save_state(self, path: str) -> None:
        """Checkpoint = StreamState leaves + the host-side chunk buffer."""
        import dataclasses as dc
        leaves = {f.name: np.asarray(getattr(self.state, f.name))
                  for f in dc.fields(self.state)}
        # host step mirror saved as int64: the wrap-free global timebase
        np.savez(path, __buf__=self._buf,
                 __steps__=np.int64(self._steps), **leaves)

    def load_state(self, path: str) -> None:
        import dataclasses as dc
        z = np.load(path)
        kw = {}
        for f in dc.fields(StreamState):
            if f.name in z:
                kw[f.name] = z[f.name]
            elif f.name == "steps" and "samples" in z:
                # pre-rename checkpoints carried a device-side sample
                # count; steps = samples // chunk_len (always integral:
                # the counter only advanced by whole chunks)
                kw[f.name] = np.int32(int(z["samples"]) // self.chunk_len)
            else:
                raise ValueError(
                    f"incompatible checkpoint {path!r}: missing StreamState "
                    f"field {f.name!r} (has {sorted(z.files)})")
        self.state = StreamState(**kw)
        self._buf = z["__buf__"]
        if "__steps__" in z:
            self._steps = int(z["__steps__"])
        elif "steps" in z:
            self._steps = int(z["steps"])
        else:
            self._steps = int(z["samples"]) // self.chunk_len
