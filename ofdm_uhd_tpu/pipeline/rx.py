"""Batched RX pipeline: one fused jitted graph per spec.

Target call stack (SURVEY.md §3.3): [resample to baseband] -> [S&C detect +
CFO correct] -> CP strip + FFT -> chanest -> EQ -> phase track -> LLR demap
-> deinterleave -> Viterbi -> descramble -> CRC. Replaces the
reference-class ofdm_rx DSP thread (§3.1; mount empty, §0).

Two modes:
  rx_aligned(frames)  — known frame boundaries (loopback C1/C2/C4)
  rx_capture(capture) — continuous capture with fixed-capacity S&C
                        detection (C3); invalid slots masked, not branched
The only host round-trips are input feed and result fetch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.spec import WaveformSpec, CRC_BITS, TAIL_BITS
from ..kernels import fir as K2
from ..kernels import viterbi as KV
from ..phy import agc as PA
from ..phy import bits as PB
from ..phy import frame as PF
from ..phy import qam as PQ
from ..phy import sync as PS
from ..phy import tables as T


class RxPipeline:
    def __init__(self, spec: WaveformSpec, shift: int = 0,
                 sync_threshold: float = 0.5, diag: bool = True,
                 sync_threshold_mode: str = "fixed"):
        # diag=False drops the diagnostic leaves (data_syms, cpe, h) from
        # results: the bench/production path needs only bits + metrics
        # (EVM is computed inside either way), and every output leaf is
        # device memory and a device->host copy.
        self.spec = spec
        self.shift = shift
        self.sync_threshold = sync_threshold
        self.sync_threshold_mode = sync_threshold_mode
        self._aligned = jax.jit(
            functools.partial(_rx_aligned, spec, shift, diag))
        self._capture = jax.jit(
            functools.partial(_rx_capture, spec, sync_threshold, diag,
                              threshold_mode=sync_threshold_mode),
            static_argnames=("max_frames",))
        self._capture_sc16 = jax.jit(
            functools.partial(_rx_capture_sc16, spec, sync_threshold, diag,
                              threshold_mode=sync_threshold_mode),
            static_argnames=("max_frames",))

    def rx_aligned(self, frames: jax.Array) -> dict:
        """frames [B, frame_len_radio] -> result dict (all [B, ...])."""
        return self._aligned(frames)

    def rx_capture(self, capture: jax.Array, max_frames: int) -> dict:
        """capture [n] -> result dict with [max_frames, ...] slots + 'valid'.

        Batched form: capture [C, n] -> every result leaf gains a leading
        [C] axis (the chain is vmapped over independent captures up to the
        LLRs, and the C*max_frames slots decode as one batch).
        """
        return self._capture(capture, max_frames=max_frames)

    def rx_capture_sc16(self, iq: jax.Array, max_frames: int) -> dict:
        """Capture RX from radio-native sc16 IQ: iq int16 [2, n] or
        [2, C, n] (real/imag planes, UHD wire format, full-scale 32767).

        The int16->complex conversion happens ON-DEVICE inside the jitted
        chain: host->device moves 4x fewer bytes than complex64, as the
        reference's UHD recv path streams sc16 and converts on the host.
        """
        return self._capture_sc16(iq, max_frames=max_frames)


def _to_baseband(spec: WaveformSpec, x: jax.Array) -> jax.Array:
    """Radio rate -> baseband (inverse of the TX resampling)."""
    l, m = spec.resample_l, spec.resample_m
    if l == 1 and m == 1:
        return x
    taps = T.resample_filter(l, m)
    y = x
    if m > 1:  # TX decimated by m -> RX interpolates by m
        y = K2.polyphase_interp(y, m, taps, precision=spec.filter_precision)
    if l > 1:  # TX interpolated by l -> RX decimates by l
        y = K2.polyphase_decim(y, l, taps, precision=spec.filter_precision)
    return y


def _grid_demod(spec: WaveformSpec, grid: jax.Array, h: jax.Array) -> dict:
    """EQ/CPE/LLR demap from an FFT grid and a channel estimate.

    Split out of _frontend so the streaming TRACK mode can re-demodulate
    with the pod-tracked channel estimate instead of the frame's own
    (shard/time_parallel.py re-acquisition retry).
    """
    with jax.named_scope("chanest_eq_cpe"):
        eq = PF.equalize(spec, grid, h)
        data, cpe = PF.track_phase(spec, eq)
    with jax.named_scope("llr_demap"):
        csi = jnp.broadcast_to(PF.data_csi(spec, h)[:, None, :], data.shape)
        llr = PQ.qam_demap_llr(data, spec.modulation, csi=csi)
        llr = llr.reshape(-1, spec.coded_bits_per_frame)
    hard_bits = PQ.qam_demap_hard(data, spec.modulation)
    ideal = PQ.qam_map(hard_bits, spec.modulation)
    err = jnp.mean(jnp.abs(data.reshape(data.shape[0], -1)
                           - ideal.reshape(data.shape[0], -1)) ** 2, axis=-1)
    ref = jnp.mean(jnp.abs(ideal.reshape(data.shape[0], -1)) ** 2, axis=-1)
    evm_db = 10.0 * jnp.log10(err / ref + 1e-30)
    return {"llr": llr, "evm_db": evm_db, "data_syms": data, "cpe": cpe,
            "h": h}


def _frontend(spec: WaveformSpec, frames: jax.Array, shift: int) -> dict:
    """Symbol-domain front end: FFT -> chanest/EQ/CPE -> LLR demap.

    Ends at the LLR boundary — the natural inter-stage payload for the
    optional stage pipeline (shard/stage_pipeline.py): a fixed-shape f32
    array, after which only bit-domain FEC/CRC work remains.

    jax.named_scope ranges per chain stage show up in profiler traces
    (SURVEY.md §5.1) at zero runtime cost.
    """
    with jax.named_scope("ofdm_fft"):
        grid = PF.ofdm_demodulate(spec, frames, shift=shift)
    h = PF.estimate_channel(spec, grid)
    return _grid_demod(spec, grid, h)


def _demod_frames(spec: WaveformSpec, frames: jax.Array, shift: int,
                  diag: bool = True) -> dict:
    """Core symbol/bit recovery for frame-aligned baseband samples [B, frame_len]."""
    out = _frontend(spec, frames, shift)
    return _finish(spec, out, diag)


def _finish(spec: WaveformSpec, out: dict, diag: bool) -> dict:
    """Decode the 'llr' leaf of a front-end result [..., coded] (any
    leading batch dims, decoded as one flat batch) into payload/crc_ok."""
    llr = out.pop("llr")
    lead = llr.shape[:-1]
    with jax.named_scope("fec_decode"):
        payload, crc_ok = _decode(spec, llr.reshape(-1, llr.shape[-1]))
    out.update({"payload": payload.reshape(lead + payload.shape[-1:]),
                "crc_ok": crc_ok.reshape(lead)})
    if not diag:
        for k in ("data_syms", "cpe", "h"):
            out.pop(k)
    return out


def _demod_frames_with_h(spec: WaveformSpec, frames: jax.Array, shift: int,
                         h: jax.Array) -> dict:
    """Like _demod_frames but with an EXTERNAL channel estimate h
    [B, n_occupied] (the pod-tracked EMA) instead of the frames' own
    preamble estimate — the streaming TRACK-mode retry path."""
    grid = PF.ofdm_demodulate(spec, frames, shift=shift)
    out = _grid_demod(spec, grid, h)
    payload, crc_ok = _decode(spec, out.pop("llr"))
    out.update({"payload": payload, "crc_ok": crc_ok})
    return out


def _decode(spec: WaveformSpec, llr: jax.Array
            ) -> tuple[jax.Array, jax.Array]:
    """Interleaved coded LLRs [B, coded] -> (payload [B, n], crc_ok [B])."""
    llr_d = PB.deinterleave_soft(llr, spec.coded_bits_per_sym)
    llr_d = PB.depuncture_llr(llr_d, spec.fec_rate,
                              2 * spec.uncoded_bits_per_frame)
    # all decoders emit identical bits on every decodable frame (windowed
    # and the fused kernel can differ from the scan only on CRC-failing
    # garbage, which the CRC gate discards either way)
    decoded = KV.viterbi(llr_d, spec.kernel_backend, spec.viterbi_mode)
    body = PB.descramble(decoded[:, : decoded.shape[-1] - TAIL_BITS])
    payload = body[:, : body.shape[-1] - CRC_BITS]
    crc_rx = body[:, body.shape[-1] - CRC_BITS:]
    return payload, PB.crc32_check(payload, crc_rx)


def _rx_capture_sc16(spec: WaveformSpec, threshold: float, diag: bool,
                     iq: jax.Array, max_frames: int,
                     threshold_mode: str = "fixed") -> dict:
    """iq int16 [2, ...]: planes -> complex64 on-device, then the chain.

    The chain is scale-invariant (S&C metric is normalized; the channel
    estimate absorbs amplitude), so the 1/32767 full-scale factor is
    cosmetic but keeps EVM/power metrics comparable to fc32 inputs.
    """
    c = (iq[0].astype(jnp.float32) * (1.0 / 32767.0)
         + 1j * iq[1].astype(jnp.float32) * (1.0 / 32767.0)
         ).astype(jnp.complex64)
    return _rx_capture(spec, threshold, diag, c, max_frames,
                       threshold_mode=threshold_mode)


def _rx_aligned(spec: WaveformSpec, shift: int, diag: bool,
                frames: jax.Array) -> dict:
    return _demod_frames(spec, _to_baseband(spec, frames), shift, diag)


def _rx_capture(spec: WaveformSpec, threshold: float, diag: bool,
                capture: jax.Array, max_frames: int,
                threshold_mode: str = "fixed") -> dict:
    front = functools.partial(_capture_front, spec, threshold, max_frames,
                              threshold_mode)
    # [C, n]: the front end is vmapped over captures; the decoder takes
    # all C*max_frames slots as one batch
    out = jax.vmap(front)(capture) if capture.ndim == 2 else front(capture)
    det_sat = out.pop("det_sat")
    out = _finish(spec, out, diag)
    out["crc_ok"] = out["crc_ok"] & out["valid"]
    if diag:
        # candidate-extraction overflow indicator: TRUE means
        # a 512-sample block held more rising edges than the hierarchical
        # extractor's capacity and a frame MAY have been missed — callers
        # should not rely on the CRC gate alone to notice that.
        out["det_sat"] = det_sat
    return out


def _capture_front(spec: WaveformSpec, threshold: float, max_frames: int,
                   threshold_mode: str, capture: jax.Array) -> dict:
    """One capture [n] -> detection, extraction, CFO and the symbol-domain
    front end, up to the LLRs of max_frames slots."""
    pad = (-capture.shape[-1]) % spec.resample_l  # decimation needs n % L == 0
    if pad:  # static: resolved at trace time
        capture = jnp.pad(capture, (0, pad))
    capture = _to_baseband(spec, capture[None, :])[0]
    with jax.named_scope("agc"):
        # front-end AGC (SURVEY.md §2.1 #20): the S&C metric is level-
        # normalized and the EQ absorbs static gain, so this is numeric
        # conditioning — raw sc16-scale or heavily attenuated captures
        # land in a uniform power regime before thresholds/CSI
        capture, _ = PA.agc_normalize(capture)
    ds, eps_f, valid, det_sat = PS.detect_frames(
        spec, capture, max_frames, threshold=threshold,
        threshold_mode=threshold_mode, with_sat=True)
    frames = PS.extract_frames(spec, capture, ds)
    # two full-frame ramps: derotate by the fractional CFO, search the
    # integer CFO on the clean sym-B window, then apply the integer ramp.
    # Two ramps differ from the composed ramp by ~1 ulp
    # (fl(e^a)*fl(e^b) vs fl(e^{a+b})); k decisions and every CRC/EVM
    # gate are unaffected.
    frames = PS.cfo_correct(frames, eps_f, spec.n_sc)
    k = PS.integer_cfo(spec, frames)
    eps = eps_f + k.astype(jnp.float32)
    frames = PS.cfo_correct(frames, k.astype(jnp.float32), spec.n_sc)
    out = _frontend(spec, frames, shift=min(4, spec.cp // 4))
    out.update({"d": ds, "eps": eps, "valid": valid, "det_sat": det_sat})
    return out
