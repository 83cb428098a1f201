"""Time-block sequence parallelism for the continuous stream (C4/C5).

This is the workload's long-context story (SURVEY.md §2.3, §5.7): the
sample stream is split into contiguous per-chip time blocks; overlap-save
halos ride `lax.ppermute` between neighbours, and channel/CFO tracking is
combined mesh-wide with `psum` — exactly the collective set BASELINE.json
[B:5, B:11] prescribes. XLA hands the collectives to NCCL (NVLink between
the cards of a host); the same collectives work on a multi-host mesh after
jax.distributed.initialize.

Chunk protocol (overlap-save with one-chunk delay, SURVEY.md §5.7):
  * every step consumes chunk [C] (C = T * Cb, sharded P('time')) plus the
    carried tail [H] of the previous chunk;
  * the processing window is ext = tail ++ chunk; shard i sees
    ext[i*Cb : (i+1)*Cb + H]: its own block plus an H-sample halo that is
    the head of its right neighbour's block (via ppermute) — except the
    last shard, whose halo is the fresh tail (chunk[-H:]) passed in
    replicated;
  * a detection at local offset d is OWNED iff d < Cb, giving disjoint
    contiguous ownership [k*C - H, (k+1)*C - H) across steps and shards —
    no frame is decoded twice and none is lost (halo >= frame_len + n_sc);
  * per-frame channel LS estimates and CFO estimates of OWNED frames are
    psum-averaged over the mesh and folded into an EMA tracker in
    StreamState.

The sharded chain is equality-tested against the single-device chain
bit-for-bit in tests/distributed/ (SURVEY.md §5.7 invariant).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.spec import WaveformSpec
from ..core.state import StreamState
from ..phy import sync as PS
from ..pipeline import rx as RXP


def _slot_transpose(x, axis: str, t: int):
    """Tiled all_to_all over the leading (frame-slot) dim.

    With split_axis == concat_axis == 0 this is the (shard, chunk)
    transpose Y[j][i] = X[i][j] — an involution, so applying it twice
    restores the original layout exactly.
    """
    return jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
                              tiled=True)


def _reshard_demod(spec: WaveformSpec, frames, axis: str, t: int,
                   shift: int):
    """Ulysses-analog reshard point (SURVEY.md §2.3): redistribute detected
    frame slots from time-sharding to an even per-chip layout with
    `all_to_all` before the demod/FEC stage, then invert the exchange on
    the (tiny) per-frame outputs so downstream ownership accounting and
    the sharded==unsharded invariant are untouched.

    Detections cluster on whichever shard the frames landed in; demod —
    Viterbi-dominated — is the expensive stage, so spreading the slots
    balances it. Demod is per-frame pure, so compute placement cannot
    change the numbers.
    """
    f = frames.shape[0]
    f2 = -(-f // t) * t
    pad = f2 - f

    def padslots(a):
        if not pad:
            return a
        z = jnp.zeros((pad,) + a.shape[1:], a.dtype)
        return jnp.concatenate([a, z])

    out = RXP._demod_frames(spec, _slot_transpose(padslots(frames), axis, t),
                            shift=shift)
    return {k: _slot_transpose(v, axis, t)[:f] for k, v in out.items()}


def _track_retry(spec: WaveformSpec, frames, eps, shift: int, out: dict,
                 owned, state: StreamState):
    """TRACK-mode re-acquisition (SURVEY.md §5.3 ACQUIRE->TRACK; VERDICT r1
    item 5): slots whose own decode failed CRC are re-demodulated with the
    POD-TRACKED hypothesis — the psum'd EMA channel estimate in place of
    the frame's own (possibly noise-dominated) preamble estimate, and the
    EMA CFO in place of the frame's own noisy single-preamble estimate.
    A slot's first-pass result is kept whenever its CRC passed, so on
    clean streams TRACK mode is bit-invisible (the sharded==unsharded
    invariant is untouched); the retry runs under lax.cond only when some
    valid slot failed and the tracker has history.
    """
    ok0 = out["crc_ok"]
    have = state.track_wt > 0.0

    def retry(_):
        # replace the frames' own total CFO with the tracked EMA (the
        # frames were already derotated by their own eps; apply the delta)
        fr2 = PS.cfo_correct(frames, state.eps_track - eps, spec.n_sc)
        h_t = jnp.broadcast_to(state.h_track[None, :],
                               (frames.shape[0], state.h_track.shape[-1]))
        o2 = RXP._demod_frames_with_h(spec, fr2, shift, h_t)
        return o2["payload"], o2["crc_ok"], o2["evm_db"]

    def skip(_):
        return (out["payload"], jnp.zeros_like(ok0), out["evm_db"])

    # retry only when an OWNED detection failed (empty/invalid slots fail
    # CRC by construction and must not trigger the second pass)
    pay2, ok2, evm2 = jax.lax.cond(
        jnp.any(owned & ~ok0) & have, retry, skip, operand=None)
    use2 = (~ok0) & have & ok2
    merged = dict(out)
    merged["payload"] = jnp.where(use2[:, None], pay2, out["payload"])
    merged["crc_ok"] = ok0 | use2
    merged["evm_db"] = jnp.where(use2, evm2, out["evm_db"])
    eps_f = jnp.where(use2, jnp.broadcast_to(state.eps_track, eps.shape), eps)
    return merged, eps_f, use2


def halo_from_right(head: jax.Array, axis: str) -> jax.Array:
    """Inside shard_map: every shard receives the `head` of its right
    neighbour along `axis` (one ppermute); the last shard receives zeros."""
    perm = [(i, i - 1) for i in range(1, jax.lax.axis_size(axis))]
    if not perm:
        return jnp.zeros_like(head)
    return jax.lax.ppermute(head, axis, perm)


def _shard_step(spec: WaveformSpec, cb: int, h: int, max_frames: int,
                threshold, ema: float, axis: str,
                reshard: bool, track_mode: bool,
                block, halo_fresh, fresh_raw, state: StreamState):
    """Per-shard body inside shard_map.

    block [Cb] — this shard's slice of the chunk (AGC-scaled window);
    halo_fresh [H] — the window's last H samples (the last shard's halo);
    fresh_raw [H] — the same samples UNSCALED (next chunk's carried tail:
    each window is AGC'd as a whole, so the tail must re-enter raw);
    state — replicated StreamState.
    """
    t = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)

    # halo: head H of my block -> left neighbour. The last shard
    # substitutes the fresh tail.
    halo = halo_from_right(block[:h], axis)
    halo = jnp.where(idx == t - 1, halo_fresh, halo)
    ext = jnp.concatenate([block, halo])                     # [Cb + H]

    thr, thr_mode = (threshold if isinstance(threshold, tuple)
                     else (threshold, "fixed"))
    ds, eps_f, valid = PS.detect_frames(spec, ext, max_frames,
                                        threshold=thr,
                                        threshold_mode=thr_mode)
    owned = valid & (ds < cb)
    frames = PS.extract_frames(spec, ext, ds)
    # two-ramp CFO order, the same as pipeline/rx._capture_front
    frames = PS.cfo_correct(frames, eps_f, spec.n_sc)
    k = PS.integer_cfo(spec, frames)
    eps = eps_f + k.astype(jnp.float32)
    frames = PS.cfo_correct(frames, k.astype(jnp.float32), spec.n_sc)
    shift = min(4, spec.cp // 4)
    if reshard:
        out = _reshard_demod(spec, frames, axis, t, shift)
    else:
        out = RXP._demod_frames(spec, frames, shift=shift)
    n_rescued = jnp.int32(0)
    used = jnp.zeros(out["crc_ok"].shape, dtype=bool)
    if track_mode:
        out, eps, used = _track_retry(spec, frames, eps, shift, out, owned,
                                      state)
        n_rescued = jax.lax.psum(jnp.sum((used & owned).astype(jnp.int32)),
                                 axis)
    ok = out["crc_ok"] & owned

    # ---- pod-wide tracking (psum over the time axis) ----
    # fold in FIRST-PASS successes only: a rescued slot's own preamble
    # estimate is the noise that made it fail — it must not enter the EMA
    wt = (ok & ~used).astype(jnp.float32)
    # canonical phase alignment: each frame's H carries an arbitrary
    # common phase (the carrier phase at its capture position survives
    # the frame-local CFO ramp), so raw averaging is INCOHERENT and the
    # EMA would decay toward zero. Rotate each estimate so the phase of
    # its bin-sum is zero — a per-frame canonical form, consistent across
    # frames/shards over a static channel; the retry's per-symbol pilot
    # CPE absorbs the remaining common phase.
    h_est = out["h"]
    ref = jnp.sum(h_est, axis=-1, keepdims=True)
    refa = jnp.abs(ref)
    align = jnp.where(refa > 0, jnp.conj(ref) / jnp.maximum(refa, 1e-30),
                      jnp.ones_like(ref))
    h_aligned = h_est * align
    h_sum = jax.lax.psum(jnp.sum(h_aligned * wt[:, None].astype(jnp.complex64),
                                 axis=0), axis)
    eps_sum = jax.lax.psum(jnp.sum(eps * wt), axis)
    n_sum = jax.lax.psum(jnp.sum(wt), axis)
    n_owned = jax.lax.psum(jnp.sum(owned.astype(jnp.int32)), axis)
    n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), axis)

    have = n_sum > 0
    h_new = jnp.where(have, h_sum / jnp.maximum(n_sum, 1.0), state.h_track)
    eps_new = jnp.where(have, eps_sum / jnp.maximum(n_sum, 1.0),
                        state.eps_track)
    first = state.track_wt == 0.0
    a = jnp.where(first, 1.0, ema)
    h_track = jnp.where(have, (1 - a) * state.h_track + a * h_new,
                        state.h_track)
    eps_track = jnp.where(have, (1 - a) * state.eps_track + a * eps_new,
                          state.eps_track)
    track_wt = state.track_wt + jnp.where(have, 1.0, 0.0)

    new_state = StreamState(
        tail=fresh_raw,  # replicated; identical on every shard
        rtail=state.rtail,  # updated outside shard_map (decimation stage)
        h_track=h_track,
        eps_track=eps_track,
        track_wt=track_wt,
        steps=state.steps + 1,
        frames=state.frames + n_owned,
        crc_ok=state.crc_ok + n_ok,
    )
    # start offset of each detection RELATIVE to this chunk's first sample
    # (may be negative: a frame can begin in the carried tail). The host
    # adds the unbounded chunk base (StreamRx), so the global timebase
    # never wraps regardless of stream length.
    d_rel = ds - h + idx * cb
    # per-slot metadata PACKED into two arrays: every fetched array is its
    # own device->host copy, so the host reads exactly two small tensors
    # plus the payload bits per step
    meta_i = jnp.stack([ok.astype(jnp.int32), owned.astype(jnp.int32),
                        d_rel,
                        jnp.broadcast_to(n_rescued, ds.shape)], axis=-1)
    meta_f = jnp.stack([eps, out["evm_db"]], axis=-1)
    # payload bits packed 8-per-byte on device (np.unpackbits order): 8x
    # less device->host traffic — the per-step fetch IS the streaming
    # loop's host cost
    pay = out["payload"]
    nb = pay.shape[-1]
    nb8 = -(-nb // 8) * 8
    if nb8 != nb:
        pay = jnp.concatenate(
            [pay, jnp.zeros(pay.shape[:-1] + (nb8 - nb,), pay.dtype)],
            axis=-1)
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.float32)
    packed = jnp.matmul(
        pay.reshape(pay.shape[0], nb8 // 8, 8).astype(jnp.float32), w,
        precision=jax.lax.Precision.HIGHEST).astype(jnp.uint8)
    outputs = {
        "payload": packed,              # [max_frames, ceil(bits/8)] u8
        "meta_i": meta_i,               # [max_frames, 4]
        "meta_f": meta_f,               # [max_frames, 2]
    }
    # all_gather -> fully replicated outputs: the host can read them on any
    # process (multi-host pod) without extra transfers; they are tiny
    # (max_frames slots per shard).
    outputs = jax.tree_util.tree_map(
        lambda a: jax.lax.all_gather(a, axis, axis=0, tiled=True), outputs)
    return new_state, outputs


def make_stream_step(spec: WaveformSpec, mesh: jax.sharding.Mesh,
                     chunk_len: int, max_frames_per_shard: int | None = None,
                     threshold=0.5, ema: float = 0.25,
                     reshard: bool = False,
                     track_mode: bool = True, agc: bool = True,
                     input_format: str = "fc32"):
    """Build the jitted sharded streaming step.

    Returns (step, multi, cb, h):
      step(state, chunk [chunk_len])        -> (state, outs)
      multi(state, chunks [K, chunk_len])   -> (state, outs with leading [K])
    chunk_len must be divisible by the 'time' axis size and each block must
    be >= the halo (Cb >= H so the ppermute payload exists).

    `multi` is the device-resident K-step path (VERDICT r2 item 1): one
    dispatch runs a lax.scan over K chunks with the carried StreamState,
    so the per-step host round trip (dispatch and output fetch) amortizes
    K-fold. K is a trace-time shape (jit caches one executable per
    distinct K); numerics are the single-step path's exactly (the scan
    body IS `step`).
    """
    t = mesh.shape["time"]
    assert chunk_len % t == 0, "chunk_len must divide over the time axis"
    cb = chunk_len // t
    h = StreamState.halo_len(spec)
    assert cb >= h, f"block {cb} must be >= halo {h}"
    if max_frames_per_shard is None:
        # back-to-back frames: at most one start per frame_len, +1 boundary
        max_frames_per_shard = cb // spec.frame_len + 2

    body = functools.partial(_shard_step, spec, cb, h,
                             max_frames_per_shard, threshold, ema, "time",
                             reshard, track_mode)

    smapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("time"), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    l, m, nt1 = spec.resample_l, spec.resample_m, 0
    if (l, m) != (1, 1):
        from ..phy import tables as _T
        taps = _T.resample_filter(l, m)
        nt1 = len(taps) - 1
        assert (chunk_len * l) % m == 0, \
            "chunk_len*L must divide by M (radio chunk must be integral)"

    def step(state: StreamState, chunk: jax.Array):
        import dataclasses as _dc
        if (l, m) != (1, 1):
            # in-stream rational resample (C4 and the general L/M case):
            # the chunk arrives at the radio rate [C*l/m]; the causal
            # strided correlation over the carried nt-1 radio samples
            # gives the exact continuous resampling, and radio chunks are
            # multiples of L so the polyphase phase pattern restarts each
            # chunk (no phase state beyond the sample carry).
            from ..kernels.conv_backend import rational_decim_stream
            w = jnp.concatenate([state.rtail, chunk])
            baseband = rational_decim_stream(w, l, m, taps)
            state = _dc.replace(state, rtail=chunk[-nt1:])
            chunk = baseband
        # processing window = tail ++ chunk, i.e. the stream delayed by H:
        # the sharded body covers window[:C] and the chunk's last H samples
        # ride along replicated as the final shard's halo AND the next tail.
        fresh_raw = chunk[chunk_len - h:]
        window = jnp.concatenate([state.tail, chunk])
        if agc:
            # ONE gain per processing window (front-end AGC, SURVEY.md
            # §2.1 #20): frames never straddle windows (the halo covers a
            # whole frame), so no frame sees a gain step; the gain depends
            # only on window content, so sharded == unsharded exactly; and
            # tracked-H magnitudes stay comparable across level changes
            # (the TRACK retry needs that). The carried tail re-enters RAW.
            from ..phy.agc import agc_normalize
            window, _ = agc_normalize(window)
        body_part = window[: chunk_len]
        fresh = window[chunk_len:]
        return smapped(body_part, fresh, fresh_raw, state)

    def multi(state: StreamState, chunks: jax.Array):
        # chunks [K, radio_chunk]: K sequential stream steps in ONE
        # executable — the carry (StreamState, complex leaves included)
        # never crosses the host boundary between steps
        return jax.lax.scan(step, state, chunks)

    if input_format == "sc16":
        # radio-native int16 IQ planes: the host feeds [2, C] ([K, 2, C]
        # for the K-step path) int16 arrays — 4x fewer host->device bytes
        # than complex64 — and the conversion runs ON-DEVICE at the top of
        # the step. The chain
        # after conversion is bit-identical to feeding complex chunks the
        # host scaled by MULTIPLYING by fl(1/32767) (a host that divides
        # by 32767 instead can differ by 1 ulp; frame/CRC-level results
        # agree either way — tests/distributed/test_stream asserts that).
        base_step = step

        def step(state: StreamState, iq: jax.Array):       # noqa: F811
            c = (iq[0].astype(jnp.float32) * (1.0 / 32767.0)
                 + 1j * iq[1].astype(jnp.float32) * (1.0 / 32767.0)
                 ).astype(jnp.complex64)
            return base_step(state, c)

        def multi(state: StreamState, chunks: jax.Array):  # noqa: F811
            return jax.lax.scan(step, state, chunks)

        lead = (None,)
    else:
        lead = ()
    # the carried state (and the tiny outputs) are replicated with ONE
    # fixed sharding on both executables: a state that one of them
    # produced then feeds either without a new compilation
    rep = NamedSharding(mesh, P())
    return (jax.jit(step, in_shardings=(rep, NamedSharding(
                        mesh, P(*lead, "time"))), out_shardings=rep),
            jax.jit(multi, in_shardings=(rep, NamedSharding(
                        mesh, P(None, *lead, "time"))), out_shardings=rep),
            cb, h)
