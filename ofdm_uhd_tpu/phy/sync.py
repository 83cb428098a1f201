"""JAX Schmidl-Cox synchronization: fixed-capacity frame detection under jit.

This is the hard jit problem of the chain (SURVEY.md §7.3 #1): S&C yields a
DATA-DEPENDENT number of frames at data-dependent offsets, but XLA needs
static shapes. Design: `max_frames` detection slots filled by a lax.scan
that repeatedly finds the first above-threshold metric sample after the
previous frame, localizes the plateau (90%-of-peak midpoint rule, [P:9]),
and emits (d, eps, valid). Invalid slots are masked, never branched on.

Frame extraction is a vmapped dynamic_slice; CFO correction applies the NCO
ramp per frame (SURVEY.md §2.1 #16-#17).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import WaveformSpec
from ..kernels.sync import sc_correlate, sc_metric
from . import tables as T


def detect_frames(spec: WaveformSpec, capture: jax.Array, max_frames: int,
                  threshold: float = 0.5, rel: float = 0.9,
                  threshold_mode: str = "fixed", cfar_k: float = 16.0,
                  with_sat: bool = False):
    """capture [n] -> (d [max_frames] i32, eps [max_frames] f32, valid [max_frames] bool).

    d = estimated first sample of each frame; eps = fractional CFO in
    subcarrier spacings from angle(P)/pi. Same first-crossing + local
    plateau midpoint - cp/2 rule as golden.sync.coarse_sync, anchored at
    rising edges of the above-threshold mask.

    PARALLEL formulation: a sequential search would run max_frames (~130
    for the C3 bench capture) dependent lax.scan iterations, each doing a
    block probe + span-wide plateau localization. Here the data-dependent
    chain is split into
      1. candidate enumeration: rising edges of (M >= threshold), compacted
         to the first `max_cand` indices with one top_k — O(n) parallel;
      2. per-candidate plateau localization + CFO: a vmapped slot body,
         all candidates at once;
      3. greedy spacing selection (next kept candidate >= prev d +
         frame_len — the same advance rule the sequential slot scan
         applied): a lax.scan of ~6 SCALAR ops per candidate, microseconds
         total.
    Equivalence to the sequential rule: for frames separated by
    below-threshold gaps (any real stream: the S&C plateau spans ~cp
    samples around each preamble and the metric collapses over data/idle
    regions), the sequential "first crossing >= pos" IS the next rising
    edge, so selections and d values are identical. For back-to-back
    frames the anchor may shift a few samples within the same plateau —
    both anchors localize the same plateau and land within the CP window
    (the chain's shift tolerance; property tests gate this).
    """
    l = spec.n_sc // 2
    n = capture.shape[-1]
    p, rr = sc_correlate(capture, l)
    m = sc_metric(p, rr)
    nd = m.shape[-1]
    span = spec.sym_len

    # threshold_mode 'cfar' (SURVEY.md §2.1 #16 low-SNR robustness): the
    # fixed 0.5 threshold misses preambles below ~0 dB, where the S&C
    # plateau height (snr/(1+snr))^2 drops under it while the noise-floor
    # metric stays near ~1/L. A noise-floor-adaptive threshold
    # k * median(M) (median is robust to <50% frame occupancy) tracks the
    # actual floor; clipped into [0.05, threshold] so it never exceeds
    # the configured fixed threshold nor chases zero-signal noise to 0.
    # k=16: the noise metric's extreme tail reaches ~12x its median over
    # ~50k-sample captures at L=32 (measured r4), so 16x keeps false
    # alarms out while sitting well under the 0 dB plateau (~0.25 at
    # L-independent (snr/(1+snr))^2).
    # Streaming shards apply it per detection window — the same
    # window-content-only argument that makes per-window AGC sharded ==
    # unsharded exact (shard/time_parallel.py) applies.
    if threshold_mode == "cfar":
        thr = jnp.clip(cfar_k * jnp.median(m), 0.05, threshold)
    else:
        thr = jnp.float32(threshold)

    above = m >= thr
    rise = above & ~jnp.concatenate(
        [jnp.zeros(1, dtype=bool), above[:-1]])
    # first max_cand rising-edge indices, ascending (sentinel nd = "no
    # candidate"). Capacity: one real edge per frame plus margin for
    # noise-induced re-crossings at plateau edges; data-region metric
    # ~O(1/L) almost never crosses a 0.5 threshold.
    max_cand = min(4 * max_frames + 16, nd)
    cand, sat = _first_k_indices(rise, max_cand, sentinel=nd,
                                 with_sat=True)              # [max_cand]
    found_c = cand < nd

    ds_c, eps_c = localize(m, p, cand, span, spec.cp, rel=rel)
    valid_c = found_c & (ds_c + spec.frame_len <= n)

    # eligibility slack: the anchor d = plateau_mid - cp/2 can overshoot its
    # own rising edge by up to ~span, so for near-back-to-back frames
    # (stride - frame_len < span, e.g. C4's 8x-decimated gap) pos = d +
    # frame_len may land just PAST the next frame's only rising edge. The
    # sequential rule this replaces fired on "first above-threshold sample
    # >= pos" (mid-plateau), which tolerated that; the rising-edge
    # candidate form needs the window widened by one symbol. Same-plateau
    # re-crossings stay excluded: they lie within ~span of the kept edge,
    # far inside frame_len - span for every real geometry (>= 3 symbols
    # per frame).
    slack = span
    keeps = _select_doubling(spec, cand, ds_c, valid_c, found_c, slack)

    # compact kept candidates into the max_frames output slots in order:
    # slot j <- the j-th kept candidate. BLOCK-CHUNKED (r5): the direct
    # one-hot slot matrix is O(max_frames * max_cand) = O(mf^2); this
    # form scans the candidates in _SEL_KB blocks, compacting each with
    # a small [KB, KB] one-hot and writing it at the carried output
    # offset (scan steps are sequential, so a block's zero tail is
    # overwritten by the next block's keeps). Bit-identical outputs;
    # integer sums (not f32 matmul) so ds stays exact past 2^24 samples.
    ds, epss, valids = _compact_blocks(ds_c, eps_c, keeps, max_frames)
    out = (ds, epss, valids)
    if with_sat:
        # overflow indicator (ADVICE r4): TRUE when any 512-sample block
        # held more rising edges than the hierarchical extractor's
        # per-block capacity — i.e. a candidate MAY have been dropped
        # (the direct-top_k equivalence argument no longer applies).
        return out + (sat,)
    return out


def localize(m: jax.Array, p: jax.Array, cand: jax.Array, span: int,
             cp: int, rel: float = 0.9) -> tuple[jax.Array, jax.Array]:
    """Per-candidate plateau localization: m [nd] metric, p [nd] S&C
    correlation, cand [mf] i32 rising edges -> (d [mf] i32, eps [mf] f32).

    For each candidate c, over the window m[c : c + span] (zeros past the
    end): the peak is the first-index argmax, the plateau [lo, hi] spans
    the first and last samples >= rel * peak, d = max(c + (lo + hi) // 2
    - cp // 2, 0), and eps = angle(P at the peak) / pi. A vmapped
    dynamic_slice of `span` samples per candidate, which XLA emits as one
    gather.
    """
    nd = m.shape[-1]
    m_pad = jnp.concatenate([m, jnp.zeros(span, m.dtype)])

    def one(c):
        w = jax.lax.dynamic_slice(m_pad, (c,), (span,))
        peak_off = jnp.argmax(w).astype(jnp.int32)
        ab = w >= rel * jnp.max(w)
        lo = jnp.argmax(ab).astype(jnp.int32)
        hi = span - 1 - jnp.argmax(ab[::-1]).astype(jnp.int32)
        d = jnp.maximum(c + (lo + hi) // 2 - cp // 2, 0)
        pv = jax.lax.dynamic_slice(
            p, (jnp.minimum(c + peak_off, nd - 1),), (1,))[0]
        return d, (jnp.angle(pv) / jnp.pi).astype(jnp.float32)

    return jax.vmap(one)(cand)


_EXTRACT_BS = 512      # block size of the hierarchical index extraction
_EXTRACT_S = 8         # rising-edge capacity per block
_SEL_KB = 256          # selection-doubling block (cost ~ M * KB^2 log KB)


def _compact_blocks(ds_c: jax.Array, eps_c: jax.Array, keeps: jax.Array,
                    max_frames: int):
    """Order-preserving compaction of kept candidates into max_frames
    slots, O(M * KB^2): see the call site in detect_frames."""
    m = keeps.shape[0]
    kb = min(_SEL_KB, m)
    mp = -(-m // kb) * kb
    pad = mp - m
    ds_b = jnp.pad(ds_c.astype(jnp.int32), (0, pad)).reshape(-1, kb)
    eps_b = jnp.pad(eps_c.astype(jnp.float32), (0, pad)).reshape(-1, kb)
    k_b = jnp.pad(keeps, (0, pad)).reshape(-1, kb)
    # inclusive in-block rank by one exact triangular matmul (counts
    # <= KB, so f32 at 'highest' precision is exact)
    tri = jnp.asarray(np.tril(np.ones((kb, kb), np.float32)).T)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    iot = jnp.arange(kb, dtype=jnp.int32)
    nout = max_frames + kb

    def comp(carry, xs):
        off, dsa, epsa, vala = carry
        dsb, epsb, kbk = xs
        rank = mm(kbk.astype(jnp.float32)[None, :], tri)[0].astype(
            jnp.int32)                                       # [kb]
        loc_oh = kbk[None, :] & (rank[None, :] - 1 == iot[:, None])
        cds = jnp.sum(jnp.where(loc_oh, dsb[None, :], 0), axis=1)
        ceps = jnp.sum(jnp.where(loc_oh, epsb[None, :], 0.0), axis=1)
        cval = jnp.any(loc_oh, axis=1)
        offc = jnp.minimum(off, jnp.int32(max_frames))
        dsa = jax.lax.dynamic_update_slice(dsa, cds, (offc,))
        epsa = jax.lax.dynamic_update_slice(epsa, ceps, (offc,))
        vala = jax.lax.dynamic_update_slice(vala, cval, (offc,))
        return (off + jnp.sum(kbk.astype(jnp.int32)), dsa, epsa,
                vala), None

    init = (jnp.int32(0),
            jnp.zeros(nout, jnp.int32),
            jnp.zeros(nout, jnp.float32),
            jnp.zeros(nout, bool))
    (_, dsa, epsa, vala), _ = jax.lax.scan(comp, init,
                                           (ds_b, eps_b, k_b))
    return dsa[:max_frames], epsa[:max_frames], vala[:max_frames]


def _first_k_indices(rise: jax.Array, k: int, sentinel: int,
                     with_sat: bool = False):
    """First k TRUE indices of a sparse [n] bitmap, ascending; empty
    slots = sentinel. with_sat=True also returns a scalar bool flag:
    TRUE iff any block exceeded the _EXTRACT_S per-block capacity
    (i.e. the result may have dropped a true index).

    The direct form — top_k over the negated index vector — is a
    multi-pass sort over every sample of the capture.
    Hierarchical form: (1) per-512-block inclusive lane cumsum of the
    bitmap by one exact f32 triangular matmul (values <= 512);
    (2) the first _EXTRACT_S rise positions per block via rank-match
    one-hot integer reduces (no gathers); (3) one CHEAP top_k over the
    nb*_EXTRACT_S block slots (~8.7k elements, 64x smaller). Block-major
    slot order is globally ascending, so results are identical to the
    direct form whenever no 512-sample window holds more than _EXTRACT_S
    rising edges — real plateau-edge flicker produces a handful of
    re-crossings within ~a symbol; 8 per 512 samples only truncates in
    adversarial noise where detections are CRC-gated garbage anyway.
    """
    n = rise.shape[-1]
    bs, cap = _EXTRACT_BS, _EXTRACT_S
    nb = -(-n // bs)
    r = jnp.pad(rise, (0, nb * bs - n)).reshape(nb, bs)
    tri = jnp.asarray(np.tril(np.ones((bs, bs), np.float32)).T)
    rank = jnp.matmul(r.astype(jnp.float32), tri,
                      precision=jax.lax.Precision.HIGHEST)   # [nb, bs]
    rank = rank.astype(jnp.int32)
    iota = jnp.arange(bs, dtype=jnp.int32)[None, :]
    base = (jnp.arange(nb, dtype=jnp.int32) * bs)[:, None]
    slots = []
    for s in range(1, cap + 1):
        oh = r & (rank == s)
        pos = jnp.sum(jnp.where(oh, base + iota, 0), axis=1)  # [nb]
        has = jnp.any(oh, axis=1)
        slots.append(jnp.where(has, pos, jnp.int32(sentinel)))
    flat = jnp.stack(slots, axis=1).reshape(nb * cap)         # ascending/blk
    if flat.shape[0] < k:                      # tiny windows: pad slots
        flat = jnp.pad(flat, (0, k - flat.shape[0]),
                       constant_values=sentinel)
    idx = -jax.lax.top_k(-flat, k)[0]
    if with_sat:
        # rank[:, -1] is each block's inclusive rise count (exact <= 512)
        return idx, jnp.any(rank[:, -1] > cap)
    return idx


def _select_scan(spec: WaveformSpec, cand, ds_c, valid_c, found_c,
                 slack: int) -> jax.Array:
    """Reference greedy spacing selection: sequential lax.scan (~6 scalar
    ops per candidate). Kept as the semantic oracle for
    tests/unit/test_select_doubling.py — the production path is
    _select_doubling, which is this recurrence exactly, without a
    max_cand-long chain of dependent loop steps."""

    def sel(carry, x):
        pos, dead = carry
        c, d, v, f = x
        elig = f & (c >= pos - slack) & ~dead
        keep = elig & v
        # an eligible-but-invalid detection (frame runs past the capture
        # end) halts the search, mirroring the sequential pos_next = nd
        dead = dead | (elig & ~v)
        pos = jnp.where(keep, d + spec.frame_len, pos)
        return (pos, dead), keep

    (_, _), keeps = jax.lax.scan(
        sel, (jnp.int32(0), jnp.zeros((), dtype=bool)),
        (cand, ds_c, valid_c, found_c))
    return keeps


def _select_doubling(spec: WaveformSpec, cand, ds_c, valid_c, found_c,
                     slack: int) -> jax.Array:
    """Greedy spacing selection as PARALLEL successor-matrix doubling —
    bit-identical to _select_scan, with log-depth instead of a sequential
    chain.

    The scan's recurrence is a FUNCTION graph: after keeping candidate i,
    the next chain node is the FIRST candidate j with
    cand[j] >= ds_c[i] + frame_len - slack (candidates ascend, and that
    bound exceeds cand[i] for any >=2-symbol frame, so j > i). Each node
    has <= 1 out-edge, so the one-hot successor matrix F satisfies: F^t
    is 0/1 and the kept set is the orbit of node 0 restricted to valid
    candidates, with the chain dying at not-found (sentinel) or invalid
    nodes — exactly the scan's `dead` rule. Reachability S = sum_t F^t
    comes from log2(M) rounds of S += P @ S; P = P @ P (paths are unique,
    so every entry stays 0/1 and f32 matmuls are exact). ~10 matmuls of
    [536, 536] replace a 536-step scalar scan.

    Cost control: the doubling is cubic in the candidate count, which
    grows with the detection window (streaming at 4M-sample chunks has
    ~4k slots, and a single [4k, 4k] doubling is ~64x the work of 16
    [256, 256] blocks). Candidates are therefore processed in BLOCKS
    of _SEL_KB: doubling within each block, and a tiny (pos, dead) carry
    — the sequential rule's own state — rides a lax.scan across blocks
    (nb scalar-ish steps; the chain's block entry node is the first
    eligible candidate under the carried pos, and a chain that leaves a
    block simply has no in-block successor edge). Total cost drops from
    M^3 log M to M * KB^2 log KB.

    Equivalence is asserted against _select_scan over randomized
    candidate geometries (incl. multi-block sizes) in
    tests/unit/test_select_doubling.py and by every detection-level test
    downstream.
    """
    m = cand.shape[0]
    fl = spec.frame_len
    kb = min(_SEL_KB, m)
    mp = -(-m // kb) * kb
    pad = mp - m
    cand_p = jnp.pad(cand, (0, pad), constant_values=2**30)
    xi_p = jnp.pad(ds_c + fl - slack, (0, pad), constant_values=2**30)
    v_p = jnp.pad(valid_c, (0, pad))
    f_p = jnp.pad(found_c, (0, pad))
    blocks = (cand_p.reshape(-1, kb), xi_p.reshape(-1, kb),
              v_p.reshape(-1, kb), f_p.reshape(-1, kb))

    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    rounds = int(np.ceil(np.log2(max(kb, 2))))
    # strict-lower-triangular prefix-OR matrix (one tiny exact matmul)
    tri_strict = jnp.asarray(
        np.triu(np.ones((kb, kb), np.float32), k=1))

    def first_true(b):                               # [kb] bool -> one-hot
        pre = mm(b.astype(jnp.float32)[None, :], tri_strict)[0] > 0.5
        return b & ~pre

    def block(carry, xs):
        pos, dead = carry
        c, xi, v, f = xs
        ge = c[None, :] >= xi[:, None]               # [kb, kb]
        has = jnp.any(ge, axis=1)
        j_oh = ge & ~jnp.concatenate(
            [jnp.zeros((kb, 1), bool), ge[:, :-1]], axis=1)
        row_ok = (f & v & has)[:, None]
        fm = (j_oh & row_ok & f[None, :]).astype(jnp.float32)
        s = fm
        p = fm
        for _ in range(rounds):
            s = s + mm(p, s)
            p = mm(p, p)
        # block entry: first eligible candidate under the carried state
        u0 = first_true(f & (c >= pos - slack) & ~dead)
        u0f = u0.astype(jnp.float32)
        reach = (u0f + mm(u0f[None, :], s)[0]) > 0.5
        keeps = reach & v & f
        dead = dead | jnp.any(reach & f & ~v)        # eligible-but-invalid
        # the chain is monotone, so the last keep's threshold is the max
        pos = jnp.maximum(pos, jnp.max(
            jnp.where(keeps, xi + slack, jnp.int32(-2**30))))
        return (pos, dead), keeps

    (_, _), keeps = jax.lax.scan(
        block, (jnp.int32(0), jnp.zeros((), bool)), blocks)
    return keeps.reshape(mp)[:m]


def extract_frames(spec: WaveformSpec, capture: jax.Array,
                   ds: jax.Array) -> jax.Array:
    """[max_frames, frame_len] frames at offsets ds: a vmapped
    dynamic_slice gather over the capture zero-padded by one frame, so a
    frame that runs past the end reads zeros (and offsets past the end are
    clamped to the all-zero pad)."""
    pad = jnp.zeros(spec.frame_len, capture.dtype)
    cap = jnp.concatenate([capture, pad])

    def one(d):
        return jax.lax.dynamic_slice(cap, (d,), (spec.frame_len,))

    return jax.vmap(one)(ds)


def cfo_correct(frames: jax.Array, eps: jax.Array, n_sc: int) -> jax.Array:
    """frames [B, n] * exp(-j 2 pi eps n / n_sc), per-frame eps [B]."""
    n = jnp.arange(frames.shape[-1], dtype=jnp.float32)
    phase = 2.0 * jnp.pi * eps[:, None] * n[None, :] / n_sc
    return frames * jnp.exp(-1j * phase).astype(jnp.complex64)


@functools.lru_cache(maxsize=32)
def _int_cfo_tables(spec: WaveformSpec, search: int):
    """Host-precomputed shifted-bin SELECTION MATRIX for the integer-CFO
    search (one-hot matmul instead of a [n_shifts, n_occ] gather)."""
    t = T.frame_tables(spec)
    occ = np.asarray(t["occupied_bins"], dtype=np.int64)
    shifts = np.arange(-search, search + 1)
    n_s, n_occ = len(shifts), len(occ)
    sel = np.zeros((spec.n_sc, n_s * n_occ), dtype=np.float32)
    for si, s in enumerate(shifts):
        sel[(occ + s) % spec.n_sc, si * n_occ + np.arange(n_occ)] = 1.0
    ref = np.asarray(t["sym_b_occ_conj"])                   # conj(X_B) on occ
    return sel, ref, shifts.astype(np.float32), n_s, n_occ


def integer_cfo(spec: WaveformSpec, frames: jax.Array,
                search: int = 4) -> jax.Array:
    """Integer CFO per frame [B] from preamble sym B (differential corr).

    Twin of golden.sync.integer_cfo, vectorized over frames and shifts.
    """
    sel, ref, shifts, n_s, n_occ = _int_cfo_tables(spec, search)
    start = spec.sym_len + spec.cp
    win = jax.lax.slice_in_dim(frames, start, start + spec.n_sc, axis=-1)
    y = jnp.fft.fft(win, norm="ortho").astype(jnp.complex64)   # [B, n_sc]
    selj = jnp.asarray(sel)
    ys = ((jnp.real(y) @ selj) + 1j * (jnp.imag(y) @ selj)).astype(
        jnp.complex64).reshape(y.shape[0], n_s, n_occ)
    d = ys * jnp.asarray(ref)[None, None, :]
    val = jnp.abs(jnp.sum(d[..., 1:] * jnp.conj(d[..., :-1]), axis=-1))  # [B, S]
    # gather-free shift lookup: weighted sum over the argmax one-hot
    best = jnp.argmax(val, axis=-1)                             # [B]
    oh = (jnp.arange(n_s)[None, :] == best[:, None]).astype(jnp.float32)
    return (oh @ jnp.asarray(shifts)).astype(jnp.float32)
