"""JAX bit-layer: scramble, CRC-32, convolutional FEC, Viterbi, interleaver.

Array re-design of the reference-class C++ shift-register loops
(SURVEY.md §2.1 #2-#5, #21; mount empty, §0):

* scrambler  -> precomputed LFSR sequence, one vectorized XOR
* CRC-32     -> GF(2) affine map as a single f32 matmul (exact: sums < 2^24)
* conv enc   -> 7-bit window construction + parity LUT gather, fully parallel
* Viterbi    -> lax.scan over time with the 64-state ACS vectorized across
                (batch, state); traceback as a reverse scan over stored
                decisions — matches golden.bits.viterbi_decode bit-for-bit
                (same tie-break: strict '>' prefers predecessor 0)
* interleave -> precomputed permutation, jnp.take

All functions are batched over a leading axis B and jit-safe (static shapes
from the spec; tables are closed-over constants).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import CONV_K
from . import tables as T


# ---------------------------------------------------------------- scrambler

def scramble(bits: jax.Array, seed: int | None = None) -> jax.Array:
    """XOR with the whitening LFSR sequence; bits [..., n] uint8/int."""
    n = bits.shape[-1]
    seq = T.scramble_seq(n) if seed is None else T.scramble_seq(n, seed)
    return jnp.bitwise_xor(bits.astype(jnp.uint8), jnp.asarray(seq))


descramble = scramble


# ------------------------------------------------------------------- CRC-32

def crc32(bits: jax.Array) -> jax.Array:
    """CRC-32 over [..., n] bit arrays -> [..., 32] bits.

    GF(2) affine form: crc = (M @ bits + c) mod 2, computed as an f32 matmul
    (exact — row sums are far below 2^24). SURVEY.md §2.1 #21.
    """
    n = bits.shape[-1]
    m, c = T.crc_matrix(n)
    acc = bits.astype(jnp.float32) @ jnp.asarray(m.T, dtype=jnp.float32)
    acc = acc + jnp.asarray(c, dtype=jnp.float32)
    return (acc.astype(jnp.int32) & 1).astype(jnp.uint8)


def crc32_check(payload: jax.Array, crc_rx: jax.Array) -> jax.Array:
    """[..., n] payload + [..., 32] received crc -> [...] bool."""
    return jnp.all(crc32(payload) == crc_rx.astype(jnp.uint8), axis=-1)


# --------------------------------------------------- convolutional code K=7

def conv_encode(bits: jax.Array) -> jax.Array:
    """Rate-1/2 K=7 encoder on [..., n] -> [..., 2n], interleaved (a, b).

    Builds the 7-bit window per step via shifted adds, then gathers the two
    parity LUTs — no sequential loop (the recurrence is only apparent: the
    state is just the previous 6 input bits).
    """
    lut_a, lut_b = T.conv_output_luts()
    n = bits.shape[-1]
    b = bits.astype(jnp.int32)
    pad = jnp.zeros(bits.shape[:-1] + (CONV_K - 1,), dtype=jnp.int32)
    padded = jnp.concatenate([pad, b], axis=-1)          # [..., n+6]
    w = jnp.zeros_like(b)
    for k in range(CONV_K):
        w = w | (padded[..., CONV_K - 1 - k : CONV_K - 1 - k + n] << (6 - k))
    out_a = jnp.asarray(lut_a)[w]
    out_b = jnp.asarray(lut_b)[w]
    return jnp.stack([out_a, out_b], axis=-1).reshape(bits.shape[:-1] + (2 * n,))


def _pack_words() -> jax.Array:
    """[64] int32 bit values 1<<(s%32): weights that pack a [..., 64] 0/1
    decision vector into two int32 words by a masked select + 32-lane sum.
    State 31's/63's bit rides the int32 sign bit — adds of DISJOINT bits
    are exact in two's complement and `(w >> k) & 1` is undisturbed by the
    arithmetic shift (the fused kernel, kernels/viterbi.py, packs its
    decisions the same way)."""
    return jnp.asarray((np.uint32(1) << (np.arange(64, dtype=np.uint32)
                                         % 32)).view(np.int32))


def _pack_choice(choice: jax.Array) -> jax.Array:
    """[..., 64] bool decisions -> [..., 2] int32 words (states 0-31, 32-63).

    Runs INSIDE the ACS scan body so the stored decision tensor is 8x
    smaller than the [..., 64] bool form — at large batch the decision
    array is the decoder's dominant device-memory traffic (write in the
    forward scan + read in the traceback), so this is a bandwidth
    optimization, not cosmetics. A handful of selects/adds per step is
    free next to the ACS selects already there."""
    b = jnp.where(choice, _pack_words(), 0)
    return jnp.sum(b.reshape(choice.shape[:-1] + (2, 32)), axis=-1)


def _traceback_word(state: jax.Array, dec_t: jax.Array) -> jax.Array:
    """dec_t [..., 2] packed decision words, state [...] -> decision bit.

    Word/bit lookup replaces the 64-wide one-hot reduction of the naive
    traceback: the state's decision lives at word state//32, bit
    state%32 (sign-bit semantics: see _pack_words)."""
    w = jnp.where(state >= 32, dec_t[..., 1], dec_t[..., 0])
    return (w >> (state & 31)) & 1


def _pred_metric(pm: jax.Array, p: int) -> jax.Array:
    """pm[..., pred[p][s']] for all 64 successor states s'.

    The K=7 trellis has pred[p][s'] = ((s'<<1) | p) & 63, so the
    predecessor metric vector is just the even (p=0) or odd (p=1) strided
    half of pm tiled twice — a strided slice, no matmul and no gather. A
    one-hot matmul would be exact only at f32 'highest' precision: a
    reduced-precision pass rounds the growing path metrics and corrupts
    the decode.
    """
    h = pm[..., p::2]
    return jnp.concatenate([h, h], axis=-1)


def viterbi_decode(llr: jax.Array, unroll: int = 8) -> jax.Array:
    """Soft-input Viterbi for the rate-1/2 K=7 code; batched.

    llr [B, 2n] (interleaved a/b, log P(0)/P(1)) -> bits [B, n].
    lax.scan over the n trellis steps; ACS vectorized over [B, 64] states
    (SURVEY.md §2.1 #4: the reference's hot C++ ACS loop becomes a scan of
    vector selects). Trellis starts and ends in state 0 (tail-terminated).
    """
    vt = T.viterbi_tables()
    br_a = jnp.asarray(vt["br_a"])          # [2, 64] f32
    br_b = jnp.asarray(vt["br_b"])          # [2, 64] f32
    # +1 for out 0, -1 for out 1; only the p=0 row is needed: both
    # generator polynomials include the oldest register bit (0o133/0o171
    # are degree-6 with both end taps set), so flipping the predecessor
    # bit flips BOTH outputs — bm[1, s] == -bm[0, s] for every s (asserted
    # in tests/unit). c1 = pred1 - bm0 is bit-identical to pred1 + bm[1]
    # (f32 negation is exact and rounding is sign-symmetric) and halves
    # the branch-metric arithmetic per trellis step.
    sign_a0 = (1.0 - 2.0 * br_a)[0]         # [64]
    sign_b0 = (1.0 - 2.0 * br_b)[0]

    squeeze = llr.ndim == 1
    if squeeze:
        llr = llr[None]
    bsz, n2 = llr.shape
    n = n2 // 2
    la = llr[:, 0::2].T.astype(jnp.float32)  # [n, B]
    lb = llr[:, 1::2].T.astype(jnp.float32)

    neg = jnp.float32(-1e30)
    onehot0 = jnp.concatenate(
        [jnp.ones((bsz, 1), jnp.float32), jnp.zeros((bsz, 63), jnp.float32)],
        axis=1)
    pm0 = neg * (1.0 - onehot0)

    def acs(pm, inputs):
        la_t, lb_t = inputs                                  # [B], [B]
        # branch metric WITHOUT the conventional 0.5: scaling every metric
        # by an exact power of two shifts exponents only (fl(2a + 2b) ==
        # 2 fl(a + b)), so every compare/tie is bit-identical to the
        # halved form while saving one vector multiply per trellis step
        bm0 = (sign_a0[None] * la_t[:, None]
               + sign_b0[None] * lb_t[:, None])              # [B, 64]
        c0 = _pred_metric(pm, 0) + bm0                       # [B, 64]
        c1 = _pred_metric(pm, 1) - bm0
        choice = c1 > c0                                     # tie -> pred 0
        pm_new = jnp.where(choice, c1, c0)
        # pack IN the body: the scan stores [n, B, 2] int32 instead of
        # [n, B, 64] bool — 8x less decision memory traffic (see _pack_choice)
        return pm_new, _pack_choice(choice)

    # unroll: the ACS body is a handful of tiny ops, so per-iteration loop
    # overhead dominates; unrolling 8 bodies per iteration lets XLA fuse
    # and schedule them together (exact, just scheduling)
    _, packed = jax.lax.scan(acs, pm0, (la, lb),
                             unroll=unroll)                  # [n, B, 2] i32

    def traceback(state, dec_t):                             # dec_t [B, 2]
        bit = (state >> 5) & 1                               # [B]
        d = _traceback_word(state, dec_t)
        return ((state & 31) << 1) | d, bit

    state0 = jnp.zeros(bsz, dtype=jnp.int32)
    _, bits_rev = jax.lax.scan(traceback, state0, packed, reverse=True,
                               unroll=unroll)
    bits = bits_rev.T.astype(jnp.uint8)                      # [B, n]
    return bits[0] if squeeze else bits


WINDOW = 512      # default geometry of the windowed decoders (XLA and the
OVERLAP = 96      # fused kernel, kernels/viterbi.py)


def viterbi_decode_windowed(llr: jax.Array, window: int = WINDOW,
                            overlap: int = OVERLAP) -> jax.Array:
    """Windowed-parallel Viterbi: same decoder, ~10x less sequential depth.

    The plain decoder's wall-clock is the scan LENGTH (thousands of tiny
    latency-bound steps), not FLOPs. Standard sliding-window trick:
    split the n trellis steps into W output windows of length `window`,
    extend each by `overlap` true steps on both sides (clipped at the
    sequence ends, where the exact boundary conditions apply instead), run
    all windows' ACS in parallel (one scan of length E = window+2*overlap
    over a [B, W, 64] metric tensor), and traceback each window from the
    argmax state of its extension.

    With overlap >= ~5 constraint lengths (here 96 >> 35) the survivor
    paths merge before the output region, so the emitted bits equal the
    full-sequence decode with overwhelming probability at any SNR where
    decoding succeeds; disagreement is possible in adversarial noise where
    the frame is garbage anyway (CRC gates it). Validated bit-exact vs
    `viterbi_decode` in tests/unit and by the bench correctness gate.
    """
    vt = T.viterbi_tables()
    # p=0 row only — bm[1] == -bm[0] (see viterbi_decode)
    sign_a0 = (1.0 - 2.0 * jnp.asarray(vt["br_a"]))[0]
    sign_b0 = (1.0 - 2.0 * jnp.asarray(vt["br_b"]))[0]

    squeeze = llr.ndim == 1
    if squeeze:
        llr = llr[None]
    bsz, n2 = llr.shape
    n = n2 // 2
    l, ov = window, overlap
    if n <= l + 2 * ov:
        out = viterbi_decode(llr)
        return out[0] if squeeze else out
    w = -(-n // l)
    e = l + 2 * ov
    starts = np.clip(np.arange(w) * l - ov, 0, n - e)        # [W] static

    la = llr[:, 0::2].astype(jnp.float32)                    # [B, n]
    lb = llr[:, 1::2].astype(jnp.float32)
    # starts are static and windows contiguous -> W static slices
    def windows(a):                                          # [B,n]->[E,B,W]
        return jnp.stack([a[:, s:s + e] for s in starts],
                         axis=2).transpose(1, 0, 2)
    law = windows(la)
    lbw = windows(lb)

    neg = jnp.float32(-1e30)
    force0 = jnp.concatenate([jnp.zeros(1, jnp.float32),
                              jnp.full((63,), neg)])         # [64]
    # window starting at true step 0 inherits the exact state-0 init;
    # interior windows start uniform (unknown state, resolved by overlap)
    init = jnp.where(jnp.asarray(starts == 0)[None, :, None],
                     force0[None, None, :],
                     jnp.zeros((1, 1, 64), jnp.float32))
    pm0 = jnp.broadcast_to(init, (bsz, w, 64))

    def acs(pm, inputs):
        la_t, lb_t = inputs                                  # [B, W]
        # no 0.5 scale — exact power-of-two metric scaling, see
        # viterbi_decode.acs
        bm0 = (sign_a0 * la_t[..., None]
               + sign_b0 * lb_t[..., None])                  # [B, W, 64]
        c0 = _pred_metric(pm, 0) + bm0                       # [B, W, 64]
        c1 = _pred_metric(pm, 1) - bm0
        choice = c1 > c0
        return jnp.where(choice, c1, c0), _pack_choice(choice)

    pm_f, packed = jax.lax.scan(acs, pm0, (law, lbw), unroll=4)

    # window ending at true step n inherits the exact tail termination
    # (state 0); interior windows take the best surviving state
    pm_f = pm_f + jnp.where(jnp.asarray(starts + e == n)[None, :, None],
                            force0[None, None, :], 0.0)
    state_f = jnp.argmax(pm_f, axis=-1).astype(jnp.int32)    # [B, W]

    def traceback(state, dec_t):                             # state [B, W]
        bit = (state >> 5) & 1
        d = _traceback_word(state, dec_t)
        return ((state & 31) << 1) | d, bit

    _, bits_rev = jax.lax.scan(traceback, state_f, packed, reverse=True,
                               unroll=4)                     # [E, B, W]
    bits_ebw = bits_rev.astype(jnp.uint8)

    # each window owns slice [off, off+L) of its extension — static slices
    off = np.arange(w) * l - starts                          # [W] static
    bits_bwe = bits_ebw.transpose(1, 2, 0)                   # [B, W, E]
    owned = jnp.concatenate(
        [bits_bwe[:, wi, off[wi]:off[wi] + l] for wi in range(w)], axis=1)
    bits = owned[:, :n]                                      # [B, n]
    return bits[0] if squeeze else bits


# ---------------------------------------------------------------- interleaver

def interleave(coded: jax.Array, n_cbps: int) -> jax.Array:
    """Per-symbol block interleave on [..., n_syms*n_cbps].

    The row-column permutation perm[k] = (n_cbps/16)*(k%16) + k//16 IS a
    16 x (n_cbps/16) transpose — a reshape+swapaxes, not a gather.
    Bit-identical to golden.bits.interleave (roundtrip + golden-match
    tested).
    """
    n16 = n_cbps // 16
    blocks = coded.reshape(coded.shape[:-1] + (-1, n16, 16))
    return jnp.swapaxes(blocks, -1, -2).reshape(coded.shape)


def deinterleave(bits: jax.Array, n_cbps: int) -> jax.Array:
    """Inverse of interleave: the opposite transpose."""
    n16 = n_cbps // 16
    blocks = bits.reshape(bits.shape[:-1] + (-1, 16, n16))
    return jnp.swapaxes(blocks, -1, -2).reshape(bits.shape)


deinterleave_soft = deinterleave  # same gather, applied to LLRs


# ---------------------------------------------------------------- puncturing

def puncture(coded: jax.Array, rate: str) -> jax.Array:
    """Drop punctured positions on [..., full] (static take)."""
    if rate == "1/2":
        return coded
    t = T.puncture_tables(rate, coded.shape[-1])
    return jnp.take(coded, jnp.asarray(t["kept"]), axis=-1)


def depuncture_llr(llr: jax.Array, rate: str, full_len: int) -> jax.Array:
    """Re-insert zero LLRs at punctured positions — one-hot matmul (the
    scatter-free form; see phy/frame.py)."""
    if rate == "1/2":
        return llr
    t = T.puncture_tables(rate, full_len)
    return llr.astype(jnp.float32) @ jnp.asarray(t["depuncture"])
