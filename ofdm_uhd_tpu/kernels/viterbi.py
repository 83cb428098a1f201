"""Fused Viterbi decoder: one Pallas kernel (Triton route) per decode.

The XLA decoders in phy.bits run the 64-state add-compare-select as a
`lax.scan`: every trellis step is a loop iteration with its own kernel
launches, and the windowed form moves a [B, W, 64] metric tensor through
device memory on every step. This kernel keeps the metrics in registers
for the whole trellis and pays one launch.

Layout. The parallel unit is one (frame, window) pair per lane, with the
window and overlap semantics of `phy.bits.viterbi_decode_windowed`; a
whole-sequence decode is a single window pinned to state 0 at both ends.
Each lane holds its 64 path metrics as 64 separate values, so the
predecessor map ((s << 1) | p) & 63 is a compile-time renaming, not a
shuffle. The branch metric of every state is one of +-(la + lb) and
+-(la - lb), so a step costs two adds for the branch metrics and, per
state, two adds, a compare and a select. Decisions are packed 32 states
to an int32 word and stored as [step, word, lane], so the stores of a
block coalesce; the traceback reads them back in the same kernel.

Numerics equal the XLA decoders bit for bit: the same f32 sums in the
same order, the same strict '>' tie-break toward predecessor 0, and the
same first-index argmax entry for windows that do not end the trellis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from ..phy import bits as PB
from ..phy import tables as T

_NEG = -1e30      # metric of a state that a window's start excludes
_BLOCK = 32       # lanes per program: one warp, one lane per thread


@functools.lru_cache(maxsize=1)
def _branch_signs() -> tuple[tuple[int, int], ...]:
    """(sign_a, sign_b) of the p=0 branch into each of the 64 states: the
    branch metric is sign_a * la + sign_b * lb (phy.bits.viterbi_decode)."""
    vt = T.viterbi_tables()
    sa = (1 - 2 * vt["br_a"][0]).astype(int)
    sb = (1 - 2 * vt["br_b"][0]).astype(int)
    return tuple(zip(sa.tolist(), sb.tolist()))


def _acs(pm: tuple, la: jax.Array, lb: jax.Array):
    """One trellis step over the 64 per-lane metrics -> (metrics, word0,
    word1), the words holding the decisions of states 0-31 and 32-63."""
    u = la + lb
    v = la - lb
    new, words = [], []
    for s, (sa, sb) in enumerate(_branch_signs()):
        pa, pb = pm[(s << 1) & 63], pm[((s << 1) | 1) & 63]
        # c0 = pa + bm, c1 = pb - bm with bm = sa*la + sb*lb; negating a
        # sum is exact, so these are the XLA decoder's f32 values
        bm = u if sa == sb else v
        c0, c1 = (pa - bm, pb + bm) if sa < 0 else (pa + bm, pb - bm)
        choice = c1 > c0                                # tie -> pred 0
        new.append(jnp.where(choice, c1, c0))
        bit = choice.astype(jnp.int32) << (s & 31)
        if s & 31:
            words[-1] = words[-1] | bit
        else:
            words.append(bit)
    return tuple(new), words[0], words[1]


def _kernel(e: int, interpret: bool, la_ref, lb_ref, first_ref, tail_ref,
            bits_ref, dec_ref):
    """One block of lanes: la/lb [e, blk] -> bits [e, blk].

    first/tail [blk] int32 flags: a first lane starts pinned to state 0
    (others uniform); a tail lane ends in state 0, others trace back from
    their best final state. dec [e, 2, blk] holds the packed decisions.
    """
    first = first_ref[...] != 0
    tail = tail_ref[...] != 0
    zero = jnp.zeros(first.shape, jnp.float32)
    barred = jnp.where(first, jnp.float32(_NEG), zero)
    pm0 = (zero,) + (barred,) * 63

    def fwd(t, pm):
        pm, w0, w1 = _acs(pm, la_ref[t, :], lb_ref[t, :])
        dec_ref[t, 0, :] = w0
        dec_ref[t, 1, :] = w1
        return pm

    pm = jax.lax.fori_loop(0, e, fwd, pm0)
    if not interpret:
        # the traceback reads decisions other threads may have stored
        pltr.debug_barrier()

    # entry state: first-index argmax of the final metrics, with states
    # other than 0 barred on tail lanes (jnp.argmax semantics)
    bar = jnp.where(tail, jnp.float32(_NEG), zero)
    best, state = pm[0], jnp.zeros(first.shape, jnp.int32)
    for s in range(1, 64):
        m = pm[s] + bar
        up = m > best
        best = jnp.where(up, m, best)
        state = jnp.where(up, jnp.int32(s), state)

    def bwd(i, state):
        t = e - 1 - i
        bits_ref[t, :] = ((state >> 5) & 1).astype(bits_ref.dtype)
        word = jnp.where(state >= 32, dec_ref[t, 1, :], dec_ref[t, 0, :])
        d = (word >> (state & 31)) & 1
        return ((state & 31) << 1) | d

    jax.lax.fori_loop(0, e, bwd, state)


def decode_lanes(la: jax.Array, lb: jax.Array, first: np.ndarray,
                 tail: np.ndarray, interpret: bool = False) -> jax.Array:
    """la/lb [e, R] time-major lane LLRs, first/tail [R] static flags ->
    bits [e, R] uint8. The lane count is padded to whole blocks."""
    e, r = la.shape
    pad = (-r) % _BLOCK
    if pad:
        la = jnp.pad(la, ((0, 0), (0, pad)))
        lb = jnp.pad(lb, ((0, 0), (0, pad)))
    rp = r + pad
    flags = [jnp.asarray(np.pad(np.asarray(f, np.int32), (0, pad)))
             for f in (first, tail)]
    col = pl.BlockSpec((e, _BLOCK), lambda i: (0, i))
    flag = pl.BlockSpec((_BLOCK,), lambda i: (i,))
    bits, _ = pl.pallas_call(
        functools.partial(_kernel, e, interpret),
        grid=(rp // _BLOCK,),
        in_specs=[col, col, flag, flag],
        out_specs=[col, pl.BlockSpec((e, 2, _BLOCK), lambda i: (0, 0, i))],
        out_shape=[jax.ShapeDtypeStruct((e, rp), jnp.uint8),
                   jax.ShapeDtypeStruct((e, 2, rp), jnp.int32)],
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=_BLOCK // 32,
                                            num_stages=1),
        interpret=interpret,
        name="viterbi_fused",
    )(la.astype(jnp.float32), lb.astype(jnp.float32), *flags)
    return bits[:, :r]


def viterbi_fused(llr: jax.Array, window: int = PB.WINDOW,
                  overlap: int = PB.OVERLAP, interpret: bool = False
                  ) -> jax.Array:
    """llr [B, 2n] (interleaved a/b) -> bits [B, n] uint8.

    Equal bit for bit to phy.bits.viterbi_decode_windowed(llr, window,
    overlap): a trellis no longer than window + 2 * overlap decodes as one
    window (the full-sequence decoder), a longer one as overlapping windows
    whose owned slices are stitched back together. interpret=True runs the
    kernel body through the Pallas interpreter (CPU tests); otherwise it
    compiles for a CUDA device or fails.
    """
    bsz, n2 = llr.shape
    n = n2 // 2
    l, ov = window, overlap
    la = llr[:, 0::2]
    lb = llr[:, 1::2]
    if n <= l + 2 * ov:
        ones = np.ones(bsz, np.int32)
        bits = decode_lanes(la.T, lb.T, ones, ones, interpret=interpret)
        return bits.T
    w = -(-n // l)
    e = l + 2 * ov
    starts = np.clip(np.arange(w) * l - ov, 0, n - e)        # [W] static

    def lanes(a):                                            # [B,n]->[E,B*W]
        return jnp.stack([a[:, s:s + e] for s in starts],
                         axis=1).reshape(bsz * w, e).T

    first = np.tile((starts == 0).astype(np.int32), bsz)
    tail = np.tile((starts + e == n).astype(np.int32), bsz)
    bits = decode_lanes(lanes(la), lanes(lb), first, tail,
                        interpret=interpret)
    bits_bwe = bits.T.reshape(bsz, w, e)
    off = np.arange(w) * l - starts                          # [W] static
    owned = jnp.concatenate(
        [bits_bwe[:, wi, off[wi]:off[wi] + l] for wi in range(w)], axis=1)
    return owned[:, :n]


def viterbi(llr: jax.Array, backend: str = "xla", mode: str = "scan"
            ) -> jax.Array:
    """Batched decode llr [B, 2n] -> bits [B, n], routed per spec.

    backend 'xla': `mode` picks the XLA decoder ('scan' or 'windowed').
    backend 'auto': the fused kernel where the computation runs on a CUDA
    device, the 'xla' choice elsewhere. `lax.platform_dependent` makes
    that choice when the computation is lowered for its device, so a
    computation placed on the host CPU never reaches the kernel, and on a
    GPU the kernel compiles or the run fails. The kernel reproduces the
    windowed decoder bit for bit, and so the scan on every decodable frame
    (phy.bits.viterbi_decode_windowed); it measured faster than both XLA
    forms at every batch the configs decode (PERF.md).
    """
    def xla(x):
        if mode == "windowed":
            return PB.viterbi_decode_windowed(x)
        return PB.viterbi_decode(x)

    if backend == "xla":
        return xla(llr)
    return jax.lax.platform_dependent(llr, cuda=viterbi_fused, default=xla)
