"""Plateau localization and frame extraction (phy.sync) against
independent NumPy references, including the clamp semantics at the
capture edges and the vmapped multi-capture form."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_uhd_tpu.core.spec import config
from ofdm_uhd_tpu.phy import sync as PS


def _np_localize(m, p, cand, span, cp, rel=0.9):
    """Loop form of phy.sync.localize over float64 copies of the inputs."""
    nd = len(m)
    m_pad = np.concatenate([m, np.zeros(span)]).astype(np.float64)
    ds, eps = [], []
    for c in cand:
        c0 = min(int(c), nd)                     # dynamic_slice clamp
        w = m_pad[c0:c0 + span]
        peak_off = int(np.argmax(w))
        above = np.nonzero(w >= np.float32(rel) * w.max())[0]
        lo, hi = int(above[0]), int(above[-1])
        ds.append(max(int(c) + (lo + hi) // 2 - cp // 2, 0))
        eps.append(np.angle(p[min(int(c) + peak_off, nd - 1)]) / np.pi)
    return np.asarray(ds), np.asarray(eps)


@pytest.mark.parametrize("seed", range(6))
def test_localize_matches_numpy(seed):
    spec = config("c3")
    rng = np.random.default_rng(seed)
    nd = 40000
    m = (rng.random(nd) ** 4).astype(np.float32)        # spiky metric
    p = (rng.normal(size=nd) + 1j * rng.normal(size=nd)).astype(np.complex64)
    cand = np.sort(rng.integers(0, nd - 2 * spec.sym_len, 20)).astype(
        np.int32)
    if seed == 0:
        cand[-1] = nd                      # the "no candidate" sentinel
    d_got, e_got = PS.localize(jnp.asarray(m), jnp.asarray(p),
                               jnp.asarray(cand), spec.sym_len, spec.cp)
    d_ref, e_ref = _np_localize(m, p, cand, spec.sym_len, spec.cp)
    np.testing.assert_array_equal(np.asarray(d_got), d_ref)
    np.testing.assert_allclose(np.asarray(e_got), e_ref, atol=1e-6)


def _np_extract(cap, ds, fl):
    padded = np.concatenate([cap, np.zeros(fl, cap.dtype)])
    n = len(cap)
    return np.stack([padded[min(int(d), n):min(int(d), n) + fl]
                     for d in ds])


class _Spec:                   # extract_frames reads only frame_len
    def __init__(self, fl):
        self.frame_len = fl


def _cap(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


@pytest.mark.parametrize("n,fl,mf", [
    (50000, 4032, 12),       # C3 geometry
    (20000, 800, 5),         # C1-ish
    (9000, 2048, 3),         # frame_len a power of two
    (50000, 4032, 6),        # C3 spec, fewer frames
])
def test_extract_matches_numpy(n, fl, mf):
    rng = np.random.default_rng(n + fl + mf)
    cap = _cap(rng, n)
    ds = np.sort(rng.integers(0, n - fl, size=mf)).astype(np.int32)
    got = np.asarray(PS.extract_frames(_Spec(fl), jnp.asarray(cap),
                                       jnp.asarray(ds)))
    np.testing.assert_array_equal(got, _np_extract(cap, ds, fl))


def test_extract_edge_offsets():
    """Clamp semantics: d=0, d near the end (frame runs past the capture
    -> zero tail), d=n and d>n (all zeros)."""
    n, fl = 12000, 1500
    cap = _cap(np.random.default_rng(23), n)
    ds = np.asarray([0, n - fl, n - 7, n, n + 400, 3], np.int32)
    got = np.asarray(PS.extract_frames(_Spec(fl), jnp.asarray(cap),
                                       jnp.asarray(ds)))
    np.testing.assert_array_equal(got, _np_extract(cap, ds, fl))
    assert np.all(got[3] == 0)            # d = n -> pure pad
    assert np.all(got[4] == 0)            # d > n -> clamped to the pad
    assert np.all(got[2][7:] == 0)        # past-capture tail is zeros


@pytest.mark.parametrize("cfg", ["c1", "c3"])
def test_extract_vmapped(cfg):
    """The capture chain vmaps extraction over captures — the batched
    form must equal per-capture calls and the NumPy reference."""
    spec = config(cfg)
    rng = np.random.default_rng(1)
    n, b, mf = 20000, 3, 4
    caps = np.stack([_cap(rng, n) for _ in range(b)])
    ds = np.stack([np.sort(rng.integers(0, n - spec.frame_len, size=mf))
                   for _ in range(b)]).astype(np.int32)
    got = np.asarray(jax.vmap(lambda c, d: PS.extract_frames(spec, c, d))(
        jnp.asarray(caps), jnp.asarray(ds)))
    for i in range(b):
        np.testing.assert_array_equal(
            got[i], _np_extract(caps[i], ds[i], spec.frame_len))
