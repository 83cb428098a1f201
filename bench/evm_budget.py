"""Per-stage EVM budget (SURVEY.md §7.3 #6; VERDICT r4 missing #3).

Stage-TIMING attribution lives in bench/stages.py; this is the NUMERICS
twin: where do the EVM decibels go? The harness demodulates the same
noisy frames repeatedly, replacing one estimated quantity at a time with
its GENIE value (known channel, zero CPE, known CFO/timing), so each
row isolates one stage's contribution:

  genie-all      known H, no CPE correction needed (phase-coherent
                 channel): the channel+noise floor itself
  est-H          chain's LS estimate instead of genie H -> the channel-
                 estimation penalty (one preamble symbol: ~3 dB at
                 chanest_smooth=0)
  est-H+CPE      + the chain's pilot CPE/slope tracking (its estimation
                 noise: ~1/n_pilots of a symbol SNR unit)
  chain-aligned  the production aligned chain (est H + CPE) — should
                 match est-H+CPE
  chain-capture  the production capture chain (adds S&C timing + CFO
                 estimation residuals). NOTE it reads ~1 dB BETTER than
                 chain-aligned, not worse: make_capture defines SNR
                 against the mean power of the whole capture INCLUDING
                 inter-frame gaps, so the per-frame noise is lower by
                 the duty-cycle factor — a harness definition, not a
                 chain property.

Run: python bench/evm_budget.py [--config c2]
     [--snr 22] [--frames 256] [--multipath c2] [--jsonl out.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="c2")
    p.add_argument("--snr", type=float, default=22.0)
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--multipath", default=None, choices=[None, "c2"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jsonl", default=None)
    args = p.parse_args()

    import jax.numpy as jnp
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sweeps import MULTIPATH
    from ofdm_uhd_tpu.cli import config as C
    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.channel import apply_channel, make_capture
    from ofdm_uhd_tpu.pipeline import TxPipeline, RxPipeline
    from ofdm_uhd_tpu.phy import frame as PF
    from ofdm_uhd_tpu.phy import qam as PQ
    from ofdm_uhd_tpu.phy import tables as T

    spec = C.load_spec(args.config)
    taps = MULTIPATH.get(args.multipath)
    rng = np.random.default_rng(args.seed)
    payloads = rng.integers(
        0, 2, (args.frames, spec.payload_bits_per_frame)).astype(np.uint8)
    tx = TxPipeline(spec)
    frames = np.asarray(tx(payloads))
    ch = (ChannelSpec(snr_db=args.snr, multipath_taps=taps)
          if taps else ChannelSpec(snr_db=args.snr))
    rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc,
                                    seed=5000 + i)
                      for i in range(args.frames)])

    # genie channel on occupied bins (the exact DFT of the applied taps)
    t = np.zeros(spec.n_sc, np.complex128)
    tv = np.asarray(taps if taps else (1.0,), np.complex128)
    t[: len(tv)] = tv
    occ = np.asarray(T.frame_tables(spec)["occupied_bins"])
    h_genie = np.fft.fft(t)[occ].astype(np.complex64)

    shift = min(4, spec.cp // 4)
    # the intentional FFT-window advance (start s samples into the CP)
    # rotates every bin by exp(-j 2 pi k s / N) — the genie H must
    # include it, exactly as the estimated H absorbs it
    rot = np.exp(-1j * 2 * np.pi * occ * shift / spec.n_sc)
    h_rot = (h_genie * rot).astype(np.complex64)

    def evm_of(data):
        d = np.asarray(data)
        hard = np.asarray(PQ.qam_demap_hard(jnp.asarray(d),
                                            spec.modulation))
        ideal = np.asarray(PQ.qam_map(jnp.asarray(hard), spec.modulation))
        err = np.mean(np.abs(d - ideal) ** 2)
        ref = np.mean(np.abs(ideal) ** 2)
        return float(10 * np.log10(err / ref + 1e-30))

    grid = PF.ofdm_demodulate(spec, jnp.asarray(rx_in), shift=shift)
    h_est = PF.estimate_channel(spec, grid)
    hb = jnp.broadcast_to(jnp.asarray(h_rot)[None, :], h_est.shape)

    rows = {}
    # genie H, no CPE (static channel, no CFO in aligned mode -> any
    # residual CPE the tracker sees is its own estimation noise)
    eq_g = PF.equalize(spec, grid, hb)
    s = T.selection_tables(spec)
    data_g = np.asarray(PF._sel(eq_g, s["occ_to_data"]))
    rows["genie-all"] = evm_of(data_g)
    # estimated H, no CPE
    eq_e = PF.equalize(spec, grid, h_est)
    rows["est-H"] = evm_of(np.asarray(PF._sel(eq_e, s["occ_to_data"])))
    # estimated H + chain CPE tracking
    data_c, _ = PF.track_phase(spec, eq_e)
    rows["est-H+CPE"] = evm_of(data_c)
    # full aligned chain (cross-check: must equal est-H+CPE)
    rx = RxPipeline(spec, shift=shift)
    out_a = rx.rx_aligned(rx_in)
    rows["chain-aligned"] = float(np.mean(np.asarray(out_a["evm_db"])))
    # full capture chain: adds S&C timing + CFO estimation residuals
    cap = make_capture(frames, ChannelSpec(
        snr_db=args.snr, cfo=0.4 / spec.resample_l,
        **({"multipath_taps": taps} if taps else {})),
        spec.n_sc, gap=300, seed=77).astype(np.complex64)
    out_c = rx.rx_capture(cap, max_frames=args.frames + 2)
    v = np.asarray(out_c["valid"])
    rows["chain-capture"] = float(np.mean(np.asarray(out_c["evm_db"])[v]))

    print(f"# config={args.config} snr={args.snr} "
          f"multipath={args.multipath or 'flat'} frames={args.frames}")
    print(f"{'stage':<16}{'EVM dB':>9}{'delta':>9}")
    prev = rows["genie-all"]
    for k, v_ in rows.items():
        print(f"{k:<16}{v_:>9.2f}{v_ - prev:>+9.2f}"
              if k != "genie-all" else f"{k:<16}{v_:>9.2f}{'':>9}")
        prev = rows["genie-all"]
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            f.write(json.dumps({"config": args.config, "snr_db": args.snr,
                                "multipath": args.multipath,
                                "frames": args.frames,
                                "evm_db": rows}) + "\n")


if __name__ == "__main__":
    main()
