"""BER/EVM vs SNR sweep — the reference-class repo's sweep scripts, done
as a reproducible harness (SURVEY.md §4 'BER-vs-SNR sweep scripts').

    python bench/sweeps.py --config c2 \
        --snrs 4,6,8,10,12 --frames 50 [--multipath c2] [--eq mmse] \
        [--jsonl out.jsonl]

Reports pre-FEC BER, post-FEC frame error rate, and EVM per SNR point,
against TWO references:
  * `theory`  — analytic Gray-QAM BER for flat AWGN with PERFECT channel
    knowledge (the idealized floor);
  * `chain`   — the same formula fed the CHAIN's effective per-bin SNR:
    ZF one-tap equalization enhances noise by 1/|H_k|^2 on faded bins,
    the LS channel estimate from ONE preamble symbol (chanest_smooth=0)
    adds a full unit of noise (its estimation error has the same
    variance as the data noise), smoothing divides that unit by the
    averaging width, and pilot CPE tracking adds 1/n_pilots:

        SNR_k = esn0 * |H_k|^2 / (1 + 1/W_eff + 1/n_pilots)

    expected BER = mean_k BER(SNR_k). First-order (it ignores the
    QAM-16 amplitude distortion of a noisy ZF division), and measured to
    bracket the chain within ~2x across the r5 sweep — this is the
    quantitative form of the r4 verdict's "ZF noise enhancement"
    hypothesis (VERDICT r4 missing #3 / next #5).
"""

from __future__ import annotations

import argparse
import json
import os
import math
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ofdm_uhd_tpu.cli import config as C  # noqa: E402

# the C2 acceptance configuration's static multipath channel (the same
# taps the integration/backend-equality tests pin)
MULTIPATH = {"c2": (1.0, 0.35 - 0.15j)}


def q(x):
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def _qam_ber(bits_per_qam: int, esn0: float) -> float:
    """Per-bit error prob for Gray square QAM at symbol SNR esn0."""
    if bits_per_qam == 1:
        return q(math.sqrt(2 * esn0))
    m = 2 ** bits_per_qam
    return (4 / bits_per_qam) * (1 - 1 / math.sqrt(m)) * q(
        math.sqrt(3 * esn0 / (m - 1)))


def uncoded_ber_theory(spec, snr_db: float) -> float:
    """Flat-AWGN perfect-CSI floor on occupied-bin SNR."""
    esn0 = 10 ** (snr_db / 10.0) * spec.n_sc / spec.n_occupied
    return _qam_ber(spec.bits_per_qam, esn0)


def chain_expected_ber(spec, snr_db: float, taps) -> float:
    """Chain-aware expected BER: per-bin ZF post-EQ SNR with the
    estimation/CPE penalty (module docstring)."""
    esn0 = 10 ** (snr_db / 10.0) * spec.n_sc / spec.n_occupied
    if taps is None:
        h2 = np.ones(spec.n_occupied)
    else:
        t = np.zeros(spec.n_sc, np.complex128)
        tv = np.asarray(taps, np.complex128)
        t[: len(tv)] = tv
        hf = np.fft.fft(t)
        from ofdm_uhd_tpu.phy.tables import frame_tables
        occ = np.asarray(frame_tables(spec)["occupied_bins"])
        h2 = np.abs(hf[occ]) ** 2
        h2 = h2 / np.mean(h2)          # AWGN SNR is defined post-channel
    w_eff = max(spec.chanest_smooth, 1)
    pen = 1.0 + 1.0 / w_eff + 1.0 / max(spec.n_pilots, 1)
    return float(np.mean([_qam_ber(spec.bits_per_qam, esn0 * h / pen)
                          for h in h2]))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="c2")
    p.add_argument("--snrs", default="6,10,14,18,22")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--hi-frames", type=int, default=None,
                   help="frame count for the two HIGHEST SNR points "
                        "(tail statistics: >=512 recommended)")
    p.add_argument("--multipath", default=None, choices=[None, "c2"],
                   help="apply the named static multipath channel")
    p.add_argument("--eq", default=None, choices=[None, "zf", "mmse"],
                   help="override spec.eq_mode")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jsonl", default=None)
    args = p.parse_args()

    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.channel import apply_channel
    from ofdm_uhd_tpu.pipeline import TxPipeline, RxPipeline
    from ofdm_uhd_tpu.phy import qam as PQ

    spec = C.load_spec(args.config)
    if args.eq:
        spec = spec.with_(eq_mode=args.eq)
    taps = MULTIPATH.get(args.multipath)
    rng = np.random.default_rng(args.seed)
    snrs = [float(s) for s in args.snrs.split(",")]
    hi = sorted(snrs)[-2:] if args.hi_frames else []

    tx = TxPipeline(spec)
    rx = RxPipeline(spec, shift=min(4, spec.cp // 4))

    print(f"# config={args.config} eq={spec.eq_mode} "
          f"multipath={args.multipath or 'flat'}")
    print(f"{'SNR dB':>7}{'frames':>8}{'preBER':>12}{'theory':>12}"
          f"{'chain':>12}{'postFER':>10}{'EVM dB':>9}")
    for snr in snrs:
        n_frames = args.hi_frames if snr in hi else args.frames
        # chunked so --hi-frames 512+ stays within host memory
        errs = bits_tot = 0
        fails = frames_tot = 0
        evms = []
        done = 0
        while done < n_frames:
            nb = min(n_frames - done, 128)
            payloads = rng.integers(
                0, 2, (nb, spec.payload_bits_per_frame)).astype(np.uint8)
            frames = np.asarray(tx(payloads))
            coded_ref = np.asarray(tx.encode(payloads))
            ch = (ChannelSpec(snr_db=snr, multipath_taps=taps)
                  if taps else ChannelSpec(snr_db=snr))
            rx_in = np.stack([
                apply_channel(frames[i], ch, spec.n_sc,
                              seed=1000 + done + i) for i in range(nb)])
            out = rx.rx_aligned(rx_in)
            hard = np.asarray(PQ.qam_demap_hard(out["data_syms"],
                                                spec.modulation))
            hard = hard.reshape(nb, -1)
            errs += int(np.sum(hard != coded_ref))
            bits_tot += coded_ref.size
            ok = np.asarray(out["crc_ok"])
            exact = np.array([np.array_equal(a, b) for a, b in
                              zip(np.asarray(out["payload"]), payloads)])
            fails += int(np.sum(~(ok & exact)))
            frames_tot += nb
            evms.append(np.asarray(out["evm_db"]))
            done += nb
        pre_ber = errs / bits_tot
        fer = fails / frames_tot
        evm = float(np.mean(np.concatenate(evms)))
        theo = uncoded_ber_theory(spec, snr)
        chain = chain_expected_ber(spec, snr, taps)
        print(f"{snr:>7.1f}{frames_tot:>8d}{pre_ber:>12.2e}{theo:>12.2e}"
              f"{chain:>12.2e}{fer:>10.3f}{evm:>9.1f}")
        if args.jsonl:
            with open(args.jsonl, "a") as f:
                f.write(json.dumps({
                    "config": args.config, "eq": spec.eq_mode,
                    "multipath": args.multipath, "snr_db": snr,
                    "frames": frames_tot, "pre_fec_ber": pre_ber,
                    "theory_ber": theo, "chain_expected_ber": chain,
                    "post_fec_fer": fer, "evm_db": evm}) + "\n")


if __name__ == "__main__":
    main()
