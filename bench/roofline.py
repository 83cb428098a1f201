"""Analytic roofline anchors for the RX chain (SURVEY.md §5.1, §6).

Computes per-stage FLOPs and device-memory bytes per processed sample from
the spec, against the device's published peaks, so measured Msamples/s
can be judged against speed-of-light. Usage:

    python bench/roofline.py --config c3 [--msps 123] [--device-kind KIND]

KIND defaults to jax.devices()[0].device_kind; a device missing from PEAKS
is an error.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ofdm_uhd_tpu.cli import config as C  # noqa: E402

# device_kind -> (f32 TFLOP/s outside the tensor cores, device memory GB/s).
# Published dense peaks of the SXM part at its 700 W limit (NVIDIA H100
# data sheet); the chain's matmuls run f32 at 'highest' precision, so the
# f32 rate is its compute roof. A card set below 700 W cannot hold them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67.0, 3350.0),
}


def peaks(device_kind: str) -> tuple[float, float]:
    """(f32 TFLOP/s, GB/s) of a device kind; raises on an unknown one."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device {device_kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def chain_costs(spec) -> list[tuple[str, float, float]]:
    """[(stage, flops_per_sample, bytes_per_sample)] at baseband rate."""
    n, cp = spec.n_sc, spec.cp
    sym = spec.sym_len
    occ = spec.n_occupied
    stages = []
    # S&C correlator: prod (8 flops cmul) + 2 boxcar updates (~4) per sample
    stages.append(("sync_correlate", 16.0, 8 * 3))  # read r twice + write P
    # CFO mixer: complex exp + cmul ~ 12 flops
    stages.append(("cfo_mix", 12.0, 16))
    # FFT: 5 N log2 N per symbol of sym samples
    fft_flops = 5 * n * math.log2(n) / sym
    stages.append(("fft", fft_flops, 16))
    # chanest+EQ+CPE per occupied bin, amortized over sym samples
    eq_flops = (occ * 20) / sym
    stages.append(("eq_phase", eq_flops, 8 * occ / sym))
    # LLR demap: 2 axes * 2^(b/2) levels * 4 flops per data bin
    nb = max(spec.bits_per_qam // 2, 1)
    demap = (spec.n_data_sc * 2 * (2 ** nb) * 4) / sym
    stages.append(("llr_demap", demap, 4 * spec.coded_bits_per_sym / sym))
    # Viterbi: 64 states * 2 preds * ~4 flops per input bit
    vit = (spec.uncoded_bits_per_frame * 64 * 2 * 4) / spec.frame_len
    stages.append(("viterbi", vit, 1))
    if spec.resample_l > 1:
        nt = 12 * spec.resample_l
        stages.append(("resample", 4.0 * nt / spec.resample_l, 16))
    return stages


# measured-profile cross-check: which chain_costs stages make up each
# bench/stages.py timing row (the capture-path rows; frontend/decode run on
# mf extracted frames = mf * frame_len samples)
_STAGE_GROUPS = {
    "corr": (["sync_correlate"], "capture"),
    "cfo": (["cfo_mix"], "frames"),
    "frontend": (["fft", "eq_phase", "llr_demap"], "frames"),
    "decode": (["viterbi"], "frames"),
}


def crosscheck(spec, rec, peak_tflops, peak_gbs) -> None:
    """Model-vs-measured per stage group: is the cost model (and therefore
    the chain speed-of-light number derived from it) anchored to reality?
    rec: last record of bench/stages.py --jsonl (VERDICT r2 item 5)."""
    stages = dict((nm, (f, b)) for nm, f, b in chain_costs(spec))
    batch = rec.get("batch", 1)
    n_cap = rec["n_samples"] * batch
    n_frames = rec["mf"] * rec["frame_len"] * batch
    print(f"\ncross-check vs measured profile ({rec.get('device')}, "
          f"batch={batch}):")
    print(f"{'stage':<10}{'model ms':>10}{'meas ms':>10}{'meas/model':>12}")
    for row, (parts, basis) in _STAGE_GROUPS.items():
        ms = rec["stages_ms"].get(row)
        if ms is None:
            continue
        nsamp = n_cap if basis == "capture" else n_frames
        f = sum(stages[p][0] for p in parts)
        b = sum(stages[p][1] for p in parts)
        t_model = max(f * nsamp / (peak_tflops * 1e12),
                      b * nsamp / (peak_gbs * 1e9)) * 1e3
        print(f"{row:<10}{t_model:>10.2f}{ms:>10.2f}{ms / t_model:>11.1f}x")
    print("(meas/model includes dispatch and launch latency; large ratios "
          "on tiny-model stages are latency, not model error)")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="c3")
    p.add_argument("--msps", type=float, default=None,
                   help="measured Msamples/s to compare against the roofline")
    p.add_argument("--stages-jsonl", default=None,
                   help="bench/stages.py --jsonl output; cross-checks the "
                        "cost model against the measured per-stage profile")
    p.add_argument("--device-kind", default=None,
                   help="device whose peaks to use (default: the first "
                        "JAX device)")
    args = p.parse_args()
    kind = args.device_kind
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    peak_tflops, peak_gbs = peaks(kind)
    spec = C.load_spec(args.config)
    stages = chain_costs(spec)
    tf = sum(f for _, f, _ in stages)
    tb = sum(b for _, _, b in stages)
    print(f"config {args.config}: N={spec.n_sc} cp={spec.cp} "
          f"{spec.modulation} x{spec.n_data_syms} syms")
    print(f"{'stage':<16}{'flops/samp':>12}{'bytes/samp':>12}")
    for name, f, b in stages:
        print(f"{name:<16}{f:>12.1f}{b:>12.1f}")
    print(f"{'TOTAL':<16}{tf:>12.1f}{tb:>12.1f}")
    msps_flops = peak_tflops * 1e12 / tf / 1e6
    msps_bw = peak_gbs * 1e9 / tb / 1e6
    print(f"peaks of {kind}: {peak_tflops} f32 TFLOP/s, {peak_gbs} GB/s")
    bound = "memory-bandwidth" if msps_bw < msps_flops else "compute"
    sol = min(msps_flops, msps_bw)
    print(f"\nspeed-of-light: {sol:,.0f} Msamples/s ({bound}-bound; "
          f"flops-limit {msps_flops:,.0f}, bw-limit {msps_bw:,.0f})")
    if args.msps:
        print(f"measured {args.msps:,.1f} Msamples/s = "
              f"{100 * args.msps / sol:.1f}% of speed-of-light")
    if args.stages_jsonl:
        import json
        with open(args.stages_jsonl) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        recs = [r for r in recs if r.get("config") == args.config] or recs
        crosscheck(spec, recs[-1], peak_tflops, peak_gbs)


if __name__ == "__main__":
    main()
