"""Config loading: named acceptance configs, JSON files, --set overrides
(SURVEY.md §5.6). Specs are static/shape-defining; every override re-jits
by design."""

from __future__ import annotations

import argparse
import json
import os

from ..core.spec import WaveformSpec, ChannelSpec, config as named_config

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "configs")


def load_spec(name_or_path: str, overrides: list[str] | None = None
              ) -> WaveformSpec:
    """'c1'..'c5', or a JSON file path; overrides like mod=qam64, n_sc=256."""
    if os.path.exists(name_or_path):
        with open(name_or_path) as f:
            spec = WaveformSpec(**json.load(f))
    else:
        path = os.path.join(_CONFIG_DIR, name_or_path + ".json")
        if os.path.exists(path):
            with open(path) as f:
                spec = WaveformSpec(**json.load(f))
        else:
            spec = named_config(name_or_path)
    for ov in overrides or []:
        key, val = ov.split("=", 1)
        key = {"mod": "modulation"}.get(key, key)
        field_type = type(getattr(spec, key))
        spec = spec.with_(**{key: field_type(val) if field_type is not str
                             else val})
    return spec


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="c1",
                   help="named config (c1..c5) or JSON spec path")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VAL", help="spec override, e.g. mod=qam64")
    p.add_argument("--backend", choices=["xla", "auto"],
                   default=None, help="kernel backend override ('auto': "
                   "fused Viterbi kernel on a GPU)")
    p.add_argument("--seed", type=int, default=0)


def spec_from_args(args) -> WaveformSpec:
    spec = load_spec(args.config, args.overrides)
    if args.backend:
        spec = spec.with_(kernel_backend=args.backend)
    return spec


def channel_from_args(args) -> ChannelSpec:
    return ChannelSpec(
        snr_db=getattr(args, "snr", 30.0),
        cfo=getattr(args, "cfo", 0.0),
        phase_noise_std=getattr(args, "phase_noise", 0.0),
        timing_offset=getattr(args, "timing_offset", 0),
    )
