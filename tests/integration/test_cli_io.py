"""CLI + IO layer end-to-end (the reference-class loopback binaries' role)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ofdm_uhd_tpu.io import (read_capture, write_capture, CaptureReader,
                             SyntheticSource)
from ofdm_uhd_tpu.core.spec import ChannelSpec, config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cli(mod, *args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m", f"ofdm_uhd_tpu.cli.{mod}",
                       *args], capture_output=True, text=True, env=env,
                      timeout=600, cwd=ROOT)
    assert r.returncode == 0, (r.stdout, r.stderr)
    return r


@pytest.mark.parametrize("fmt,ext", [("sc16", ".iq"), ("fc32", ".iq"),
                                     ("auto", ".npy")])
def test_capture_roundtrip(tmp_path, fmt, ext):
    rng = np.random.default_rng(0)
    x = ((rng.standard_normal(1000) + 1j * rng.standard_normal(1000)) * 0.1
         ).astype(np.complex64)
    path = str(tmp_path / f"cap{ext}")
    write_capture(path, x, fmt=fmt, meta={"sample_rate": 1e6})
    y, meta = read_capture(path)
    atol = 1e-4 if fmt == "sc16" else 1e-7
    np.testing.assert_allclose(y, x, atol=atol)
    assert meta.get("sample_rate") == 1e6 or ext == ".npy"


def test_native_deframe_matches_numpy(tmp_path):
    pytest.importorskip("ofdm_uhd_tpu.io.native")
    from ofdm_uhd_tpu.io import native
    try:
        native._load()
    except ImportError:
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(1)
    # keep |x| < 1: sc16 clips at full scale by design
    x = ((rng.standard_normal(4096) + 1j * rng.standard_normal(4096)) * 0.15
         ).astype(np.complex64)
    x = np.clip(x.real, -0.99, 0.99) + 1j * np.clip(x.imag, -0.99, 0.99)
    x = x.astype(np.complex64)
    raw = native.frame_sc16(x)
    back = native.deframe_sc16(raw)
    np.testing.assert_allclose(back, x, atol=1e-4)
    # numpy fallback path agrees
    ints = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
    ref = ((ints[0::2] + 1j * ints[1::2]) / 32767.0).astype(np.complex64)
    np.testing.assert_allclose(back, ref, atol=1e-7)
    assert abs(native.block_power(x) - np.mean(np.abs(x) ** 2)) < 1e-6


def test_reader_blocks(tmp_path):
    x = np.arange(1000, dtype=np.complex64)
    path = str(tmp_path / "cap.npy")
    write_capture(path, x)
    r = CaptureReader(path, block=256)
    blocks = list(r)
    assert len(blocks) == 4
    got = np.concatenate(blocks)[:1000]
    np.testing.assert_allclose(got, x)


def test_synthetic_source():
    spec = config("c1")
    src = SyntheticSource(spec, ChannelSpec(snr_db=20.0), n_frames=3,
                          block=1024)
    blocks = []
    while not src.exhausted:
        blocks.append(src.read_block())
    assert len(blocks) >= 3
    assert all(b.shape == (1024,) for b in blocks)


def test_cli_tx_rx_roundtrip(tmp_path):
    cap = str(tmp_path / "tx.npy")
    bits = str(tmp_path / "bits.npy")
    run_cli("tx", "--config", "c1", "--frames", "5", "--out", cap,
            "--bits-out", bits, "--gap", "200")
    r = run_cli("rx", "--config", "c1", "--capture", cap,
                "--expect-bits", bits, "--max-frames", "8")
    assert "bit-exact" in r.stderr, r.stderr


def test_cli_loopback(tmp_path):
    r = run_cli("loopback", "--config", "c2", "--frames", "10",
                "--snr", "25", "--multipath", "1,0.3-0.2j")
    assert "BIT-EXACT" in r.stderr, r.stderr


def test_cli_pod_rx(tmp_path):
    cap = str(tmp_path / "tx.npy")
    bits = str(tmp_path / "bits.npy")
    run_cli("tx", "--config", "c5", "--frames", "4", "--out", cap,
            "--bits-out", bits, "--gap", "500")
    env_extra = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               **env_extra)
    r = subprocess.run([sys.executable, "-m", "ofdm_uhd_tpu.cli.pod_rx",
                        "--config", "c5", "--capture", cap,
                        "--bits-out", str(tmp_path / "rx_bits.npy")],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=ROOT)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "4 frames, 4 crc-ok" in r.stderr, r.stderr
    got = np.load(tmp_path / "rx_bits.npy")
    expect = np.load(bits)
    assert np.array_equal(got, expect)
