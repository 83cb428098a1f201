"""2-process jax.distributed CPU test (SURVEY.md §4 'Distributed without a
pod', path (b)): exercises the multi-host init + global-mesh collectives
path. Skips cleanly if the CPU collectives backend is unavailable."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_stream():
    port = _free_port()
    workers = []
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    script = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    for pid in range(2):
        workers.append(subprocess.Popen(
            [sys.executable, script, str(port), str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root))
    outs = []
    for w in workers:
        try:
            out, err = w.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for w2 in workers:
                w2.kill()
            pytest.fail("multihost worker timed out")
        outs.append((w.returncode, out, err))
    for rc, out, err in outs:
        if rc != 0 and ("gloo" in err.lower() or "collectives" in err.lower()
                        or "UNIMPLEMENTED" in err):
            pytest.skip(f"CPU collectives unavailable: {err[-300:]}")
        assert rc == 0, (out, err[-2000:])
        assert "RESULT ok=True n=5" in out, (out, err[-1000:])
    # both processes saw identical decoded payloads
    d0 = outs[0][1].split("digest=")[1].split()[0]
    d1 = outs[1][1].split("digest=")[1].split()[0]
    assert d0 == d1
