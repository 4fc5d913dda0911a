"""Multi-host scaffolding: 2-process CPU dryrun of distributed BA.

Two OS processes (jax.distributed + Gloo) × 4 virtual CPU devices form an
8-device global mesh; ``dist_ba.dist_gauss_newton`` must reproduce the
single-process result across the process boundary.
(SURVEY §5 "Distributed communication backend"; BASELINE 2-host target.)
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "tools",
                      "multihost_dryrun.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(args, timeout=500):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # script forces cpu itself
    return subprocess.run([sys.executable, SCRIPT] + args,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def _parse(out):
    line = [l for l in out.strip().splitlines() if l.startswith("{")][-1]
    return json.loads(line)


def test_two_process_dist_ba_matches_single_process():
    r_single = _run(["--single", "--devices-per-process", "8"])
    assert r_single.returncode == 0, r_single.stderr[-2000:]
    ref = _parse(r_single.stdout)
    assert ref["global_devices"] == 8

    port = _free_port()
    common = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
              "--devices-per-process", "4"]
    p0 = subprocess.Popen(
        [sys.executable, SCRIPT] + common + ["--process-id", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    p1 = subprocess.Popen(
        [sys.executable, SCRIPT] + common + ["--process-id", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out0, err0 = p0.communicate(timeout=500)
    out1, err1 = p1.communicate(timeout=500)
    assert p0.returncode == 0, err0[-2000:]
    assert p1.returncode == 0, err1[-2000:]
    d0 = _parse(out0)
    d1 = _parse(out1)
    assert d0["process_count"] == 2 and d1["process_count"] == 2
    assert d0["global_devices"] == 8
    # the distributed solve must agree with the single-process solve and be
    # identical across the two controllers
    assert d0["chi2_final"] == pytest.approx(d1["chi2_final"], rel=1e-6)
    assert d0["chi2_final"] == pytest.approx(ref["chi2_final"], rel=1e-4)
