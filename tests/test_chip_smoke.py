"""chip_smoke.py and what it rests on, checked on the CPU.

The script's phase functions run here at ``tiny_test_config`` size (the
script itself refuses to run without a GPU); the one test that runs the
script on the card carries the ``gpu`` marker.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from putslam_tpu import config
from putslam_tpu.config import tiny_test_config
from putslam_tpu.utils import device, timing

ROOT = pathlib.Path(__file__).resolve().parents[1]
NO_BOUND = {"slam": np.inf, "vo": np.inf, "lc": np.inf}
TINY_FRAMES = 9


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """``$JAX_COMPILATION_CACHE_DIR`` when set, and then nothing is set in
    code; otherwise the fixed in-checkout ``.cache/jax``."""
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(ROOT / ".cache" / "jax")
        assert device.compile_cache_dir() == want
        assert device.enable_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
        assert device.compile_cache_dir() == str(tmp_path / env_dir)
        assert device.enable_compile_cache() == str(tmp_path / env_dir)
        assert updates == []


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.phase_device()
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu_or_repo(tmp_path, alone):
    """No GPU (here), or no repo beside the script: non-zero exit, and no
    result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _tiny(monkeypatch):
    """run.main and tools/make_disk_dataset.py at tiny_test_config size."""
    monkeypatch.setattr(config, "tum_fr1_config",
                        lambda **kw: tiny_test_config().replace(**kw))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """Phases 2 and 3 at tiny size: (work dir, dataset, the three
    run.main reports)."""
    work = tmp_path_factory.mktemp("smoke")
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        dataset, rep = chip_smoke.phase_main_path(str(work), "cpu",
                                                  TINY_FRAMES, bound=np.inf)
        vo, lc = chip_smoke.phase_vo_and_lc(str(work), dataset, "cpu",
                                            TINY_FRAMES, bounds=NO_BOUND)
    return work, dataset, (rep, vo, lc)


def test_main_path_and_variants_tiny(tiny_run):
    work, _, reports = tiny_run
    for r in reports:
        assert r["platform"] == "cpu" and r["frames"] == TINY_FRAMES
        assert np.isfinite(r["ate_rmse_m"]) and r["ate_rmse_m"] < 0.5
    assert (work / "out_lc" / "graph_trajectory.res").exists()


def test_steady_fps_counts_real_frames(tiny_run, monkeypatch, tmp_path,
                                       capsys):
    """A chunk size that pads the tail (8 steps in chunks of 3: 3, 3, 2+1
    padded): each chunk records its real frames, and steady_fps divides the
    real frames of the chunks after the first by their time."""
    from putslam_tpu import run

    timers = []

    class Recorder(timing.StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    monkeypatch.setattr(timing, "StageTimer", Recorder)
    _tiny(monkeypatch)
    rc = run.main(["--dataset", tiny_run[1], "--out", str(tmp_path),
                   "--chunk", "3"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (timer,) = timers
    assert timer.items["slam_chunk"] == [3, 3, 2]
    secs = timer.samples["slam_chunk"]
    assert len(secs) == 3
    assert report["steady_fps"] == pytest.approx(5 / sum(secs[1:]))


def test_numerics_phase_tiny(tiny_run):
    _, dataset, _ = tiny_run
    from putslam_tpu.io import tum

    cfg, st = chip_smoke.engine_state(tiny_test_config(), dataset)
    frame = tum.TumDataset(dataset)[0]
    cpu = jax.devices()
    chip_smoke.phase_numerics(cfg, frame.gray, frame.depth, st, cpu[0],
                              cpu[1])


def test_four_card_phase_on_virtual_devices(monkeypatch, tmp_path):
    """At the production solver, as tum_fr1_config() has it (the tiny
    config's scatter solver would compare the oracle with itself)."""
    import dataclasses

    _tiny(monkeypatch)
    cfg = tiny_test_config()
    cfg = cfg.replace(backend=dataclasses.replace(cfg.backend,
                                                  solver="dense_schur_mm"))
    chip_smoke.phase_four_cards(cfg, jax.devices()[:4], str(tmp_path),
                                frames=TINY_FRAMES, vo_frames=6)


def test_ba_check_on_a_chain_with_four_views():
    """dense_schur_mm lands where the scatter oracle lands on a 128-keyframe
    chain whose landmarks are each seen by 4 keyframes (one bf16 pass of
    the Schur curvature stalled here 3 cm away, chi² 1 % high)."""
    import dataclasses

    cfg = tiny_test_config()
    K, L, M, E = 128, 4096, 4096, 256
    _, kf, _, lm, lm_valid, g = chip_smoke.make_graph(K, L, M, E, 2048,
                                                      np.array([4]))
    bcfg = dataclasses.replace(cfg.backend, gn_iterations=12, ba_window=0,
                               ba_lm_block=2048, robust_kernel="none")
    chip_smoke.compare_solvers(
        "chain", bcfg,
        (jnp.asarray(kf), jnp.ones((K,), bool), jnp.asarray(lm),
         jnp.asarray(lm_valid), g, jnp.zeros((K,), bool).at[0].set(True)),
        {}, jax.devices()[0])


def _dots(jaxpr):
    """Every dot_general equation of ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if hasattr(sub, "jaxpr"):
                    yield from _dots(getattr(sub.jaxpr, "jaxpr", sub.jaxpr))
                elif hasattr(sub, "eqns"):
                    yield from _dots(sub)


def test_gauss_newton_mm_pins_highest_on_onehot_dots():
    """Each f32×f32 one-hot product of gauss_newton_mm (the per-observation
    reads and the segment sums, with one axis of M observations and one of
    K keyframes, KC window slots or LC landmark slots) runs at HIGHEST."""
    import dataclasses

    from putslam_tpu.backend import optimize as opt

    cfg = tiny_test_config()
    K, L = cfg.map.max_keyframes, cfg.map.max_landmarks
    M, E = cfg.backend.max_observations, cfg.backend.max_pose_pose_edges
    _, kf, _, lm, lm_valid, g = chip_smoke.make_graph(K, L, M, E, 256,
                                                      np.array([2, 3, 4]))
    bcfg = dataclasses.replace(cfg.backend, ba_window=8, ba_lm_block=256)
    jaxpr = jax.make_jaxpr(
        lambda *a: opt.gauss_newton_mm(bcfg, *a))(
            jnp.asarray(kf), jnp.ones((K,), bool), jnp.asarray(lm),
            jnp.asarray(lm_valid), g, jnp.zeros((K,), bool).at[0].set(True),
            jnp.zeros((L,), jnp.int32), jnp.zeros((K,), jnp.int32))
    onehot = [e for e in _dots(jaxpr.jaxpr)
              if all(v.aval.dtype == jnp.float32 for v in e.invars)
              and any(v.aval.shape in ((M, K), (M, 8), (M, 256))
                      for v in e.invars)]
    # gates (2), pose read, landmark reads (3), segment sums (2),
    # camera-side sums (2), step read
    assert len(onehot) >= 11, len(onehot)
    for e in onehot:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), (e, prec)


def test_no_tpu_only_code_in_package():
    """No module imports Pallas's TPU dialect or branches on a platform
    string equal to "tpu"."""
    for path in (ROOT / "putslam_tpu").rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mods = [(node.module or "") + "." + a.name
                        for a in node.names]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                mods = []
            for mod in mods:
                parts = mod.split(".")
                assert ["pallas", "tpu"] not in [
                    parts[i:i + 2] for i in range(len(parts) - 1)], (path, mod)
            if isinstance(node, ast.Compare):
                consts = [c.value for c in [node.left, *node.comparators]
                          if isinstance(c, ast.Constant)]
                assert "tpu" not in consts, (path, node.lineno)


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole smoke run on the card, in a child process that is not
    held to the CPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
