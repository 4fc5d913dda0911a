"""Per-stage timing + run statistics with reference-compatible dump names.

Mirrors the reference's observability surface (SURVEY §5):
``Stopwatch<>``/``TimeMeasurement`` per-stage averages → ``times.txt``
(src/Utilities/stopwatch.h, include/putslam/PUTSLAM/TimeMeasurement.h:8-70,
dumped PUTSLAM.cpp:984-985), end-to-end fps → ``fps.res``
(PUTSLAM.cpp:1056-1061), and TUM-format trajectories
``VO_trajectory.res`` / ``graph_trajectory.res`` (PUTSLAM.cpp:17-18).

The stage taxonomy keeps the reference's names so timing comparisons are
apples-to-apples; whole-frame stages are measured around blocking device
calls (per-op device times come from ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List


class StageTimer:
    """Accumulates wall-clock samples per named stage, and optionally how
    many items (frames, say) each sample handled: ``items[name][i]`` belongs
    to ``samples[name][i]`` when every sample of the stage gave a count."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.items: Dict[str, List[int]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)
            if items is not None:
                self.items[name].append(items)

    def add(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "mean_ms": 1e3 * sum(xs) / max(len(xs), 1),
                "total_s": sum(xs),
                "count": len(xs),
            }
        return out

    def write_times_txt(self, path: str) -> None:
        """times.txt: per-stage mean/total, reference-style."""
        with open(path, "w") as f:
            for name, s in sorted(self.summary().items()):
                f.write(f"{name}: mean {s['mean_ms']:.3f} ms over "
                        f"{int(s['count'])} calls (total {s['total_s']:.3f} s)\n")


def write_fps(path: str, n_frames: int, total_seconds: float) -> None:
    """fps.res — single number, reference format (PUTSLAM.cpp:1056-1061)."""
    fps = n_frames / max(total_seconds, 1e-9)
    with open(path, "w") as f:
        f.write(f"{fps:.3f}\n")


def write_run_statistics(path: str, outs) -> None:
    """statistics summary (the reference emits a matplotlib script,
    PUTSLAM.cpp:1063-1216; we emit parseable text with the same content:
    inlier counts, map matches, keyframe/BA cadence, landmark growth)."""
    import numpy as np

    with open(path, "w") as f:
        def arr(name):
            return np.asarray(getattr(outs, name))

        f.write(f"frames {len(arr('pose'))}\n")
        f.write(f"vo_ok_fraction {float(arr('vo_ok').mean()):.4f}\n")
        f.write(f"map_ok_fraction {float(arr('map_ok').mean()):.4f}\n")
        f.write(f"keyframes {int(arr('is_keyframe').sum())}\n")
        f.write(f"ba_runs {int(arr('ba_ran').sum())}\n")
        f.write(f"map_inliers_median {float(np.median(arr('n_map_inliers'))):.1f}\n")
        f.write(f"map_matches_median {float(np.median(arr('n_map_matches'))):.1f}\n")
        f.write(f"landmarks_final {int(arr('n_landmarks')[-1])}\n")
