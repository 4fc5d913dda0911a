"""Decaying-velocity EKF motion model.

Batched replacement for the reference's 13-state EKF
(reference: src/MotionModel/decayingVelocityModel.cpp:3-215 —
state = [position(3), velocity(3), quaternion(4), angular velocity(3)],
``predict`` :28-40 with velocity decay, ``correct`` :43-121 with a 7-dim
pose measurement; wired but mostly disabled in the orchestrator,
PUTSLAM.cpp:329-332).

The transition Jacobian comes from forward-mode autodiff of the exact
transition (the reference hand-linearizes); all matrices are tiny, so one
predict+correct is a handful of fused ops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from putslam_tpu.config import MotionModelConfig
from putslam_tpu.geometry import se3

STATE_DIM = 13  # pos(3) + vel(3) + quat wxyz(4) + angvel(3)


class EKFState(NamedTuple):
    x: jnp.ndarray   # (13,)
    P: jnp.ndarray   # (13, 13)


def init(cfg: MotionModelConfig, pose=None, dtype=jnp.float32) -> EKFState:
    x = jnp.zeros((STATE_DIM,), dtype).at[6].set(1.0)
    if pose is not None:
        x = x.at[0:3].set(se3.translation(pose))
        x = x.at[6:10].set(se3.rotation_quat(pose))
    P = jnp.eye(STATE_DIM, dtype=dtype) * 1e-2
    return EKFState(x, P)


def _transition(cfg: MotionModelConfig, x, dt):
    pos, vel, quat, w = x[0:3], x[3:6], x[6:10], x[10:13]
    pos2 = pos + vel * dt
    vel2 = cfg.decay * vel
    quat2 = se3.quat_normalize(se3.quat_mul(quat, se3.so3_exp_quat(w * dt)))
    w2 = cfg.decay * w
    return jnp.concatenate([pos2, vel2, quat2, w2])


def _process_noise(cfg: MotionModelConfig, dtype):
    q = jnp.concatenate([
        jnp.full((3,), cfg.q_pos), jnp.full((3,), cfg.q_vel),
        jnp.full((4,), cfg.q_quat), jnp.full((3,), cfg.q_angvel),
    ]).astype(dtype)
    return jnp.diag(q)


@functools.partial(jax.jit, static_argnums=(0,))
def predict(cfg: MotionModelConfig, s: EKFState, dt: float) -> EKFState:
    """EKF time update (decayingVelocityModel.cpp:28-40)."""
    f = lambda x: _transition(cfg, x, dt)
    x2 = f(s.x)
    F = jax.jacfwd(f)(s.x)
    P2 = F @ s.P @ F.T + _process_noise(cfg, s.x.dtype)
    return EKFState(x2, P2)


@functools.partial(jax.jit, static_argnums=(0,))
def correct(cfg: MotionModelConfig, s: EKFState, pose_meas: jnp.ndarray
            ) -> EKFState:
    """EKF measurement update with a 7-dim pose [t, q] measurement
    (decayingVelocityModel.cpp:43-121)."""
    H = jnp.zeros((7, STATE_DIM), s.x.dtype)
    H = H.at[0:3, 0:3].set(jnp.eye(3, dtype=s.x.dtype))
    H = H.at[3:7, 6:10].set(jnp.eye(4, dtype=s.x.dtype))
    R = jnp.diag(jnp.concatenate([
        jnp.full((3,), cfg.r_pos), jnp.full((4,), cfg.r_quat)
    ]).astype(s.x.dtype))

    # align measured quaternion sign with the state (double cover)
    q_meas = se3.rotation_quat(pose_meas)
    q_meas = jnp.where(jnp.dot(q_meas, s.x[6:10]) < 0, -q_meas, q_meas)
    z = jnp.concatenate([se3.translation(pose_meas), q_meas])

    y = z - H @ s.x
    S = H @ s.P @ H.T + R
    K = s.P @ H.T @ jnp.linalg.inv(S)
    x2 = s.x + K @ y
    x2 = x2.at[6:10].set(se3.quat_normalize(x2[6:10]))
    P2 = (jnp.eye(STATE_DIM, dtype=s.x.dtype) - K @ H) @ s.P
    return EKFState(x2, P2)


def predicted_pose(s: EKFState) -> jnp.ndarray:
    return se3.make_pose(s.x[0:3], s.x[6:10])
