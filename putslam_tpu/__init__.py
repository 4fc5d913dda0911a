"""putslam_tpu — an RGB-D feature-based SLAM engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of LRMPUT/PUTSLAM
(reference: /root/reference, single-process multi-threaded C++). Everything here
is built for an accelerator:

* fixed-capacity, mask-annotated arrays instead of pointer graphs,
* batched/vmapped matmuls instead of per-feature C++ loops,
* `lax`-structured control flow under `jit` instead of OS threads + mutexes,
* `jax.sharding.Mesh` + collectives instead of shared memory.

Subpackages
-----------
geometry     SE(3) / quaternion math, pinhole camera + distortion, uncertainty
ops          low-level batched kernels (FAST, ORB, Hamming matmul, 3x3 solvers)
frontend     detection/description/matching/RANSAC visual odometry
slam_map     fixed-capacity feature map, keyframes, covisibility
backend      factor-graph bundle adjustment (Gauss-Newton + Schur + PCG)
loopclosure  binary bag-of-words place recognition + geometric verification
motion       decaying-velocity EKF motion model
io           TUM/ICL dataset players, synthetic RGB-D sequences, traj writers
eval         ATE / RPE evaluation (TUM script semantics)
parallel     device-mesh sharding of the map and distributed BA
models       end-to-end SLAM "models" (VO-only, full SLAM) as jittable steps
"""

__version__ = "0.1.0"
