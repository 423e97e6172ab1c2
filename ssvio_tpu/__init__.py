"""ssvio_tpu — a stereo visual SLAM engine written in JAX.

Brand-new JAX/XLA/Pallas implementation with the capabilities of the
reference system weihaoysgs/ssvio (stereo ORB + pyramidal-LK tracking,
stereo triangulation, keyframe sliding-window local bundle adjustment,
BoW loop detection, pose-graph optimization) — re-designed SLAM-as-tensors:

- All per-frame state is fixed-shape, masked arrays so the hot path jits once.
- The front end (pyramids, FAST, BRIEF, LK) is data-parallel over pixels /
  keypoints; the optimizers (pose-only LM, Schur-reduced local BA, PGO) are
  batched Gauss-Newton/LM over dense masked tensors. On a GPU, LK runs as a
  Pallas kernel (ops/lk_triton.py); everything else is plain XLA.
- Scale-out shards landmark blocks over a `jax.sharding.Mesh` and combines
  Hessian contributions with `psum` collectives (NCCL over NVLink between
  the GPUs of a host).

Conventions (used everywhere, documented once):
- Pose `T_cw`: maps world points into the camera frame; stored as a [3,4]
  float32 matrix `[R | t]`. Trajectories are exported as `T_wc` (camera in
  world), matching TUM format.
- se3 twists are ordered `[rho(3), phi(3)]` (translation, rotation), with
  LEFT-multiplicative updates: `T <- Exp(xi) @ T` (matches the reference's
  g2o vertex update semantics, reference include/ssvio/g2otypes.hpp:28-46).
- Images are float32 grayscale `[H, W]` in [0, 255]. Keypoints are `(x, y)`
  pixel coordinates, float32.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/optimizer matmuls are tiny (3x3..96x96) but accuracy-critical:
# on a GPU, float32 matmuls may run in TF32 (about three decimal digits),
# which injects ~1e-3 relative error into pose chains and normal equations.
# Force true f32 everywhere; the hot front-end kernels are
# elementwise/gather so this costs nothing there, and any future
# bandwidth-bound matmul can opt down locally.
_jax.config.update("jax_default_matmul_precision", "highest")

from ssvio_tpu.config import Settings  # noqa: F401
