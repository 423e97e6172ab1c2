"""Distributed sliding-window BA over a device mesh.

The reference has no distributed computing at all (4 pthreads over shared
memory, SURVEY §2.3); this module is the scale-out path: landmark blocks
sharded over a `jax.sharding.Mesh` axis, per-shard Hessian/gradient
contributions combined with `psum` (which XLA hands to NCCL; the GPUs of
one host are joined all to all by NVLink, so the 1-D mesh follows the
algorithm alone), the tiny Schur-reduced camera system solved redundantly on
every shard, and landmark back-substitution kept local.

Communication per LM iteration is exactly:
  psum of F (scalar), Hpp [W,6,6], bp [W,6],
  psum of S_cross [W,W,6,6], corr [W,6], pred_l (scalar)
i.e. O(W^2) floats — independent of the landmark count, so scaling
efficiency approaches the compute ratio as M grows.

Multi-host: build the mesh from `jax.devices()` after
`jax.distributed.initialize()`; the same code paths span hosts.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ssvio_tpu.ops import ba

LM_AXIS = "lm"


def make_mesh(devices=None, axis_name: str = LM_AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def problem_specs():
    """PartitionSpecs for LocalBAProblem fields: landmark-indexed arrays are
    sharded on the mesh axis, window/pose arrays replicated."""
    return ba.LocalBAProblem(
        kf_T_cw=P(), kf_valid=P(), kf_fixed=P(),
        lm_pos=P(LM_AXIS), lm_valid=P(LM_AXIS), lm_fixed=P(LM_AXIS),
        obs_uv=P(LM_AXIS), obs_valid=P(LM_AXIS))


def result_specs():
    return ba.LocalBAResult(kf_T_cw=P(), lm_pos=P(LM_AXIS),
                            obs_valid=P(LM_AXIS), chi2=P(LM_AXIS),
                            inlier_ratio=P())


def distributed_local_ba(mesh: Mesh, fx, fy, cx, cy, baseline,
                         max_rounds: int = 5, iters: int = 10):
    """Build a jitted distributed local-BA step for the given mesh.

    Returns a function LocalBAProblem -> LocalBAResult. The landmark
    capacity M must be divisible by the mesh size.
    """
    fn = functools.partial(ba.local_ba, fx=fx, fy=fy, cx=cx, cy=cy,
                           baseline=baseline, max_rounds=max_rounds,
                           iters=iters, axis_name=LM_AXIS)
    mapped = shard_map(fn, mesh=mesh, in_specs=(problem_specs(),),
                       out_specs=result_specs())
    return jax.jit(mapped)


def shard_problem(mesh: Mesh, prob: ba.LocalBAProblem) -> ba.LocalBAProblem:
    """Place a host-built problem onto the mesh with the right shardings."""
    specs = problem_specs()
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), prob, specs)
