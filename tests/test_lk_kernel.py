"""The GPU LK level kernel (ops/lk_triton.py) on the CPU: the kernel body
in the Pallas interpreter against the XLA reference, the wrapper's
padding, the platform's choice of implementation, and its lowering for
CUDA. On the card, chip_smoke.py compares the compiled kernel at real
widths."""

from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssvio_tpu.ops import fast, lk, lk_triton, pyramid, sampling

SHIFT = (3.2, -2.1)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (192, 256)).astype(np.float32)
    img = cv2.GaussianBlur(img, (7, 7), 1.5)
    M = np.float32([[1, 0, SHIFT[0]], [0, 1, SHIFT[1]]])
    img2 = cv2.warpAffine(img, M, (256, 192))
    xy, _, v = fast.detect_grid(jnp.asarray(img), max_kps=64, cell=16)
    pts = np.asarray(xy)[np.asarray(v)]
    m = ((pts[:, 0] > 30) & (pts[:, 0] < 226) & (pts[:, 1] > 30)
         & (pts[:, 1] < 162))
    return jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts[m][:32])


def test_kernel_level_matches_xla(scene):
    img, img2, p = scene
    gx, gy = pyramid.sobel_gradients(img)
    v = jnp.ones(p.shape[0], bool)
    guess = p + jnp.asarray([2.0, -1.0])
    params = lk.LKParams()
    out_x, ok_x = lk._track_level(img, img2, gx, gy, p, guess, v, params)
    out_k, ok_k = lk._track_level_kernel(img, img2, gx, gy, p, guess, v,
                                         params, interpret=True)
    np.testing.assert_array_equal(np.asarray(ok_k), np.asarray(ok_x))
    both = np.asarray(ok_x)
    assert both.mean() > 0.8
    np.testing.assert_allclose(np.asarray(out_k)[both],
                               np.asarray(out_x)[both], atol=1e-3)


def test_kernel_full_track_recovers_shift(scene):
    img, img2, p = scene
    pyr1 = pyramid.build_lk_pyramid(img, 3)
    pyr2 = pyramid.build_lk_pyramid(img2, 3)
    valid = jnp.ones(p.shape[0], bool)
    out_x, ok_x, _ = lk.track(pyr1, pyr2, p, p, valid, _impl="xla")
    out_k, ok_k, _ = lk.track(pyr1, pyr2, p, p, valid, _impl="interpret")
    both = np.asarray(ok_x) & np.asarray(ok_k)
    assert both.mean() > 0.8
    np.testing.assert_allclose(np.asarray(out_k)[both],
                               np.asarray(out_x)[both], atol=1e-2)
    flow = np.asarray(out_k)[both] - np.asarray(p)[both]
    np.testing.assert_allclose(np.median(flow, axis=0), SHIFT, atol=0.2)


def test_wrapper_pads_to_group_and_freezes_invalid(scene):
    """N = 500 is not a multiple of an 8-keypoint group: the padded grid
    returns exactly N rows, the padding changes no real slot, and invalid
    slots come back at their seed with ok=False."""
    img, img2, p = scene
    rng = np.random.default_rng(3)
    n = 500
    pts = np.asarray(p)[rng.integers(0, p.shape[0], n)]
    pts = jnp.asarray(pts + rng.uniform(-0.5, 0.5, pts.shape)
                      .astype(np.float32))
    valid = jnp.asarray(rng.uniform(size=n) > 0.3)
    pyr1 = pyramid.build_lk_pyramid(img, 2)
    pyr2 = pyramid.build_lk_pyramid(img2, 2)
    params = lk.LKParams(levels=2, iters=10)
    outs = []
    for group in (1, 8):
        with mock.patch.object(lk_triton, "GROUP", group):
            outs.append(lk.track(pyr1, pyr2, pts, pts, valid, params,
                                 compute_err=False, _impl="interpret"))
    (xy1, ok1, _), (xy8, ok8, _) = outs
    assert xy8.shape == (n, 2) and ok8.shape == (n,)
    np.testing.assert_array_equal(np.asarray(xy8), np.asarray(xy1))
    np.testing.assert_array_equal(np.asarray(ok8), np.asarray(ok1))
    inv = ~np.asarray(valid)
    np.testing.assert_array_equal(np.asarray(xy8)[inv], np.asarray(pts)[inv])
    assert not np.asarray(ok8)[inv].any()


def _track_jaxpr(impl):
    pyr = [jnp.zeros((64 >> l, 128 >> l), jnp.float32) for l in range(3)]
    p = jnp.zeros((16, 2), jnp.float32)
    v = jnp.ones((16,), bool)
    return str(jax.make_jaxpr(
        lambda a, b, q, m: lk.track(a, b, q, q, m, _impl=impl))(
            pyr, pyr, p, v))


def test_cpu_path_runs_no_kernel():
    """Traced for the CPU, lk.track is the XLA reference: no pallas_call,
    so no interpret-mode kernel hides on a real path."""
    assert lk._platform_impl() == "xla"
    assert "pallas_call" not in _track_jaxpr(None)


def test_interpret_path_runs_the_kernel():
    assert "pallas_call" in _track_jaxpr("interpret")


def test_kernel_lowers_for_cuda():
    """The kernel lowers through the Triton route at a real level size
    (1248x384, 512 keypoints) without a GPU: the GPU's compiler sees only
    what this lowering emits."""
    from jax import export

    def level(a, b, gx, gy, p, q, v):
        return lk_triton.track_level(a, b, gx, gy, p, q, v, window=11,
                                     margin=8, iters=30, eps=0.01,
                                     min_eig=1e-4)

    img = jax.ShapeDtypeStruct((384, 1248), jnp.float32)
    pts = jax.ShapeDtypeStruct((512, 2), jnp.float32)
    exp = export.export(
        jax.jit(level), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        img, img, img, img, pts, pts, jax.ShapeDtypeStruct((512,), bool))
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
def test_gpu_path_runs_the_kernel(gpu_device):
    """On a GPU the platform picks the kernel (no option does)."""
    assert lk._platform_impl() == "kernel"
    assert "pallas_call" in _track_jaxpr(None)


def test_in_bounds_gate_matches_reference_border(scene):
    """The wrapper's ok adds the reference's 1-px border gates to the
    kernel's conditioning test: a keypoint on the image edge is never ok."""
    img, img2, _ = scene
    gx, gy = pyramid.sobel_gradients(img)
    p = jnp.asarray([[0.5, 100.0], [128.0, 96.0]], jnp.float32)
    v = jnp.ones(2, bool)
    _, ok = lk._track_level_kernel(img, img2, gx, gy, p, p, v,
                                   lk.LKParams(), interpret=True)
    assert not bool(ok[0])
    assert bool(sampling.in_bounds(p[1], 192, 256, border=1.0))
