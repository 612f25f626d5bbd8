"""Port parity of the ORB front end against the JAX package: pyramid, blur,
FAST score maps (kernel K1's plain version), selection, IC angles, rBRIEF
and the whole OrbFrontend.extract.

Tolerances, as stated per test:
* pyramid levels: a residue of single gray levels remains (JAX's XLA:CPU
  arithmetic is reproduced but not bit for bit), stated in
  test_pyramid_residue; the front-end test is fed JAX's levels;
* FAST score maps: bit-exact against fast_score_maps and against
  fast_score_maps_pallas(interpret=True); K1's candidate pools (plain
  version) bit-exact against JAX's _cell_candidates, padding included;
* keypoint xy / level / response / valid: identical;
* angles within 1e-5 rad; descriptor bits >= 99.9 % equal (the residue
  is stated by the test).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend
from openvslam_tpu.ops import fast as jfast
from openvslam_tpu.ops import pyramid as jpyr
from openvslam_tpu.ops.pallas.fast_kernel import fast_score_maps_pallas
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.models.frontend import OrbFrontend, level_budgets
from openvslam_tpu_torch.ops import fast, pyramid
from openvslam_tpu_torch.utils import synthetic

H, W, LEVELS, KPTS = 240, 320, 4, 300


@pytest.fixture(scope="module")
def frames():
    cam = Perspective(fx=260.0, fy=260.0, cx=160.0, cy=120.0, cols=W, rows=H)
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(5), n_points=900,
                                         center=(0, 0, 6), extent=(7, 5, 2.5), rows=H, cols=W)
    poses = synthetic.orbit_trajectory(6, radius=2.5, target=(0, 0, 6), arc=np.pi / 16)
    return [scene.render(cam, p) for p in poses[1:3]]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def jax_levels(monkeypatch):
    """Feed the port's front end the JAX package's pyramid levels, so that
    everything downstream is compared on the same integer levels (the
    pyramid's own residue is stated by test_pyramid_residue)."""
    jitted = {}

    def build(img, num_levels, scale):
        key = (tuple(img.shape), num_levels, scale)
        if key not in jitted:
            jitted[key] = jax.jit(lambda x: jpyr.build_pyramid(x, num_levels, scale))
        return [_t(a).to(img.device) for a in jitted[key](jnp.asarray(img.cpu().numpy()))]

    monkeypatch.setattr(pyramid, "build_pyramid", build)


def test_pyramid_residue(frames):
    """The port's levels against JAX's.  The resize reproduces JAX's weights,
    but the reference's own floats depend on how XLA:CPU lays out its dot
    (test_reference_resize_depends_on_layout), and a few near-half values
    round the other way: 2 of 385,978 pixels on these rendered frames and
    11 of 950,532 on a 640x480 noise image, each off by one gray level
    (ROADMAP Queue 3, a reference-side condition).  The blur, fed the same
    levels, differs in 2 pixels on the noise image and none on the rendered
    frames."""
    blur = jax.jit(jpyr.gaussian_blur)

    def residue(img, levels):
        ref = [np.asarray(a) for a in jax.jit(
            lambda x: jpyr.build_pyramid(x, levels, 1.2))(jnp.asarray(img))]
        ours = pyramid.build_pyramid(_t(img), levels, 1.2)
        assert [tuple(o.shape) for o in ours] == [r.shape for r in ref]
        diff = [np.abs(o.numpy() - r) for o, r in zip(ours, ref)]
        assert max(float(d.max()) for d in diff) <= 1.0
        n_blur = sum(int((pyramid.gaussian_blur(_t(r)).numpy()
                          != np.asarray(blur(jnp.asarray(r)))).sum()) for r in ref)
        return sum(int((d > 0).sum()) for d in diff), n_blur

    rendered = [residue(img.astype(np.float32), LEVELS) for img in frames]
    assert sum(n for n, _ in rendered) <= 2 and sum(b for _, b in rendered) == 0, rendered
    noise = np.random.default_rng(0).integers(0, 256, (480, 640)).astype(np.float32)
    n_pyr, n_blur = residue(noise, 8)
    assert n_pyr <= 11 and n_blur <= 2, (n_pyr, n_blur)


def test_reference_resize_depends_on_layout():
    """Why the pyramid residue is the reference's and not the port's: on
    XLA:CPU, jax.image.resize(linear, antialias, HIGHEST) of the seed-0
    480x640 noise image to 400x533 and the same resize of the transposed
    image, transposed back, differ before rounding in about 50,000 of
    213,200 pixels, and a few of them round to another integer.  The
    reference is not invariant under a layout change at near-half values,
    so no contraction order in the port can reproduce it everywhere."""
    img = np.random.default_rng(0).integers(0, 256, (480, 640)).astype(np.float32)

    def resize(x, shape):
        return jax.image.resize(jnp.asarray(x), shape, method="linear", antialias=True,
                                precision=jax.lax.Precision.HIGHEST)

    direct = resize(img, (400, 533))
    via_t = resize(img.T, (533, 400)).T
    n_float = int(np.sum(np.asarray(direct) != np.asarray(via_t)))
    n_round = int(np.sum(np.asarray(jpyr.quantize_u8_grid(direct))
                         != np.asarray(jpyr.quantize_u8_grid(via_t))))
    assert n_float > 10_000, n_float              # measured: 50,123
    assert n_round >= 1, n_round                  # measured: 3
    assert float(np.abs(np.asarray(direct) - np.asarray(via_t)).max()) < 1e-3


def test_resize_nearest_matches_jax(rng):
    m = rng.random((480, 640)).astype(np.float32)
    for shape in pyramid.level_shapes(480, 640, 8, 1.2):
        ref = jax.image.resize(jnp.asarray(m), shape, method="nearest")
        np.testing.assert_array_equal(pyramid.resize_nearest(_t(m), shape).numpy(), np.asarray(ref))


def test_fast_score_maps_bit_exact(rng):
    img = rng.integers(0, 255, (64, 256)).astype(np.float32)
    ref = [np.asarray(a) for a in jfast.fast_score_maps(jnp.asarray(img), [20.0, 7.0])]
    pal = [np.asarray(a) for a in fast_score_maps_pallas(jnp.asarray(img), 20.0, 7.0,
                                                         interpret=True)]
    ours = [o.numpy() for o in fast.fast_score_maps(_t(img), [20.0, 7.0])]
    for o, r, p in zip(ours, ref, pal):
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(o, p)
    assert ours[0].max() > 0
    # the all-levels entry takes the plain version for CPU tensors
    levels, budgets = [img, img[:40, :100]], [64, 16]
    vals, idxs = fast.fast_cell_pools([_t(x) for x in levels], 20.0, 7.0, budgets)
    r_vals, r_idxs = _jax_pools(levels, budgets, None)
    np.testing.assert_array_equal(vals.numpy(), r_vals)
    np.testing.assert_array_equal(idxs.numpy(), r_idxs)


def _jax_pools(levels, budgets, masks, thr=(20.0, 7.0)):
    """JAX's per-level _cell_candidates(fast_score_maps(...)), padded and
    stacked as its select_from_scores_multi does."""
    if masks is None:
        masks = [None] * len(levels)
    pools = [jfast._cell_candidates(*jfast.fast_score_maps(jnp.asarray(x), list(thr)), b, 32,
                                    None if m is None else jnp.asarray(m))[:2]
             for x, b, m in zip(levels, budgets, masks)]
    vmax = max(v.shape[0] for v, _ in pools)
    vals = np.stack([np.pad(np.asarray(v), (0, vmax - v.shape[0]), constant_values=-np.inf)
                     for v, _ in pools])
    idxs = np.stack([np.pad(np.asarray(i), (0, vmax - i.shape[0])) for _, i in pools])
    return vals, idxs


_LEVEL_SHAPES, _BUDGETS = [(96, 160), (80, 133), (67, 111), (56, 93)], [64, 48, 32, 24]


@pytest.mark.parametrize("masked", [False, True])
def test_fast_cell_pools_plain_matches_jax(rng, masked):
    """K1's plain version: the pools of every level, bit-exact in vals and
    idxs, padding included, against JAX's candidate pools."""
    levels = [rng.integers(0, 255, s).astype(np.float32) for s in _LEVEL_SHAPES]
    masks = [(rng.random(s) > 0.3).astype(np.float32) for s in _LEVEL_SHAPES] if masked else None
    vals, idxs = fast.fast_cell_pools_plain([_t(x) for x in levels], 20.0, 7.0, _BUDGETS,
                                            masks=None if masks is None else [_t(m) for m in masks])
    r_vals, r_idxs = _jax_pools(levels, _BUDGETS, masks)
    assert vals.dtype == torch.float32 and idxs.dtype == torch.int64
    assert vals.shape == r_vals.shape == (4, fast.pool_geometry(
        tuple(_LEVEL_SHAPES), tuple(_BUDGETS), 32).vmax)
    np.testing.assert_array_equal(vals.numpy(), r_vals)
    np.testing.assert_array_equal(idxs.numpy(), r_idxs)
    assert np.isinf(r_vals).any() and (r_vals > 1e4).any()


@pytest.mark.parametrize("masked", [False, True])
def test_select_from_pools_equals_per_level_finalize(rng, masked):
    """The one finalize over (L, kmax) with a per-level cells-per-row column
    gives what a finalize per level with its own gw gives."""
    levels = [_t(rng.integers(0, 255, s).astype(np.float32)) for s in _LEVEL_SHAPES]
    masks = [_t((rng.random(s) > 0.3).astype(np.float32)) for s in _LEVEL_SHAPES] if masked else None
    vals, idxs = fast.fast_cell_pools_plain(levels, 20.0, 7.0, _BUDGETS, masks=masks)
    got = fast.select_from_pools(vals, idxs, _LEVEL_SHAPES, _BUDGETS)
    topv, topi = torch.sort(vals, dim=1, descending=True, stable=True)
    sel = torch.gather(idxs, 1, topi)
    for l, ((h, w), b) in enumerate(zip(_LEVEL_SHAPES, _BUDGETS)):
        want = fast._finalize_selection(topv[l, :b], sel[l, :b], -(-w // 32), 32)
        for g, r in zip(got[l], want):
            assert g.shape == r.shape and torch.equal(g, r)


def test_topk_small_equals_lax_topk(rng):
    for shape, k in [((300, 1024), 3), ((40, 64), 9), ((7, 33), 1)]:
        x = rng.integers(0, 50, shape).astype(np.float32)     # many ties
        v1, i1 = jax.lax.top_k(jnp.asarray(x), k)
        v2, i2 = fast.topk_small(_t(x), k)
        np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
        np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))


@pytest.mark.parametrize("masked", [False, True])
def test_detect_levels_matches_jax(rng, masked):
    shapes, budgets = _LEVEL_SHAPES, _BUDGETS
    levels = [rng.integers(0, 255, s).astype(np.float32) for s in shapes]
    masks = [(rng.random(s) > 0.3).astype(np.float32) for s in shapes] if masked else None
    ref = jax.jit(lambda lv, ms: jfast.detect_levels(lv, 20.0, 7.0, budgets, cell=32, masks=ms))(
        [jnp.asarray(x) for x in levels], None if masks is None else [jnp.asarray(m) for m in masks])
    ours = fast.detect_levels([_t(x) for x in levels], 20.0, 7.0, budgets, cell=32,
                              masks=None if masks is None else [_t(m) for m in masks])
    for (rxy, rresp, rval), (oxy, oresp, oval) in zip(ref, ours):
        np.testing.assert_array_equal(oxy.numpy(), np.asarray(rxy))
        np.testing.assert_array_equal(oresp.numpy(), np.asarray(rresp))
        np.testing.assert_array_equal(oval.numpy(), np.asarray(rval))


def test_frontend_matches_jax(frames, jax_levels):
    assert sum(level_budgets(1000, 8, 1.2)) == 1032
    jfe = JaxFrontend(H, W, max_keypts=KPTS, num_levels=LEVELS)
    fe = OrbFrontend(H, W, max_keypts=KPTS, num_levels=LEVELS, device="cpu")
    assert fe.capacity == jfe.capacity
    mask = np.ones((H, W), np.float32)
    mask[:, : W // 4] = 0.0
    for img, m in ((frames[0], None), (frames[1], mask)):
        kj = jfe.extract(jnp.asarray(img), None if m is None else jnp.asarray(m))
        kt = fe.extract(_t(img), None if m is None else _t(m))
        for f in ("xy", "response", "valid"):
            np.testing.assert_array_equal(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)))
        np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))
        v = np.asarray(kj.valid)
        assert v.sum() > 100
        np.testing.assert_allclose(kt.angle.numpy()[v], np.asarray(kj.angle)[v], rtol=0, atol=1e-5)
        bits_t = np.unpackbits(kt.desc_u32.numpy().view(np.uint32)[v].view(np.uint8))
        bits_j = np.unpackbits(np.asarray(kj.desc_u32)[v].view(np.uint8))
        agree = (bits_t == bits_j).mean()
        assert agree >= 0.999, agree          # measured: 1.0 on these frames
        np.testing.assert_array_equal(kt.desc_u32.numpy().view(np.uint32)[~v], 0)



def test_ic_moments_match_jax_maps(frames):
    """IC moments: the port's maps and its per-keypoint patch sums equal the
    JAX package's moment maps exactly (integer sums below 2**24)."""
    from openvslam_tpu.ops import orb as jorb
    from openvslam_tpu_torch.ops import orb

    img = frames[0].astype(np.float32)
    m10_j, m01_j = (np.asarray(a) for a in jax.jit(jorb.ic_moment_maps)(jnp.asarray(img)))
    m10_t, m01_t = orb.ic_moment_maps(_t(img))
    np.testing.assert_array_equal(m10_t.numpy(), m10_j)
    np.testing.assert_array_equal(m01_t.numpy(), m01_j)
    xy = np.stack(np.meshgrid(np.arange(0, W, 7), np.arange(0, H, 5)), -1).reshape(-1, 2)
    a10, a01 = orb.ic_moments_at(_t(img), _t(xy.astype(np.float32)))
    np.testing.assert_array_equal(a10.numpy(), m10_j[xy[:, 1], xy[:, 0]])
    np.testing.assert_array_equal(a01.numpy(), m01_j[xy[:, 1], xy[:, 0]])
