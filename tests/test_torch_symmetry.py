"""Port parity of symmetry completion (stage (g) of the extraction) against
the JAX package on the CPU: ``frontend/symmetry.py`` (the mirrored-cloud
cost, its gradient, the 9-plane LM search, the cloud completion, the label
table), ``ops/backproject.proj_depth_map``, the extractor with
``open_symmetry`` against JAX and the f64 oracle.

Inputs are made with numpy from a seed and go to both sides.  Tolerances:
the cost 1e-5 relative (f32 sums in another order; 1e-6 absolute where the
cost is the round-off of an exact mirror image); the gradient 1e-4
relative to its largest component, autograd of the plain cost against
``jax.grad`` and the hand-written gradient (the one the LM and the kernel
use) against autograd, on clouds with tied nearest neighbours and on a
dyadic cloud lying on the initial plane (the norm expansion is exactly 0
there); ``complete_cloud`` 1e-5; ``proj_depth_map`` 1e-6 relative.

The 9-plane search: all 9 initial planes' parameters 1e-4 and costs 1e-5,
the same winner.  Its 5 LM iterations solve g g^T + lam I with lam = 1e-5
max diag in float32, where an ulp of the gradient or the cost moves the
step by up to a few percent: the port leaves JAX's trajectory in the first
step, a fault logged in ROADMAP.md queue 3 (examples/symmetry_lm_parity.py
prints its sizes) and marked on the cases it breaks, as the fragment-seed
fault was.  The extractor's outputs: centres
1e-3, sorted scales 2e-3, Two 1e-4, prob 1e-5; the oracle's 2 cm / 2 deg.
The whole run with symmetry is tests/test_torch_symmetry_run.py.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core import plane as jpl
from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import extractor as jext
from object_oriented_slam_tpu.frontend import symmetry as jsym
from object_oriented_slam_tpu.ops import backproject as jbp
from object_oriented_slam_tpu_torch.core import se3
from object_oriented_slam_tpu_torch.core.camera import Camera
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor)
from object_oriented_slam_tpu_torch.frontend import extractor as text
from object_oriented_slam_tpu_torch.frontend import symmetry as tsym
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.ops import backproject as tbp

sys.path.insert(0, os.path.dirname(__file__))
import oracle_frontend as orc  # noqa: E402

torch.set_num_threads(1)    # the test workers share the CPU

CAM = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
JCAM = JCamera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
SIGMA = 0.1
# the depth scene's labels: two dual reflections (28), three reflections
# (57, 63, 59) and one without symmetry (58)
LABELS = [28, 57, 58, 28, 63, 59]


def _t(a):
    return torch.from_numpy(np.array(a))


def _symmetric_cloud(rng, angle=0.06, dis=0.08, n=150):
    """A cloud symmetric about the plane fromDisAngle(dis, angle)."""
    half = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    pi = np.asarray(jpl.from_dis_angle(jnp.float32(dis), jnp.float32(angle)))
    half = half[(half @ pi[:3] + pi[3]) > 0.02][:n // 2]
    mirrored = np.asarray(jpl.mirror_points(jnp.asarray(pi),
                                            jnp.asarray(half)))
    return np.concatenate([half, mirrored]).astype(np.float32)


def _pad(cloud, cap, rng=None):
    """[cap, 3] points and mask; with ``rng`` the live lanes are scattered
    (the kernel and the plain versions compact them in index order)."""
    pts = np.zeros((cap, 3), np.float32)
    mask = np.zeros(cap, bool)
    pts[:len(cloud)] = cloud
    mask[:len(cloud)] = True
    if rng is not None:
        perm = rng.permutation(cap)
        pts, mask = pts[perm], mask[perm]
    return pts, mask


def _depth(rng):
    """A depth image: a wall at 1.4 m on the right, nothing on the left."""
    depth = np.full((480, 640), 7000, np.int32)
    depth[:, :300] = 0
    depth[200:260, 300:360] = rng.integers(3000, 9000, (60, 60))
    return depth


def _cases():
    """name -> (pts, mask, bbox, pose_oc, depth): the far camera (no mirrored
    point lands in the tiny box: the pure 1-NN cost), a camera at 1.5 m over
    a box on the whole image (some mirrored points occluded), tied nearest
    neighbours (every point twice) and a dyadic cloud on the plane y = 0."""
    rng = np.random.default_rng(11)
    far = np.array([0, 0, -50, 0, 0, 0, 1], np.float32)
    near = np.array([0.1, 0.05, -1.5, 0, 0, 0, 1], np.float32)
    tiny = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    whole = np.array([0.0, 0.0, 639.0, 479.0], np.float32)
    sym = _symmetric_cloud(rng)
    rand = rng.uniform(-0.2, 0.2, (100, 3)).astype(np.float32)
    twice = np.concatenate([rand[:40], rand[:40]])
    dyadic = np.zeros((48, 3), np.float32)
    dyadic[:, 0] = rng.integers(-8, 8, 48) / 32.0
    dyadic[:, 2] = rng.integers(-8, 8, 48) / 32.0
    dyadic[24:, 1] = rng.integers(1, 8, 24) / 32.0
    depth = _depth(rng)
    return {
        "symmetric": (*_pad(sym, 160, rng), tiny, far, depth),
        "occluded": (*_pad(rand, 128), whole, near, depth),
        "ties": (*_pad(twice, 96), whole, near, depth),
        "on_plane": (*_pad(dyadic, 64), tiny, far, depth),
    }


CASES = _cases()
PARAMS = {"true": (0.06, 0.08, 0.01), "off": (0.4, 0.15, -0.05),
          "init": (0.0, 0.0, 0.0)}


def _jax_cost(case, dual):
    pts, mask, bbox, pose_oc, depth = CASES[case]
    pj = jnp.asarray(pts)
    proj = jbp.proj_depth_map(jnp.asarray(depth), JCAM)

    def cost(p):
        p1 = jsym._plane_from_params(p[0], p[1])
        planes = (jnp.stack([p1, jpl.dual_other_plane(p1, p[2])]) if dual
                  else p1[None])
        return jsym._mirror_cost(planes, pj.T, jnp.sum(pj * pj, axis=1),
                                 jnp.asarray(mask), jnp.asarray(bbox),
                                 jnp.asarray(pose_oc), proj, JCAM, SIGMA)
    return jax.jit(cost), np.asarray(proj)


def _port_clouds(case, proj):
    pts, mask, bbox, pose_oc, _ = CASES[case]
    return tsym._clouds(_t(pts)[None], _t(mask)[None], _t(bbox)[None],
                        _t(pose_oc)[None], _t(proj), CAM, SIGMA)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("case,params", [
    ("symmetric", "true"), ("symmetric", "off"), ("occluded", "off"),
    ("ties", "off"), ("on_plane", "init")])
def test_mirror_cost_matches_jax(case, params, dual):
    jcost, proj = _jax_cost(case, dual)
    par = np.array(PARAMS[params][:3 if dual else 2], np.float32)
    want = float(jcost(jnp.asarray(par)))
    got = float(tsym._mirror_eval(_t(par)[None, None], _port_clouds(
        case, proj), dual))
    # 1e-5 relative, and 1e-6 absolute: at the true plane every term is the
    # norm expansion's round-off, 50 / sigma^2-scaled ulps of |p|^2 ~ 0.1
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-6, (got, want)
    if case == "symmetric" and params == "true" and not dual:
        assert want < 0.05            # the true plane explains the cloud
    if case == "symmetric" and params == "off":
        assert want > 0.1


def test_occluded_case_occludes():
    """The near camera's box and wall occlude part of the mirrored cloud:
    the cost is below the far camera's pure 1-NN cost of the same cloud."""
    jcost, _ = _jax_cost("occluded", False)
    pts, mask, _, _, depth = CASES["occluded"]
    far = np.array([0, 0, -50, 0, 0, 0, 1], np.float32)
    pj = jnp.asarray(pts)
    free = jax.jit(lambda p: jsym._mirror_cost(
        jsym._plane_from_params(p[0], p[1])[None], pj.T,
        jnp.sum(pj * pj, axis=1), jnp.asarray(mask),
        jnp.asarray(np.array([0.0, 0, 1, 1], np.float32)), jnp.asarray(far),
        jnp.zeros((480, 640)), JCAM, SIGMA))(jnp.asarray([0.4, 0.15],
                                                          jnp.float32))
    assert 0 < float(jcost(jnp.asarray([0.4, 0.15], jnp.float32))) \
        < float(free)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("case,params", [
    ("symmetric", "off"), ("occluded", "off"), ("ties", "off"),
    ("on_plane", "init")])
def test_gradient_matches_jax(case, params, dual):
    """autograd of the plain cost (torch.amin, torch.maximum) against
    jax.grad; the hand-written gradient against autograd."""
    jcost, proj = _jax_cost(case, dual)
    par = np.array(PARAMS[params][:3 if dual else 2], np.float32)
    want = np.asarray(jax.jit(jax.grad(jcost))(jnp.asarray(par)))
    cl = _port_clouds(case, proj)
    p = _t(par)[None, None].requires_grad_(True)
    auto = torch.autograd.grad(tsym._mirror_eval(p, cl, dual).sum(), p)[0]
    auto = auto[0, 0].numpy()
    _, hand = tsym._mirror_eval(_t(par)[None, None], cl, dual,
                                want_grad=True)
    hand = hand[0, 0].numpy()
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(auto - want).max() <= 1e-4 * scale, (auto, want)
    assert np.abs(hand - auto).max() <= 1e-5 * scale, (hand, auto)
    if case == "on_plane":
        # half the cloud lies on the plane and mirrors onto itself: its
        # squared distances are exactly 0 by the norm expansion
        assert scale > 0


# the port's 9-plane search leaves JAX's trajectory in its first LM step
# (ROADMAP queue 3): the step solves g g^T + lam0 I, lam0 = 1e-5 max diag, in
# float32, and an ulp of g or of the cost (the two packages sum in other
# orders) moves its smaller component by percents
LM_FAULT = pytest.mark.xfail(strict=False, reason=(
    "fault logged in ROADMAP.md queue 3: frontend/symmetry._optimize_one_init"
    " (JAX :177-209) amplifies f32 round-off of the gradient and the cost "
    "through the Cholesky solve of g g^T + 1e-5 max(diag) I; after 5 "
    "iterations the port's 9 initial planes differ from JAX's by up to 0.113 "
    "in the parameters and 0.033 in the costs on the occluded cloud, where "
    "the winner differs too; JAX itself moves as far under a 1-ulp change of "
    "its input (examples/symmetry_lm_parity.py)"))


def _search_inputs():
    """The symmetric and the occluded cloud as two detections of one call
    (the occluded one padded to the symmetric one's lanes)."""
    names = ("symmetric", "occluded")
    lanes = CASES["symmetric"][0].shape[0]

    def stacked(k, pad=False):
        return np.stack([np.pad(CASES[n][k], [(0, lanes - len(CASES[n][k]))]
                                + [(0, 0)] * (CASES[n][k].ndim - 1))
                         if pad else CASES[n][k] for n in names])
    return (stacked(0, True), stacked(1, True), stacked(2), stacked(3),
            CASES["symmetric"][4])


def _jax_search(dual, analytic):
    """JAX's 9 initial planes of each detection after the LM: (params
    [D, 9, 3], costs [D, 9], probs [D, 9])."""
    pts, mask, bbox, pose_oc, depth = _search_inputs()
    cfg = jsym.SymmetryConfig(analytic_grad=analytic)
    steps = jnp.array([-1.0, 0.0, 1.0])
    dd, aa = jnp.meshgrid(steps * cfg.step_dis,
                          steps * jnp.deg2rad(cfg.step_angle_deg))
    proj = jbp.proj_depth_map(jnp.asarray(depth), JCAM)

    def one(p, m, b, po):
        return jax.vmap(lambda a, d: jsym._optimize_one_init(
            a, d, p.T, jnp.sum(p * p, axis=1), m, b, po, proj, JCAM, cfg,
            dual))(aa.reshape(-1), dd.reshape(-1))
    res = jax.vmap(one)(*(jnp.asarray(t) for t in (pts, mask, bbox,
                                                   pose_oc)))
    plane = np.asarray(res.plane)
    params = np.stack([np.arctan2(plane[..., 0], -plane[..., 1]),
                       -plane[..., 3], np.asarray(res.dual_dis)], axis=-1)
    return params, np.asarray(res.error), np.asarray(res.prob)


def _port_search(dual, analytic, types=None, run=None):
    pts, mask, bbox, pose_oc, depth = _search_inputs()
    D = len(pts)
    types = torch.full((D,), 2 if dual else 1, dtype=torch.int32) \
        if types is None else types
    run = torch.ones(D, dtype=torch.bool) if run is None else run
    return tsym.estimate_symmetry(
        _t(pts), _t(mask), _t(bbox), _t(pose_oc), _t(depth), types, run,
        CAM, tsym.SymmetryConfig(analytic_grad=analytic))


@LM_FAULT
@pytest.mark.parametrize("analytic", [True, False],
                         ids=["analytic", "central"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_estimate_symmetry_matches_jax(dual, analytic):
    """All 9 initial planes after the LM, on the symmetric and the occluded
    cloud: parameters 1e-4, costs 1e-5 relative, the same winner unless
    the two best probs lie within 1e-6."""
    got = _port_search(dual, analytic)
    params, cost, prob = _jax_search(dual, analytic)
    ini = got.inits.numpy()
    for d in range(len(prob)):
        top = np.sort(prob[d])[-2:]
        if top[1] - top[0] > 1e-6:
            assert int(np.argmax(ini[d, :, 4])) == int(np.argmax(prob[d]))
    np.testing.assert_allclose(ini[..., :3], params, atol=1e-4)
    np.testing.assert_allclose(ini[..., 3], cost, rtol=1e-5)


@pytest.mark.parametrize("analytic", [True, False],
                         ids=["analytic", "central"])
def test_estimate_symmetry_runs_each_detection_by_its_type(analytic):
    """One call serves both variants: a detection's type picks the single
    or the dual search (each row equal to that variant's search of that
    detection alone),
    type 0 and a detection off the run mask get no search; the winner is
    the first maximum of exp(-cost) over the 9 initial planes."""
    pts, mask, bbox, pose_oc, depth = _search_inputs()
    types = torch.tensor([1, 2], dtype=torch.int32)
    both = _port_search(False, analytic, types)
    for d, dual in ((0, False), (1, True)):
        alone = _port_search(dual, analytic, torch.tensor(
            [1 + dual if k == d else 0 for k in range(2)], dtype=torch.int32))
        for f, g in zip(both, alone):
            np.testing.assert_array_equal(f[d].numpy(), g[d].numpy())
        ini = both.inits[d].numpy()
        np.testing.assert_array_equal(
            ini[:, 4], torch.exp(-both.inits[d, :, 3]).numpy())
        k = int(np.argmax(ini[:, 4]))
        assert float(both.prob[d]) == ini[k, 4]
        assert float(both.error[d]) == ini[k, 3]
        assert float(both.dual_dis[d]) == (ini[k, 2] if dual else 0.0)
        np.testing.assert_array_equal(
            both.plane[d].numpy(),
            tsym._plane_from_params(torch.tensor(ini[k, 0]),
                                    torch.tensor(ini[k, 1])).numpy())
        if not dual:
            assert (ini[:, 2] == 0).all()
        # the LM accepts only steps that lower the cost
        pts, mask, bbox, pose_oc, depth = _search_inputs()
        start = tsym.estimate_symmetry(
            _t(pts), _t(mask), _t(bbox), _t(pose_oc), _t(depth), types,
            torch.ones(2, dtype=torch.bool), CAM,
            tsym.SymmetryConfig(iters=0, analytic_grad=analytic))
        c0 = start.inits[d, :, 3].numpy()
        assert (ini[:, 3] <= c0).all() and (ini[:, 3] < c0).any()
    for types, run in ((torch.tensor([0, 0], dtype=torch.int32), None),
                       (types, torch.tensor([False, False]))):
        off = _port_search(False, analytic, types, run)
        np.testing.assert_array_equal(off.plane.numpy(), [[0, -1, 0, 0]] * 2)
        assert not off.prob.any() and not off.error.any()
        assert not off.dual_dis.any() and not off.inits.any()


def _kernel_case_clouds(lanes=512, seed=3):
    """The two searched detections of test_torch_frontend_kernels.py's
    _sym_inputs (the symmetry_search kernel's path case), made the same way:
    a reflection-symmetric cloud seen from afar (type 1) and a random cloud
    under a near camera whose box and depth occlude part of its mirror
    (type 2).  Returns [(pts, mask, bbox, pose_oc, dual)] and the depth."""
    rng = np.random.default_rng(seed)
    half = rng.uniform(-0.3, 0.3, (200, 3)).astype(np.float32)
    half = half[half[:, 1] > 0.02][:100]
    sym_cloud = np.concatenate([half, half * np.float32([1, -1, 1])])
    rand = rng.uniform(-0.2, 0.2, (lanes, 3)).astype(np.float32)
    out = []
    for d, cloud in enumerate((sym_cloud, rand)):
        idx = rng.permutation(lanes)[:len(cloud)]
        pts = np.zeros((1, lanes, 3), np.float32)
        mask = np.zeros((1, lanes), bool)
        pts[0, idx], mask[0, idx] = cloud, True
        bbox = np.array([[0, 0, 1, 1], [0, 0, 639, 479]][d:d + 1], np.float32)
        pose = np.array([[0, 0, -50, 0, 0, 0, 1],
                         [0.1, 0.05, -1.5, 0, 0, 0, 1]][d:d + 1], np.float32)
        out.append((pts, mask, bbox, pose, d == 1))
    depth = np.full((480, 640), 7000, np.int32)
    depth[:, :300] = 0
    return out, depth


def test_search_rejects_and_accepts_steps():
    """The kernel's exact-gradient search keeps the gradient of the last
    accepted trial: on a rejected step p is unchanged, and so is g.  Its
    path case must therefore reject some LM steps and accept others.  The
    plain search taken one lm_step at a time on those clouds: over the 9
    initial planes and 5 iterations of each detection both occur, and the
    result is optimize_inits_plain's to the bit."""
    cases, depth = _kernel_case_clouds()
    proj = tbp.proj_depth_map(_t(depth), CAM)
    cfg = tsym.SymmetryConfig()
    accepted = rejected = 0
    for pts, mask, bbox, pose, dual in cases:
        args = (_t(pts), _t(mask), _t(bbox), _t(pose), proj, CAM)
        cl = tsym._clouds(*args, cfg.sigma)
        ang, dis = tsym.init_grid(cfg)
        p = torch.zeros((1, tsym.N_INITS, 3 if dual else 2))
        p[..., 0], p[..., 1] = ang, dis
        c = tsym._mirror_eval(p, cl, dual)
        lam, nu = torch.full_like(c, -1.0), torch.full_like(c, 2.0)
        for _ in range(cfg.iters):
            _, g = tsym._mirror_eval(p, cl, dual, want_grad=True)
            p, c_next, lam, nu = tsym.lm_step(
                p, g, c, lam, nu, lambda q: tsym._mirror_eval(q, cl, dual))
            accepted += int((c_next < c).sum())
            rejected += int((c_next == c).sum())
            c = c_next
        want_p, want_c = tsym.optimize_inits_plain(*args, dual, cfg)
        assert torch.equal(p, want_p) and torch.equal(c, want_c)
    assert accepted > 0 and rejected > 0, (accepted, rejected)


def test_search_recovers_the_plane():
    """As tests/test_symmetry.py: the symmetric cloud's plane, up to sign."""
    pts, mask, bbox, pose_oc, _ = CASES["symmetric"]
    res = tsym.estimate_symmetry(
        _t(pts)[None], _t(mask)[None], _t(bbox)[None], _t(pose_oc)[None],
        torch.zeros((480, 640), dtype=torch.int32),
        torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool), CAM)
    got = res.plane[0].numpy()
    want = np.asarray(jpl.from_dis_angle(jnp.float32(0.08),
                                         jnp.float32(0.06)))
    gn = got / np.linalg.norm(got[:3])
    assert min(np.linalg.norm(gn - want), np.linalg.norm(gn + want)) < 0.05
    assert float(res.prob[0]) > 0.5


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_complete_cloud_matches_jax(dual):
    rng = np.random.default_rng(5)
    clouds = [_symmetric_cloud(rng)[:60], rng.uniform(-0.1, 0.1, (40, 3))]
    pts, mask = zip(*(_pad(c.astype(np.float32), 64) for c in clouds))
    plane = np.stack([np.asarray(jpl.from_dis_angle(jnp.float32(d),
                                                    jnp.float32(a)))
                      for d, a in ((0.08, 0.06), (-0.02, 0.7))])
    dual_dis = np.array([0.03, -0.01], np.float32)
    res = tsym.SymSearch(plane=_t(plane), dual_dis=_t(dual_dis),
                         prob=torch.ones(2), error=torch.zeros(2),
                         inits=torch.zeros((2, 9, 5)))
    out, om, Tom = tsym.complete_cloud(_t(np.stack(pts)), _t(np.stack(mask)),
                                       res, dual)
    for d in range(2):
        jres = jsym.SymResult(plane=jnp.asarray(plane[d]),
                              dual_dis=jnp.float32(dual_dis[d]),
                              prob=jnp.float32(1.0), error=jnp.float32(0.0))
        jout, jom, jTom = jsym.complete_cloud(jnp.asarray(pts[d]),
                                              jnp.asarray(mask[d]), jres,
                                              dual)
        np.testing.assert_array_equal(om[d].numpy(), np.asarray(jom))
        np.testing.assert_allclose(out[d].numpy(), np.asarray(jout),
                                   atol=1e-5)
        np.testing.assert_allclose(Tom[d].numpy(), np.asarray(jTom),
                                   atol=1e-5)
        assert int(om[d].sum()) == (4 if dual else 2) * int(mask[d].sum())


def test_sym_type_of_labels_matches_jax():
    labels = np.arange(100)
    np.testing.assert_array_equal(tsym.sym_type_of_labels(labels),
                                  jsym.sym_type_of_labels(labels))
    assert tsym.SYMMETRY_PRIOR == jsym.SYMMETRY_PRIOR
    assert list(tsym.sym_type_of_labels([58, 59, 28, 99])) == [0, 1, 2, 0]


def test_proj_depth_map_matches_jax():
    rng = np.random.default_rng(2)
    depth = rng.integers(0, 40000, (480, 640)).astype(np.int32)
    got = tbp.proj_depth_map(_t(depth), CAM).numpy()
    want = np.asarray(jbp.proj_depth_map(jnp.asarray(depth), JCAM))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_symmetry_config_has_the_jax_fields_and_defaults():
    def fields(cls):
        return {f.name: f.default for f in
                tsym.dataclasses.fields(cls)}
    assert fields(tsym.SymmetryConfig) == fields(jsym.SymmetryConfig)


@pytest.fixture(scope="module")
def sym_frame():
    """Frame 0 of the 6-object depth scene with LABELS: a dual reflection,
    two reflections and objects without a prior or out of view."""
    scene = tsyn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                            scale_range=(0.2, 0.4), labels=LABELS)
    ds = tsyn.SyntheticDataset(scene, n_frames=12, orbit_radius=3.6,
                               height=1.7)
    i, ts, pose, depth, rgb, det = next(iter(ds.frames()))
    cam = scene.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    labels = det[:, 5].astype(int)
    st = tsym.sym_type_of_labels(labels)
    assert (st == 1).any() and (st == 2).any() and (st == 0).any()
    return dict(depth=depth, pose=pose.astype(np.float32), cam=cam,
                jcam=jcam, bboxes=det[:, 1:5].astype(np.float32),
                labels=labels, st=st,
                plane=np.array([0.0, 0.0, 1.0, 0.0], np.float32))


@pytest.mark.parametrize("analytic", [
    True, pytest.param(False, marks=pytest.mark.xfail(strict=False, reason=(
        "fault logged in ROADMAP.md queue 3: the central-difference search "
        "of the dual detection parts from JAX's in the first LM step "
        "(f32 round-off through the Cholesky solve of g g^T + lam0 I); it "
        "ends 1.8e-3 from JAX's centre, 2.0e-3 from its scales and Two, "
        "6.0e-5 from its prob")))], ids=["analytic", "central"])
def test_extract_local_ellipsoids_with_symmetry_matches_jax(sym_frame,
                                                            analytic):
    f = sym_frame
    kw = dict(cloud_capacity=2048, open_symmetry=True,
              sym_analytic_grad=analytic)
    n = len(f["bboxes"])
    flags = dict(need_single=bool((f["st"] == 1).any()),
                 need_dual=bool((f["st"] == 2).any()))
    e, p, v, (pts, m, Two) = text.extract_local_ellipsoids(
        _t(f["depth"]), _t(f["bboxes"]), torch.ones(n, dtype=torch.bool),
        _t(f["pose"]), _t(f["plane"]), f["cam"], text.ExtractorConfig(**kw),
        sym_types=_t(f["st"]), **flags)
    je, jp, jv, (_, jm, jTwo) = jext.extract_local_ellipsoids(
        jnp.asarray(f["depth"]), jnp.asarray(f["bboxes"]),
        jnp.ones(n, bool), jnp.asarray(f["pose"]), jnp.asarray(f["plane"]),
        f["jcam"], jext.ExtractorConfig(**kw),
        sym_types=jnp.asarray(f["st"]), **flags)
    ok = v.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jv))
    # a dual and a reflection among the valid ones, completed to 4S
    assert ok[f["st"] == 2].any() and ok[f["st"] == 1].any()
    assert pts.shape[1] == 4 * text.ExtractorConfig().sym_capacity
    np.testing.assert_array_equal(m.numpy()[ok], np.asarray(jm)[ok])
    e, je = e.numpy()[ok], np.asarray(je)[ok]
    np.testing.assert_allclose(e[:, :3], je[:, :3], atol=1e-3)
    np.testing.assert_allclose(np.sort(e[:, 7:]), np.sort(je[:, 7:]),
                               atol=2e-3)
    np.testing.assert_allclose(Two.numpy()[ok], np.asarray(jTwo)[ok],
                               atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    assert (p.numpy()[f["st"] == 0] == 1).all()
    assert (p.numpy()[ok & (f["st"] > 0)] < 1).any()


@pytest.fixture(scope="module")
def sym_extraction(sym_frame):
    """The port's extractor at its defaults with symmetry on, through
    make_extractor (labels -> types on the host)."""
    f = sym_frame
    ex = make_extractor(f["cam"], ExtractorConfig(open_symmetry=True),
                        device="cpu")
    out = ex(f["depth"], f["bboxes"], f["labels"], f["pose"].astype(float),
             f["plane"].astype(float))
    host = ex.fetch(out)
    assert ex.stats["sym_single"] == int((f["st"] == 1).sum())
    assert ex.stats["sym_dual"] == int((f["st"] == 2).sum())
    return host


@pytest.mark.parametrize("det", range(6))
def test_extraction_with_symmetry_matches_f64_oracle(sym_frame,
                                                     sym_extraction, det):
    """The symmetry half of the f64 oracle (tests/oracle_frontend.py: g2o's
    numeric LM over the reference's plane updates, KdTree 1-NN): centre
    and scales 2 cm, z axis 2 deg, the same validity."""
    f = sym_frame
    res = orc.estimate_local_ellipsoid(
        f["depth"].astype(np.int64), f["bboxes"][det], f["labels"][det],
        f["pose"].astype(np.float64), f["jcam"],
        f["plane"].astype(np.float64), open_symmetry=True)
    got = sym_extraction[det]
    assert bool(got[11] > 0.5) == bool(res.ok)
    if not res.ok:
        return
    np.testing.assert_allclose(got[:3], res.e_local[:3], atol=0.02)
    np.testing.assert_allclose(sorted(got[7:9]), sorted(res.e_local[7:9]),
                               atol=0.02)
    assert abs(got[9] - res.e_local[9]) < 0.02
    z = se3.quat_to_mat(torch.tensor(got[3:7], dtype=torch.float32))[:, 2]
    zo = orc.quat_to_mat(res.e_local[3:7])[:, 2]
    assert np.degrees(np.arccos(min(1.0, abs(float(z.numpy() @ zo))))) < 2.0
