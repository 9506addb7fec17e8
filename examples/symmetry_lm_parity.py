"""How far the 9-plane symmetry search of the port and of the JAX package
can agree, on the CPU (the numbers behind ROADMAP.md queue 3's symmetry
fault).

    python3 examples/symmetry_lm_parity.py

On the two clouds of tests/test_torch_symmetry.py's search test (a
symmetric cloud seen from afar, a random cloud under a near camera whose
box and depth occlude part of its mirror), for single and dual planes, with
the exact gradient and with central differences, it prints:
  * the port (frontend/symmetry.estimate_symmetry on the CPU) against JAX
    (frontend/symmetry._optimize_one_init under vmap): the largest
    difference of the 9 initial planes' parameters and costs after the LM,
    and the two winners;
  * JAX against itself with every live coordinate moved by one ulp (up,
    then down): the same differences, its own round-off;
  * the first LM step of the occluded cloud's initial planes, from JAX's
    gradient and from it one ulp away in one component: the largest
    relative change of the step, beside the step in float64.
Needs JAX and the port; runs on the CPU in a few minutes.
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import test_torch_symmetry as cases  # noqa: E402
from object_oriented_slam_tpu.ops.linalg import chol_solve_small  # noqa: E402


def first_step(g, c):
    """du of the first LM step from gradient g and cost c (JAX's
    arithmetic: H = g g^T, lam0 = 1e-5 max(diag H, 1e-6))."""
    H = jnp.outer(g, g) * 1.0
    lam0 = 1e-5 * jnp.maximum(jnp.max(jnp.diag(H)), 1e-6)
    return np.asarray(-chol_solve_small(H + lam0 * jnp.eye(len(g)), g * c))


def main():
    saved = {k: v for k, v in cases.CASES.items()}
    for analytic in (True, False):
        for dual in (False, True):
            got = cases._port_search(dual, analytic).inits.numpy()
            params, cost, prob = cases._jax_search(dual, analytic)
            spread_p = spread_c = 0.0
            for way in (np.inf, -np.inf):
                for name in ("symmetric", "occluded"):
                    pts, mask, *rest = saved[name]
                    moved = np.where(mask[:, None],
                                     np.nextafter(pts, np.float32(way)), pts)
                    cases.CASES[name] = (moved, mask, *rest)
                p2, c2, _ = cases._jax_search(dual, analytic)
                cases.CASES.update(saved)
                spread_p = max(spread_p, float(np.abs(p2 - params).max()))
                spread_c = max(spread_c, float(np.abs(c2 - cost).max()))
            for d, name in enumerate(("symmetric", "occluded")):
                print(f"{'analytic' if analytic else 'central':8s} "
                      f"{'dual' if dual else 'single':6s} {name:9s}: port - "
                      f"JAX params {np.abs(got[d, :, :3] - params[d]).max():.3g}"
                      f", costs {np.abs(got[d, :, 3] - cost[d]).max():.3g}; "
                      f"winners JAX {int(np.argmax(prob[d]))}, port "
                      f"{int(np.argmax(got[d, :, 4]))}")
            print(f"{'':16s} JAX under a 1-ulp move of its input: params "
                  f"{spread_p:.3g}, costs {spread_c:.3g}")

    # the first LM step of each initial plane of the occluded cloud, from
    # JAX's gradient and from it one ulp away in each component
    jcost, _ = cases._jax_cost("occluded", False)
    ang, dis = np.meshgrid([-1.0, 0.0, 1.0], [-1.0, 0.0, 1.0], indexing="ij")
    worst = (-1.0, None)
    for a, d in zip(ang.ravel(), dis.ravel()):
        p0 = jnp.asarray([a * np.float32(np.deg2rad(np.float32(5.0))),
                          d * np.float32(0.2)], jnp.float32)
        g, c = jax.grad(jcost)(p0), jcost(p0)
        du = first_step(g, c)
        for k in range(2):
            nudged = np.asarray(g).copy()
            nudged[k] = np.nextafter(nudged[k], np.float32(np.inf))
            du2 = first_step(jnp.asarray(nudged), c)
            change = float(np.max(np.abs(du2 - du) / np.abs(du)))
            if change > worst[0]:
                g64 = np.asarray(g, np.float64)
                lam0 = 1e-5 * max(float(np.max(g64 * g64)), 1e-6)
                exact = -np.linalg.solve(np.outer(g64, g64)
                                         + lam0 * np.eye(2), g64 * float(c))
                worst = (change, (np.asarray(p0), np.asarray(g), nudged, du,
                                  du2, exact))
    change, (p0, g, nudged, du, du2, exact) = worst
    print(f"first LM step, occluded cloud, the initial plane {p0} that moves "
          f"most: g {g} -> du {du}; g {nudged} (one ulp away) -> du {du2}, "
          f"a relative change of {change:.3g}; float64 du {exact}")


if __name__ == "__main__":
    main()
