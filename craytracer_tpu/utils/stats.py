"""Intersect diagnostics: the batched analog of the reference's printed
instrumentation — per-object-type intersection-test counters
(intersect.h:363-364, shapes/shapes.cpp:3-6, printed main.cpp:320,331-332)
and the traversal-time accumulator (MEASURE_TRAVERSAL_TIME,
intersect.h:11-13). In a batched traversal, wall time per lane is not
observable, so the
traversal breakdown reports per-lane NODE-VISIT counts (pops) instead —
the quantity the while-loop trip count (and hence wall time) is the max
of. Diagnostics-only path: the production traversal carries no counter."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from craytracer_tpu.ops.intersect import _GROUPS, _group_size


def intersect_stats(scene, o, d) -> dict:
    """Per-group brute-force test counts for one ray batch, plus BVH
    traversal pop statistics (mean / p99 / max over lanes) when the scene
    uses the bvh4 backend.

    Brute-force groups cost exactly n_rays * group_size tests per batch
    (every lane tests every primitive of the group); accelerated groups
    report traversal pops and inline leaf tests instead."""
    n = o.shape[0]
    out: dict = {"rays": n, "groups": {}}
    for gid, name, _, _ in _GROUPS:
        sz = _group_size(scene, name)
        if sz == 0:
            continue
        accelerated = ((name == "triangles" and scene.accel != "none")
                       or (name == "spheres" and scene.sph_bvh is not None))
        if not accelerated:
            out["groups"][name] = {"prims": sz, "tests": n * sz}
        else:
            out["groups"][name] = {"prims": sz, "tests": "accelerated"}

    if scene.accel == "bvh4" and scene.tri_bvh is not None:
        from craytracer_tpu.accel.bvh4 import WIDTH, bvh4_closest_hit_stats

        _, _, pops = bvh4_closest_hit_stats(scene.tri_bvh, o, d)
        pops = np.asarray(pops)
        k_slots = WIDTH * scene.tri_bvh.leaf_size
        out["bvh4"] = {
            "nodes": int(scene.tri_bvh.fat.shape[0]),
            "pops_mean": float(pops.mean()),
            "pops_p99": float(np.percentile(pops, 99)),
            "pops_max": int(pops.max()),
            # every pop tests k_slots inline triangles unconditionally
            "tri_tests": int(pops.sum()) * k_slots,
        }
    return out


def format_stats(stats: dict) -> str:
    """Reference-style printout (main.cpp:320,331-332)."""
    lines = [f"rays: {stats['rays']}"]
    for name, g in stats["groups"].items():
        lines.append(f"  {name:10s} prims {g['prims']:8d}  tests {g['tests']}")
    if "bvh4" in stats:
        b = stats["bvh4"]
        lines.append(
            f"  bvh4: {b['nodes']} nodes, pops mean {b['pops_mean']:.1f} "
            f"p99 {b['pops_p99']:.0f} max {b['pops_max']} "
            f"(tri tests {b['tri_tests']})")
    return "\n".join(lines)
