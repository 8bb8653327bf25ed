#!/usr/bin/env python
"""Render driver CLI — the `main()` equivalent (main.cpp:187-368).

Usage:
    python render.py [config.txt] [-s savestate.npz] [-o out.ppm]
                     [--spp N] [--depth N] [--size WxH] [--estimator MODE]
                     [--scene FILE]

Reads the reference's config.txt grammar, loads the scene file, renders
progressively, writes a tone-mapped PPM and an image-state checkpoint
(resumable with -s, mirroring main.cpp:195-254, 338-346).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", nargs="?", default="config.txt")
    p.add_argument("-s", "--state", default=None, help="resume from image state")
    p.add_argument("-o", "--output", default="output.ppm")
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--size", default=None, help="WxH override")
    p.add_argument("--scene", default=None, help="scene file override")
    p.add_argument("--estimator", default="reference", choices=["reference", "physical", "mis"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tile", type=int, default=0, help="pixels per tile (0=all)")
    p.add_argument("--spp-batch", type=int, default=0,
                   help="trace B spp per dispatch (amortizes the "
                        "traversal trip count; same per-sample RNG "
                        "streams). Default 0 = auto (currently 1)")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--interactive", action="store_true",
                   help="poll stdin between passes: 'p X,Y' probes the "
                        "RUNNING render, 'pause'/'resume', 'stop' ends "
                        "early (main.cpp:41-55,151-167 analog)")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="HTTP live view of the RUNNING render (the GLFW "
                        "window's headless analog): serves an auto-"
                        "refreshing page at http://localhost:PORT/")
    p.add_argument("--live", type=int, default=0, metavar="K",
                   help="print the running image to the terminal as ANSI "
                        "half-blocks every K passes (headless live view)")
    p.add_argument("--stats", action="store_true",
                   help="print per-object-type intersect-test counts and "
                        "BVH traversal pop stats after the render (the "
                        "reference's exit printout, main.cpp:320,331-332)")
    p.add_argument("--aov", default=None,
                   help="comma list of first-hit AOVs (normal,depth,albedo,"
                        "uv) written as <output-stem>_<aov>.exr")
    p.add_argument("--probe", default=None, metavar="X,Y",
                   help="print pixel (x, y) accumulated radiance after the "
                        "render (the pause-probe, main.cpp:151-167)")
    p.add_argument("--accel", default=None,
                   choices=["auto", "none", "bvh", "bvh4", "bvh4q", "binned",
                            "hybrid", "grid"],
                   help="triangle accel backend (default: from config)")
    p.add_argument("--sampler", default=None,
                   choices=["rng", "regular", "multijittered", "hammersley"],
                   help="film-jitter sample generator: counter RNG "
                        "(default) or a table sampler built from the "
                        "config's num_samples x num_sample_sets "
                        "(config.h:37-40, sampling.cpp:514-544)")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from craytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from craytracer_tpu.integrator import RenderConfig, Renderer
    from craytracer_tpu.io.config import ConfigParams, parse_config
    from craytracer_tpu.io.image import write_ppm
    from craytracer_tpu.io.imagestate import load_image_state, save_image_state
    from craytracer_tpu.io.scenefile import load_scene_file

    cfg = parse_config(args.config) if os.path.exists(args.config) else ConfigParams()
    scene_file = args.scene or cfg.scene_file
    if not os.path.exists(scene_file):
        for d in (os.path.dirname(os.path.abspath(args.config)),
                  os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "scenes")):
            cand = os.path.join(d, scene_file)
            if os.path.exists(cand):
                scene_file = cand
                break
    if not os.path.exists(scene_file):
        print(f"scene file not found: {scene_file}", file=sys.stderr)
        return 1

    accel_map = {"GRID": "grid", "BVH": "bvh", "BVH4": "bvh4", "NONE": "none"}
    accel = args.accel or accel_map.get(cfg.accel_struct, "auto")
    if accel == "grid" and args.accel is None and not args.cpu:
        # The reference SHIPS accel_struct GRID (config.txt), a CPU-era
        # default: the batched DDA walk trails the BVH4 traversal on an
        # accelerator. Config-driven GRID upgrades to bvh4 there; grid
        # remains available as a correctness/parity backend via an
        # explicit --accel grid.
        print("config accel GRID is a CPU-era default; using bvh4 on the "
              "accelerator (pass --accel grid to force)", file=sys.stderr)
        accel = "bvh4"
    scene, camera, film = load_scene_file(scene_file, accel=accel)

    if cfg.caustic_map:
        # calcCausticProjMap analog (main.cpp:213-216, projmap.h:187-220):
        # per point light, the lat-long visibility mask of caustic-object
        # footprints and its coverage fraction (-> proj_coverage).
        import numpy as np

        from craytracer_tpu.scene import types as T
        from craytracer_tpu.utils.projmap import (build_proj_map,
                                                  caustic_bounding_spheres)

        spheres = caustic_bounding_spheres(scene)
        ltype = np.asarray(scene.lights.light_type)
        lpos = np.asarray(scene.lights.p0)
        for li in np.nonzero(ltype == T.LIGHT_POINT)[0]:
            _, cov = build_proj_map(lpos[li], spheres)
            print(f"proj map: point light {int(li)} at {lpos[li].tolist()} "
                  f"coverage {cov:.4f} ({spheres.shape[0]} caustic objects)")
    if args.size:
        import jax.numpy as jnp

        w, h = (int(x) for x in args.size.lower().split("x"))
        film = film.replace(width=w, height=h)

    rc = RenderConfig(
        num_samples=args.spp if args.spp is not None else max(cfg.num_samples, 1),
        max_depth=args.depth if args.depth is not None else max(cfg.max_depth, 1),
        seed=args.seed,
        tile_pixels=args.tile,
        spp_batch=max(0, args.spp_batch),
        ansi_every=max(0, args.live),
        serve_port=max(0, args.serve),
        interactive=args.interactive,
        log_every=1,
        estimator=args.estimator,
        trace_type=cfg.trace_type if cfg.trace_type in ("PATHTRACE", "WHITTED", "RAYCAST") else "PATHTRACE",
    )
    if args.sampler and args.sampler != "rng":
        from craytracer_tpu.sampling.tables import make_sample_table

        rc.sampler = make_sample_table(args.sampler, rc.num_samples,
                                       max(cfg.num_sample_sets, 1),
                                       seed=args.seed)
        print(f"sampler={args.sampler} ({rc.num_samples} samples x "
              f"{max(cfg.num_sample_sets, 1)} sets)")
    print(f"scene={scene_file} {film.width}x{film.height} spp={rc.num_samples} "
          f"depth={rc.max_depth} estimator={rc.estimator}")

    if args.state and os.path.exists(args.state if args.state.endswith(".npz")
                                     else args.state + ".npz"):
        accum, spp, seed = load_image_state(args.state)
        # Resume with the CHECKPOINTED seed: continuing a different RNG
        # stream into the same accumulator silently breaks the
        # bit-identical resume guarantee. An explicitly different --seed
        # is an error, not a preference.
        if args.seed != 0 and args.seed != seed:
            print(f"error: --seed {args.seed} differs from the checkpoint's "
                  f"seed {seed}; resume must continue the same stream",
                  file=sys.stderr)
            return 1
        import dataclasses

        rc = dataclasses.replace(rc, seed=seed)
        r = Renderer(scene, camera, film, rc)
        r.resume_from(accum, spp)
        print(f"resumed from {args.state}: {spp} spp done (seed {seed})")
    else:
        r = Renderer(scene, camera, film, rc)

    t0 = time.time()
    img = r.render()
    dt = time.time() - t0
    n_rays = film.num_pixels * rc.num_samples
    print(f"rendered {rc.num_samples} passes in {dt:.2f}s "
          f"({n_rays / dt / 1e6:.2f}M primary rays/s)")

    if args.stats:
        from craytracer_tpu.camera import generate_rays
        from craytracer_tpu.sampling import uniforms
        from craytracer_tpu.utils.stats import format_stats, intersect_stats
        import jax.numpy as jnp

        ids = jnp.arange(film.num_pixels, dtype=jnp.int32)
        jit0 = uniforms(rc.seed, ids, jnp.zeros_like(ids), 0, 2, 0)
        o0, d0 = generate_rays(camera, film, ids, jit0)
        print(format_stats(intersect_stats(scene, o0, d0)))

    if args.probe:
        # click-to-probe analog (main.cpp:151-167): raw accumulated
        # radiance and the running mean at one pixel
        import numpy as np

        x, y = (int(v) for v in args.probe.split(","))
        idx = y * film.width + x
        acc = np.asarray(r.accum)[idx]
        mean = acc / max(r.spp_done, 1)
        print(f"probe ({x},{y}): accum={acc.tolist()} mean={mean.tolist()} "
              f"spp={r.spp_done}")

    if args.aov:
        import numpy as np

        from craytracer_tpu.integrator.aov import AOV_NAMES, render_aovs
        from craytracer_tpu.io.exr import write_exr

        aovs = render_aovs(scene, camera, film)
        stem = os.path.splitext(args.output)[0]
        for name in args.aov.split(","):
            if name not in AOV_NAMES:
                print(f"unknown AOV {name!r} (have {AOV_NAMES})", file=sys.stderr)
                continue
            path = f"{stem}_{name}.exr"
            write_exr(path, np.asarray(aovs[name]).reshape(
                film.height, film.width, 3))
            print(f"wrote {path}")

    if args.output.lower().endswith(".exr"):
        # linear HDR radiance mean (no tone map), FLOAT RGB scanline EXR
        import numpy as np

        from craytracer_tpu.io.exr import write_exr

        mean = np.asarray(r.accum).reshape(film.height, film.width, 3)
        write_exr(args.output, mean / max(r.spp_done, 1))
    else:
        write_ppm(args.output, img)
    print(f"wrote {args.output}")
    state_path = os.path.splitext(args.output)[0] + "_state"
    import numpy as np

    save_image_state(state_path, np.asarray(r.accum), r.spp_done, rc.seed)
    print(f"wrote {state_path}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
