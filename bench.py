"""Benchmark: forward path-tracing throughput on the Cornell box.

Prints ONE JSON line with the device it ran on, rays/s and wall seconds
per spp-pass. The scene is the in-repo Cornell variant
(scenes/parity_cornell.txt) through the production pipeline: parser ->
scene build -> path choice (production_fast_shade) -> wavefront
integrator or whole-pass megakernel. Rays/s counts every traced ray:
closest-hit rays of live lanes at each bounce plus NEE shadow rays,
counted on the device.

Needs a GPU: on any other backend it exits non-zero without a result.

Usage: python bench.py [--scene FILE] [--size N] [--depth D]
                       [--profile DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SPP_PER_CALL = 16  # spp-passes per timed call, looped on the device
REPS = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scenes",
        "parity_cornell.txt"))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--profile", default="",
                    help="capture a JAX profiler trace into this directory")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, found {dev.platform}", file=sys.stderr)
        return 1

    from craytracer_tpu.integrator.pallas_shade import (fused_pass,
                                                        production_fast_shade)
    from craytracer_tpu.integrator.wavefront import trace_paths
    from craytracer_tpu.io.scenefile import load_scene_file
    from craytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    scene, camera, film = load_scene_file(args.scene)
    film = film.replace(width=args.size, height=args.size)
    fast = production_fast_shade(scene, camera, film)
    n = film.num_pixels
    pixel_ids = jnp.arange(n, dtype=jnp.int32)
    depth = args.depth

    def one_pass(spp):
        if fast == "bounce":
            L, _, m = fused_pass(scene, None, None, pixel_ids, spp, 0, depth,
                                 raygen="strat", camera=camera, film=film,
                                 width=int(film.width))
        else:
            from craytracer_tpu.camera import generate_rays
            from craytracer_tpu.sampling.multijitter import stratified_jitter

            jitter = stratified_jitter(0, pixel_ids, spp)
            o, d = generate_rays(camera, film, pixel_ids, jitter)
            L, _, m = trace_paths(scene, o, d, 0, pixel_ids, spp, depth,
                                  with_metrics=True)
        return L, m["rays"] + m["shadow_rays"]

    @jax.jit
    def many_passes(spp0):
        def body(s, carry):
            acc, rays = carry
            L, r = one_pass(spp0 + s)
            return acc + L, rays + r

        init = (jnp.zeros((n, 3), jnp.float32), jnp.zeros((), jnp.int32))
        acc, rays = jax.lax.fori_loop(0, SPP_PER_CALL, body, init)
        return acc.mean(), rays

    t0 = time.perf_counter()
    jax.block_until_ready(many_passes(0))
    compile_s = time.perf_counter() - t0
    if args.profile:
        with jax.profiler.trace(args.profile):
            jax.block_until_ready(many_passes(SPP_PER_CALL))
    times = []
    rays = 0
    for rep in range(REPS):
        t0 = time.perf_counter()
        _, r = jax.block_until_ready(many_passes((rep + 2) * SPP_PER_CALL))
        times.append(time.perf_counter() - t0)
        rays = int(r)
    med = sorted(times)[REPS // 2]
    print(json.dumps({
        "metric": "cornell_fwd_rays_per_sec",
        "value": rays / med,
        "unit": "rays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "path": "megakernel" if fast == "bounce" else "xla",
        "scene": os.path.basename(args.scene),
        "size": args.size, "depth": depth,
        "wall_s_per_spp_pass": med / SPP_PER_CALL,
        "compile_s": compile_s,
        "timing": f"median of {REPS} calls of {SPP_PER_CALL} spp-passes",
        "rays_per_sec_min": rays / max(times),
        "rays_per_sec_max": rays / min(times),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
