#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU (or four, with --four).

Drives the main path once through the entry points a user calls
(load_scene_file -> Renderer, and render.py), with every kernel compiled
for the card, and checks what comes out against the repo's references.
Phases, in order; each prints its own lines and any failure exits
non-zero:

  1 device     JAX's device, the card's name and power limit, whether the
               native SAH builder loaded
  2 golden     the six reference goldens at the parity test's settings and
               thresholds, on the production path choice, no precision pin
  3 cornell    Cornell 512^2, depth 5, 16 spp through the Renderer (the
               scene file and the hand-built variant), render.py once, and
               take_rows' gather against the one-hot matmul it replaced
  4 megakernel the whole-pass kernel against the XLA wavefront on
               parity_cornell and parity_mix (times and agreement)
  5 mesh       a 327,680-triangle mesh at 1920x1080, 1 spp, depth 4,
               through the XLA bvh4 traversal, set-up times apart
  6 gpu tests  the tests marked `gpu`, in this process

With --four only the four-card phase runs: a 4-way ray-sharded render
and inverse-rendering step, and a 2x2 geometry-sharded step, each against
its unsharded counterpart.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Only main() demands a GPU; the phase functions take their sizes as
arguments so the CPU tests can run them at tiny sizes.

Usage: python chip_smoke.py [--four] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(REPO, "scenes")
GOLDEN_SCENES = ("cornell", "mix", "prims", "mesh", "mesh_mid", "textured")


def card_info() -> str:
    """`name, power.limit` of the card, read by nvidia-smi in a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _median_time(fn, reps=5):
    """Median wall seconds of `reps` calls, each ended by
    block_until_ready."""
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def phase_device() -> dict:
    import jax

    from craytracer_tpu import native

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "native_sah": native.available()}
    print(f"[1 device] platform={dev.platform} kind={dev.device_kind} "
          f"count={info['count']}")
    print(f"[1 device] native SAH builder loaded: {info['native_sah']}"
          + ("" if info["native_sah"]
             else " (numpy median-split fallback in use)"))
    return info


def phase_golden(names=GOLDEN_SCENES) -> list:
    from craytracer_tpu.utils import parity

    results = []
    for name in names:
        t0 = time.perf_counter()
        r = parity.compare(name)
        r["seconds"] = time.perf_counter() - t0
        print(f"[2 golden] {name}: mean ours {r['mean_ours']:.5f} ref "
              f"{r['mean_ref']:.5f} block dev max {r['block_dev_max']:.5f} "
              f"blocks within {parity.BLOCK_TIGHT} {r['blocks_tight']:.3f} "
              f"ok={r['ok']} ({r['seconds']:.1f} s)")
        results.append(r)
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"golden parity failed for {bad}")
    return results


def _pass_rays(scene, camera, film, depth, fast) -> int:
    """Rays (closest-hit of live lanes + shadow) of one spp-pass, from the
    on-device counters of the same path the Renderer takes."""
    import jax.numpy as jnp

    from craytracer_tpu.camera import generate_rays
    from craytracer_tpu.integrator.pallas_shade import fused_pass
    from craytracer_tpu.integrator.wavefront import (CAMERA_BOUNCE,
                                                     trace_paths)
    from craytracer_tpu.sampling import uniforms
    from craytracer_tpu.sampling.multijitter import stratified_jitter

    pix = jnp.arange(film.num_pixels, dtype=jnp.int32)
    if fast == "bounce":
        _, _, m = fused_pass(scene, None, None, pix, 0, 0, depth,
                             raygen="strat", camera=camera, film=film,
                             width=int(film.width))
    else:
        jitter = stratified_jitter(0, pix, 0)
        lens_u = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 2)
        o, d = generate_rays(camera, film, pix, jitter, lens_u)
        _, _, m = trace_paths(scene, o, d, 0, pix, 0, depth,
                              with_metrics=True)
    return int(m["rays"]) + int(m["shadow_rays"])


def render_through_renderer(label, scene, camera, film, depth, spp) -> dict:
    """Renderer.render() of 1 spp (compile + first pass: set-up time),
    then one render() of `spp` passes, each pass ended by the sync of the
    Renderer's per-pass image callback; reports the median pass interval
    and, apart, the wall of a whole 1-spp render() call (per-call host
    work: path choice, pixel order, final tone map)."""
    import jax
    import numpy as np

    from craytracer_tpu.integrator import Renderer, RenderConfig
    from craytracer_tpu.integrator.pallas_shade import production_fast_shade

    fast = production_fast_shade(scene, camera, film)

    def renderer(n):
        return Renderer(scene, camera, film,
                        RenderConfig(num_samples=n, max_depth=depth,
                                     nan_log_path=""))

    r = renderer(1)
    t0 = time.perf_counter()
    r.render()
    jax.block_until_ready(r.accum)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.render()
    jax.block_until_ready(r.accum)
    call_s = time.perf_counter() - t0
    r = renderer(spp)
    stamps = [time.perf_counter()]
    r.render(progress_cb=lambda s, img: stamps.append(time.perf_counter()))
    times = np.diff(stamps)
    wall = float(np.median(times))
    rays = _pass_rays(scene, camera, film, depth, fast)
    img = r.raw_mean()
    if not (np.isfinite(img).all() and img.mean() > 0.0):
        raise AssertionError(f"{label}: image not finite or black")
    out = {"label": label, "path": "megakernel" if fast else "xla",
           "size": f"{film.width}x{film.height}", "depth": depth,
           "spp": r.spp_done, "compile_s": compile_s,
           "wall_s_per_pass": wall, "timed_passes": len(times),
           "render_call_1spp_s": call_s,
           "rays_per_pass": rays, "rays_per_s": rays / wall,
           "image_mean": float(img.mean()), "peak_bytes": _peak_bytes()}
    print(f"[3 cornell] {label} {out['size']} depth {depth} {r.spp_done} spp "
          f"path={out['path']} compile+first pass {compile_s:.2f} s, wall "
          f"per spp-pass {wall * 1e3:.3f} ms (median of {len(times)}), "
          f"{rays} rays/pass -> {out['rays_per_s'] / 1e6:.1f} M rays/s, "
          f"a whole 1-spp render() call {call_s * 1e3:.3f} ms, "
          f"peak_bytes_in_use {out['peak_bytes']}")
    return out


def _onehot_rows(idx, packed):
    """The one-hot [N, M] @ [M, K] form of a row gather (float32,
    HIGHEST), which take_rows used before the GPU port; kept here only
    as the comparison for the timing below."""
    import jax
    import jax.numpy as jnp

    onehot = idx[:, None] == jnp.arange(packed.shape[0], dtype=idx.dtype)
    return jnp.matmul(onehot.astype(jnp.float32), packed,
                      precision=jax.lax.Precision.HIGHEST)


def time_take_rows(n_lanes: int, table_rows=(20, 1024)) -> list:
    """take_rows (one packed jnp.take) against the one-hot matmul at
    `n_lanes` lookups, on tables of 32 float/int/bool columns (about the
    width of the triangle fill's)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from craytracer_tpu.ops.gather import take_rows

    out = []
    for m in table_rows:
        keys = jax.random.split(jax.random.PRNGKey(m), 3)
        idx = jax.random.randint(keys[0], (n_lanes,), 0, m, jnp.int32)
        tabs = (jax.random.normal(keys[1], (m, 9, 3)),
                jax.random.normal(keys[2], (m, 3)),
                jnp.arange(m, dtype=jnp.int32), jnp.arange(m) % 2 == 0)
        packed = jnp.concatenate(
            [t.reshape(m, -1).astype(jnp.float32) for t in tabs], axis=1)
        f_take = jax.jit(take_rows)
        f_hot = jax.jit(_onehot_rows)
        got = f_take(idx, tabs)
        ref = f_hot(idx, packed)
        flat = jnp.concatenate([g.reshape(n_lanes, -1).astype(jnp.float32)
                                for g in got], axis=1)
        if not np.array_equal(np.asarray(flat), np.asarray(ref)):
            raise AssertionError("take_rows differs from the one-hot gather")
        t_take = _median_time(lambda: f_take(idx, tabs))
        t_hot = _median_time(lambda: f_hot(idx, packed))
        print(f"[3 cornell] take_rows {n_lanes} lanes x {m} rows: "
              f"jnp.take {t_take * 1e6:.1f} us, one-hot matmul "
              f"{t_hot * 1e6:.1f} us")
        out.append({"lanes": n_lanes, "rows": m, "take_s": t_take,
                    "onehot_s": t_hot})
    return out


def phase_cornell(size=512, depth=5, spp=16, render_spp=4,
                  out_dir=None) -> dict:
    import numpy as np

    from __graft_entry__ import _cornell
    from craytracer_tpu.io.image import read_ppm
    from craytracer_tpu.io.scenefile import load_scene_file

    scene, cam, film = load_scene_file(
        os.path.join(SCENES, "parity_cornell.txt"))
    film = film.replace(width=size, height=size)
    res = {"scene_file": render_through_renderer(
        "parity_cornell.txt", scene, cam, film, depth, spp)}
    scene, cam, film = _cornell(size, size)
    res["hand_built"] = render_through_renderer(
        "__graft_entry__._cornell", scene, cam, film, depth, spp)

    import render

    out_dir = out_dir or os.path.join(REPO, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    ppm = os.path.join(out_dir, "cornell.ppm")
    t0 = time.perf_counter()
    rc = render.main(["--scene", os.path.join(SCENES, "parity_cornell.txt"),
                      "--size", f"{size}x{size}", "--spp", str(render_spp),
                      "-o", ppm])
    if rc != 0:
        raise AssertionError(f"render.py exited {rc}")
    img = read_ppm(ppm).astype(np.float32)
    if not (np.isfinite(img).all() and img.mean() > 0.0):
        raise AssertionError("render.py wrote a black or non-finite image")
    res["render_py"] = {"seconds": time.perf_counter() - t0,
                        "ppm_mean": float(img.mean())}
    print(f"[3 cornell] render.py {size}x{size} {render_spp} spp -> {ppm}: "
          f"mean {img.mean():.2f}/255 ({res['render_py']['seconds']:.1f} s "
          f"incl. compile)")
    res["take_rows"] = time_take_rows(size * size)
    return res


def megakernel_vs_xla(name, size=512, depth=5, reps=5,
                      interpret=False) -> dict:
    """fused_pass against the plain XLA trace_paths on the same camera
    rays, timed in turns (XLA, kernel, kernel, XLA, ...). Asserts the
    agreement the compiled kernel is held to: >= 99.5% of lanes agree on
    L to 1e-4*max(1,|L|) (Triton contracts to FMA and has its own
    transcendentals, so a few lanes take another RR/BSDF branch), ray and
    shadow-ray counters within 0.5%, image means within 0.2%."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from craytracer_tpu.camera import generate_rays
    from craytracer_tpu.integrator.pallas_shade import (LANES_PER_WARP,
                                                        PASS_BLOCK,
                                                        fused_pass)
    from craytracer_tpu.integrator.wavefront import (CAMERA_BOUNCE,
                                                     trace_paths)
    from craytracer_tpu.io.scenefile import load_scene_file
    from craytracer_tpu.sampling import uniforms

    scene, cam, film = load_scene_file(
        os.path.join(SCENES, f"parity_{name}.txt"))
    film = film.replace(width=size, height=size)
    pix = jnp.arange(film.num_pixels, dtype=jnp.int32)
    o, d = generate_rays(cam, film, pix,
                         uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0))
    xla = jax.jit(lambda s, o, d: trace_paths(s, o, d, 0, pix, 0, depth,
                                              with_metrics=True))
    ker = jax.jit(lambda s, o, d: fused_pass(s, o, d, pix, 0, 0, depth,
                                             interpret=interpret))
    t0 = time.perf_counter()
    Lx, gx, mx = jax.block_until_ready(xla(scene, o, d))
    compile_xla = time.perf_counter() - t0
    t0 = time.perf_counter()
    Lk, gk, mk = jax.block_until_ready(ker(scene, o, d))
    compile_ker = time.perf_counter() - t0
    tx, tk = [], []
    for i in range(reps):
        order = ((xla, tx), (ker, tk)) if i % 2 == 0 else ((ker, tk),
                                                          (xla, tx))
        for fn, acc in order:
            t0 = time.perf_counter()
            jax.block_until_ready(fn(scene, o, d))
            acc.append(time.perf_counter() - t0)
    t_xla = sorted(tx)[reps // 2]
    t_ker = sorted(tk)[reps // 2]
    Lx, Lk = np.asarray(Lx), np.asarray(Lk)
    lanes = float((np.abs(Lk - Lx) <= 1e-4 * np.maximum(1.0, np.abs(Lx)))
                  .all(axis=1).mean())
    rays_x = int(mx["rays"]) + int(mx["shadow_rays"])
    rays_k = int(mk["rays"]) + int(mk["shadow_rays"])
    dr = abs(int(mk["rays"]) - int(mx["rays"])) / max(int(mx["rays"]), 1)
    ds = (abs(int(mk["shadow_rays"]) - int(mx["shadow_rays"]))
          / max(int(mx["shadow_rays"]), 1))
    dm = abs(float(Lk.mean()) - float(Lx.mean())) / max(
        abs(float(Lx.mean())), 1e-12)
    r = {"scene": name, "size": size, "depth": depth,
         "block": PASS_BLOCK, "warps": PASS_BLOCK // LANES_PER_WARP,
         "compile_xla_s": compile_xla, "compile_kernel_s": compile_ker,
         "xla_s": t_xla, "kernel_s": t_ker,
         "xla_rays_per_s": rays_x / t_xla, "kernel_rays_per_s": rays_k / t_ker,
         "lanes_agree": lanes, "rays_rel_diff": dr, "shadow_rel_diff": ds,
         "mean_rel_diff": dm, "speedup": t_xla / t_ker}
    print(f"[4 megakernel] {name} {size}^2 depth {depth} (block {PASS_BLOCK}"
          f" lanes, {r['warps']} warps): XLA {t_xla * 1e3:.3f} ms "
          f"({r['xla_rays_per_s'] / 1e6:.1f} M rays/s), kernel "
          f"{t_ker * 1e3:.3f} ms ({r['kernel_rays_per_s'] / 1e6:.1f} M "
          f"rays/s), speedup {r['speedup']:.2f}x; compile XLA "
          f"{compile_xla:.1f} s kernel {compile_ker:.1f} s")
    print(f"[4 megakernel] {name} agreement: lanes {lanes:.5f} (>= 0.995), "
          f"rays {dr:.2e} shadow {ds:.2e} (<= 5e-3), mean {dm:.2e} "
          f"(<= 2e-3)")
    if not (lanes >= 0.995 and dr <= 5e-3 and ds <= 5e-3 and dm <= 2e-3):
        raise AssertionError(f"megakernel disagrees with XLA on {name}: {r}")
    return r


def phase_megakernel(names=("cornell", "mix"), size=512, depth=5,
                     interpret=False) -> list:
    return [megakernel_vs_xla(n, size, depth, interpret=interpret)
            for n in names]


def phase_mesh(tris=327680, width=1920, height=1080, depth=4,
               out_dir=SCENES, reps=5) -> dict:
    """The deployment-size mesh through the XLA bvh4 traversal: parse,
    build (native SAH when loaded), upload and compile reported apart
    from the timed 1-spp passes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "refbuild"))
    from make_bench_mesh_scene import write_scene

    from craytracer_tpu.camera import generate_rays
    from craytracer_tpu.integrator.wavefront import (CAMERA_BOUNCE,
                                                     render_sample,
                                                     trace_paths)
    from craytracer_tpu.io.scenefile import parse_scene_file
    from craytracer_tpu.sampling import uniforms
    from craytracer_tpu.sampling.multijitter import stratified_jitter

    path = write_scene(tris=tris, out_dir=out_dir)
    t0 = time.perf_counter()
    builder, cam, film = parse_scene_file(path)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = builder.build(accel="bvh4")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = jax.block_until_ready(jax.device_put(scene))
    upload_s = time.perf_counter() - t0
    film = film.replace(width=width, height=height)
    n_tris = int(scene.triangles.mat_id.shape[0])
    pix = jnp.arange(film.num_pixels, dtype=jnp.int32)

    step = jax.jit(lambda s, c, spp: render_sample(s, c, film, pix, 0, spp,
                                                   depth))
    t0 = time.perf_counter()
    img = jax.block_until_ready(step(scene, cam, 0))
    compile_s = time.perf_counter() - t0
    if not (np.isfinite(np.asarray(img)).all() and float(img.mean()) > 0):
        raise AssertionError("mesh render not finite or black")
    spp_i = iter(range(1, reps + 1))
    wall = _median_time(lambda: step(scene, cam, next(spp_i)), reps)
    # rays of one pass (same rays as render_sample's) from the counters
    o, d = generate_rays(cam, film, pix, stratified_jitter(0, pix, 0),
                         uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 2))
    _, _, m = jax.jit(lambda s, o, d: trace_paths(
        s, o, d, 0, pix, 0, depth, with_metrics=True))(scene, o, d)
    rays = int(m["rays"]) + int(m["shadow_rays"])
    r = {"tris": n_tris, "size": f"{width}x{height}", "depth": depth,
         "parse_s": parse_s, "build_s": build_s, "upload_s": upload_s,
         "compile_s": compile_s, "wall_s_per_pass": wall,
         "rays_per_pass": rays, "rays_per_s": rays / wall,
         "peak_bytes": _peak_bytes()}
    print(f"[5 mesh] {n_tris} tris bvh4 {width}x{height} 1 spp depth "
          f"{depth}: parse {parse_s:.2f} s, build {build_s:.2f} s, upload "
          f"{upload_s:.2f} s, compile+first pass {compile_s:.2f} s")
    print(f"[5 mesh] wall per pass {wall * 1e3:.2f} ms (median of {reps}), "
          f"{rays} rays/pass -> {r['rays_per_s'] / 1e6:.2f} M rays/s, "
          f"peak_bytes_in_use {r['peak_bytes']}")
    return r


class _Outcomes:
    """pytest plugin: counts test outcomes of the in-process run."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome,
                                                          0) + 1


def phase_gpu_tests(select="gpu") -> dict:
    """Run the tests marked `gpu` in THIS process (a child would find the
    card's memory taken). Every selected test must pass; a skip fails."""
    import pytest

    rec = _Outcomes()
    rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                      "-m", select, os.path.join(REPO, "tests")],
                     plugins=[rec])
    print(f"[6 gpu tests] pytest exit {int(rc)}, outcomes {rec.counts}")
    if int(rc) != 0 or rec.counts.get("passed", 0) == 0 or set(
            rec.counts) != {"passed"}:
        raise AssertionError(f"gpu tests did not all pass: {rec.counts}")
    return rec.counts


def phase_four(size=512, train_size=128, depth=5, train_depth=3,
               n_dev=4) -> dict:
    """Four devices: a 4-way ray-sharded render pass against the one-card
    image (RNG keyed by pixel: agreement to 1e-6), a 4-way sharded
    inverse-rendering step against the unsharded jax.grad (1e-5
    relative), and a 2x2 (rays, geom) geometry-sharded step against the
    unsharded step. Checks that each sharded result lives on all
    devices."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _icosphere_scene
    from craytracer_tpu.integrator.pallas_shade import production_fast_shade
    from craytracer_tpu.integrator.wavefront import render_sample
    from craytracer_tpu.io.scenefile import load_scene_file
    from craytracer_tpu.parallel import (geom_sharded_train_step, make_mesh,
                                         make_geom_mesh, shard_scene_geometry,
                                         sharded_render_pass,
                                         sharded_train_step)
    from craytracer_tpu.parallel.sharded import _render_loss

    devs = jax.devices()[:n_dev]
    if len(devs) < n_dev:
        raise AssertionError(f"need {n_dev} devices, have {len(devs)}")
    res = {}

    def on_all(x):
        return ({s.device for s in x.addressable_shards} >= set(devs))

    def rel_close(a, b, rtol):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return bool(np.all(np.abs(a - b)
                           <= rtol * np.maximum(1.0, np.abs(b))))

    # ---- 4-way ray-sharded forward pass vs the one-card image
    scene, cam, film = load_scene_file(
        os.path.join(SCENES, "parity_cornell.txt"))
    film = film.replace(width=size, height=size)
    fast = production_fast_shade(scene, cam, film)
    pix = jnp.arange(film.num_pixels, dtype=jnp.int32)
    mesh = make_mesh(n_dev)
    fwd = sharded_render_pass(mesh, max_depth=depth, fast_shade=fast)
    img4 = jax.block_until_ready(fwd(scene, cam, film, pix, 0, 0))
    # same operands as the sharded pass (film, seed and spp traced, not
    # folded in as constants), so both evaluate the same device code
    one = jax.jit(lambda s, c, f, p, seed, spp: render_sample(
        s, c, f, p, seed, spp, depth, fast_shade=fast))
    img1 = jax.block_until_ready(one(*jax.device_put(
        (scene, cam, film, pix, 0, 0), devs[0])))
    diff = float(np.max(np.abs(np.asarray(img4) - np.asarray(img1))))
    ok = rel_close(img4, img1, 1e-6) and on_all(img4)
    print(f"[four] {n_dev}-way ray-sharded render {size}^2 depth {depth} "
          f"path={'megakernel' if fast else 'xla'}: max |diff| vs one card "
          f"{diff:.3e}, on all devices {on_all(img4)}, ok={ok}")
    res["render"] = {"max_abs_diff": diff, "ok": ok}

    # ---- 4-way sharded inverse-rendering step vs unsharded jax.grad
    film_t = film.replace(width=train_size, height=train_size)
    pix_t = jnp.arange(film_t.num_pixels, dtype=jnp.int32)
    target = jnp.full((film_t.num_pixels, 3), 0.25, jnp.float32)
    step = sharded_train_step(mesh, max_depth=train_depth)
    loss4, g4 = step(scene, cam, film_t, pix_t, 0, 0, target)
    loss1, g1 = jax.jit(jax.value_and_grad(
        lambda s: _render_loss(s, cam, film_t, pix_t, 0, 0, target,
                               train_depth), allow_int=True))(scene)
    gc4, gc1 = g4.materials.color, g1.materials.color
    ok_t = (rel_close(loss4, loss1, 1e-5)
            and rel_close(gc4, gc1, 1e-5 * float(np.abs(gc1).max() or 1.0)))
    print(f"[four] {n_dev}-way sharded train step {train_size}^2 depth "
          f"{train_depth}: loss {float(loss4):.8f} vs {float(loss1):.8f}, "
          f"max |dL/dcolor diff| "
          f"{float(np.max(np.abs(np.asarray(gc4) - np.asarray(gc1)))):.3e},"
          f" ok={ok_t}")
    res["train"] = {"loss": float(loss4), "loss_ref": float(loss1),
                    "ok": ok_t}

    # ---- 2x2 (rays, geom) geometry-sharded step vs unsharded step
    scene2, cam2, film2 = _icosphere_scene(8 * 2, 8)
    film2 = film2.replace(width=train_size, height=train_size // 2)
    stacked, bases = shard_scene_geometry(scene2, 2, accel="bvh4")
    gmesh = make_geom_mesh(n_dev // 2, 2)
    gstep = geom_sharded_train_step(gmesh, max_depth=train_depth)
    pix2 = jnp.arange(film2.num_pixels, dtype=jnp.int32)
    target2 = jnp.full((film2.num_pixels, 3), 0.25, jnp.float32)
    gloss, ggrads = gstep(stacked, bases, cam2, film2, pix2, jnp.int32(0),
                          jnp.int32(0), target2)
    uloss, ugrads = jax.jit(jax.value_and_grad(
        lambda s: _render_loss(s, cam2, film2, pix2, 0, 0, target2,
                               train_depth), allow_int=True))(scene2)
    # each geom member holds identical replicated material grads
    gcol = np.asarray(ggrads.materials.color)[0]
    ucol = np.asarray(ugrads.materials.color)
    ok_g = (rel_close(gloss, uloss, 1e-5)
            and rel_close(gcol, ucol, 1e-5 * float(np.abs(ucol).max() or 1.0))
            and on_all(ggrads.materials.color))
    print(f"[four] 2x2 geometry-sharded train step: loss {float(gloss):.8f} "
          f"vs unsharded {float(uloss):.8f}, max |dL/dcolor diff| "
          f"{float(np.max(np.abs(gcol - ucol))):.3e}, ok={ok_g}")
    res["geom"] = {"loss": float(gloss), "loss_ref": float(uloss),
                   "ok": ok_g}
    bad = [k for k, v in res.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"four-device checks failed: {bad}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    ap.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"),
                    help="directory for the rendered image and summary")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    print(f"card: {card_info()}")
    from craytracer_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    os.makedirs(args.out, exist_ok=True)
    summary = {"card": card_info()}
    t_start = time.perf_counter()
    if args.four:
        summary["four"] = phase_four()
    else:
        summary["device"] = phase_device()
        summary["golden"] = phase_golden()
        summary["cornell"] = phase_cornell(out_dir=args.out)
        summary["megakernel"] = phase_megakernel()
        summary["mesh"] = phase_mesh()
        summary["gpu_tests"] = phase_gpu_tests()
    summary["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(args.out, "summary_four.json" if args.four
                           else "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(f"card: {summary['card']}; total {summary['seconds']:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
