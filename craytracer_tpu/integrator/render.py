"""Progressive renderer: the driver loop (main.cpp:295-346) as a thin host
orchestration over a jitted per-pass render step.

Each pass traces one sample per pixel for the whole image (optionally in
fixed-size tiles to bound the [rays x prims] working set), accumulates into
an f32 HBM buffer, and can checkpoint/resume via io.imagestate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.camera import Camera, Film
from craytracer_tpu.integrator.wavefront import render_sample
from craytracer_tpu.scene.types import Scene
from craytracer_tpu.utils.tonemap import tone_map


@dataclass
class RenderConfig:
    num_samples: int = 16
    max_depth: int = 5
    seed: int = 0
    tile_pixels: int = 0  # 0 = whole image per pass
    # Trace B spp in ONE dispatch (lanes = B * pixels): the traversal's
    # while-loop trip count is paid per dispatch, so batching spp can
    # amortize it. B=1 is bit-identical to the sequential loop; B>1
    # changes only fp accumulation order and NaN-recovery substitutes.
    # 0 = auto, which is currently B=1.
    spp_batch: int = 1
    log_every: int = 0  # print progress every k passes (0 = silent)
    estimator: str = "reference"
    trace_type: str = "PATHTRACE"
    # NaN recovery (main.cpp:127-136): substitute the running average for
    # NaN samples and report the count.
    nan_recovery: bool = True
    # NaN diagnosis (main.cpp:127-136 + pathTraceLogging/SampleLog,
    # trace.h:535-684): when a pass produces NaN samples, re-trace the
    # offending pixels under the logging integrator and append their
    # per-bounce t/beta/contribution records here before substituting.
    # The counter RNG makes the retrace bit-exact: the offending path is
    # keyed by (seed, pixel, spp) alone. "" disables; the reference
    # writes trace_log.txt in the working directory unconditionally.
    nan_log_path: str = "trace_log.txt"
    nan_log_max: int = 8  # samples logged per pass (the retrace is 1-lane)
    # Live preview (the GLFW window's stand-in, gl/glcode.h:108-151):
    # write a PNG of the running image every `preview_every` passes.
    preview_path: str = ""
    preview_every: int = 0
    # HTTP live view (integrator/live.py): a REAL continuously-updating
    # window for headless hosts — serve the running render at
    # http://host:port/ (auto-refreshing page + /frame.png + /status).
    # 0 disables; render.py exposes --serve.
    serve_port: int = 0
    # Terminal live view: print the running image as ANSI half-blocks
    # every `ansi_every` passes (the only "window" a headless host has).
    ansi_every: int = 0
    ansi_cols: int = 48
    # Interactive console during the render — the reference's pause key +
    # click-to-probe of a RUNNING render (main.cpp:41-55,151-167),
    # re-designed for a terminal: between passes, stdin lines are polled
    # non-blockingly: "p X,Y" prints the pixel's running accumulator /
    # mean / tone-mapped value, "pause" blocks until "resume", "stop"
    # ends the render early (the accumulated state stays valid and can
    # be checkpointed/resumed).
    interactive: bool = False
    # Optional table-driven sampler (sampling.tables.SampleTable): the
    # reference's regular/multijittered/Hammersley sample sets
    # (sampling.cpp:169-352) for the film-jitter dimension.
    sampler: object = None
    # Ray dispatch order: "morton" interleaves pixel bits so each block of
    # rays is a compact image tile instead of a scanline strip (coherent
    # blocks for the block-synchronous binned accel; bit-identical image —
    # the RNG keys off pixel id, so this is a pure reorder).
    ray_order: str = "morton"


@partial(jax.jit, static_argnames=("max_depth", "estimator", "trace_type",
                                   "fast_shade"))
def _pass_step(scene: Scene, camera: Camera, film: Film, pixel_ids, seed, spp_index,
               max_depth: int, estimator: str = "reference",
               trace_type: str = "PATHTRACE", sampler=None,
               fast_shade: bool = False):
    return render_sample(scene, camera, film, pixel_ids, seed, spp_index, max_depth,
                         estimator, trace_type, sampler=sampler,
                         fast_shade=fast_shade)


@partial(jax.jit, static_argnames=("max_depth", "estimator", "trace_type",
                                   "spp_batch", "fast_shade"))
def _pass_step_batched(scene: Scene, camera: Camera, film: Film, pixel_ids,
                       seed, spp0, max_depth: int,
                       estimator: str = "reference",
                       trace_type: str = "PATHTRACE", sampler=None,
                       spp_batch: int = 1, fast_shade: bool = False):
    """B spp in one dispatch: replica r of pixel p traces spp index
    spp0 + r — the SAME counter-RNG stream each sample would get from the
    sequential loop, so batched and sequential renders agree sample for
    sample. Returns [B, n_pixels, 3]."""
    m = pixel_ids.shape[0]
    ids_b = jnp.tile(pixel_ids, spp_batch)
    spp_lane = spp0 + jnp.repeat(
        jnp.arange(spp_batch, dtype=jnp.int32), m)
    vals = render_sample(scene, camera, film, ids_b, seed, spp_lane,
                         max_depth, estimator, trace_type, sampler=sampler,
                         fast_shade=fast_shade)
    return vals.reshape(spp_batch, m, 3)


class Renderer:
    def __init__(self, scene: Scene, camera: Camera, film: Film, config: RenderConfig):
        # Deviation: HDR-texture env lights default to texel IMPORTANCE
        # sampling under the principled estimators — lower MSE at equal
        # spp on a sun-dominated env, and the cosine strategy inherits the
        # reference's rotated-env pdf quirk (trace.h:307: the pdf is
        # evaluated with the TRANSFORM-ROTATED sample against the normal,
        # a genuine bias on rotated envs). estimator="reference" keeps
        # the reference's cosine strategy: its L/good_paths ratio is not
        # strategy-invariant (golden parity would shift ~3%).
        if (config.estimator in ("physical", "mis")
                and getattr(scene.env, "kind", 0) == 2
                and not scene.env.importance
                and scene.env.flat_cdf is not None):
            scene = scene.replace(env=scene.env.replace(importance=1))
        self.scene = scene
        self.camera = camera
        self.film = film
        self.config = config
        self.accum = jnp.zeros((film.num_pixels, 3), jnp.float32)
        self.live = None  # HTTP live view (set per render())
        self.spp_done = 0  # updated when render() completes
        self._accum_passes = 0  # live count including the in-flight render
        self.nan_count = 0

    def resume_from(self, accum: np.ndarray, spp: int):
        self.accum = jnp.asarray(accum.reshape(-1, 3), jnp.float32)
        self.spp_done = spp
        self._accum_passes = spp

    def _pixel_perm(self) -> Optional[np.ndarray]:
        """Morton (bit-interleaved) pixel dispatch order, or None for
        raster order. The returned permutation maps dispatch position ->
        pixel id; results are scattered back before accumulation, so the
        image (and every sample: the RNG keys off pixel id) is
        bit-identical to raster order."""
        if self.config.ray_order != "morton":
            return None
        w, h = self.film.width, self.film.height
        n = self.film.num_pixels
        bits = max(int(np.ceil(np.log2(max(w, h, 2)))), 1)
        code = np.arange(1 << (2 * bits), dtype=np.int64)
        x = np.zeros_like(code)
        y = np.zeros_like(code)
        for b in range(bits):
            x |= ((code >> (2 * b)) & 1) << b
            y |= ((code >> (2 * b + 1)) & 1) << b
        pid = y * w + x
        return pid[(x < w) & (y < h)].astype(np.int32)[:n]

    def render(self, progress_cb: Optional[Callable] = None):
        cfg = self.config
        n = self.film.num_pixels
        tile = cfg.tile_pixels or n
        start = time.time()
        s = self.spp_done
        end = self.spp_done + cfg.num_samples
        B = max(1, cfg.spp_batch)
        from craytracer_tpu.integrator.pallas_shade import \
            production_fast_shade

        # "bounce" = whole-pass megakernel (brute-force scenes on the
        # GPU), False = the XLA wavefront
        fast_shade = production_fast_shade(
            self.scene, self.camera, self.film,
            cfg.estimator, cfg.trace_type)
        if getattr(self, "live", None) is not None:
            # progressive re-render on the same Renderer: release the old
            # server (the port is still bound) before starting a new one
            self.live.stop()
        self.live = None
        if cfg.serve_port != 0:  # -1 = OS-assigned port (tests)
            from craytracer_tpu.integrator.live import LiveView

            self.live = LiveView(max(cfg.serve_port, 0)).start()
            print(f"live view: http://localhost:{self.live.port}/")
        perm = self._pixel_perm()
        perm_j = None if perm is None else jnp.asarray(perm)
        inv = None
        if perm is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(n, dtype=np.int32)
            inv = jnp.asarray(inv)
        while s < end:
            b = min(B, end - s)
            pass_vals = []
            for t0 in range(0, n, tile):
                ids = jnp.arange(t0, min(t0 + tile, n), dtype=jnp.int32)
                if perm_j is not None:
                    ids = perm_j[t0:min(t0 + tile, n)]
                pass_vals.append(
                    _pass_step_batched(self.scene, self.camera, self.film,
                                       ids, cfg.seed, s, cfg.max_depth,
                                       cfg.estimator, cfg.trace_type,
                                       sampler=cfg.sampler, spp_batch=b,
                                       fast_shade=fast_shade)
                )
            pass_val = jnp.concatenate(pass_vals, axis=1)  # [b, n, 3]
            if inv is not None:
                pass_val = pass_val[:, inv]  # dispatch order -> pixel order
            if cfg.nan_recovery:
                # replace NaN samples with the running mean (or 0 on pass 1)
                nan_px = jnp.isnan(pass_val).any(axis=-1)  # [b, n]
                n_nan = int(nan_px.sum())
                if (n_nan and cfg.nan_log_path
                        and cfg.trace_type == "PATHTRACE"):
                    # reference behavior: retrace the bad sample under the
                    # logging integrator BEFORE substituting (main.cpp:
                    # 127-136); columns are pixel ids (inv already applied)
                    self._write_nan_log(np.asarray(nan_px), s)
                mean_so_far = self.accum / max(self._accum_passes, 1)
                pass_val = jnp.where(nan_px[..., None],
                                     jnp.nan_to_num(mean_so_far)[None],
                                     pass_val)
                self.nan_count += n_nan
            self.accum = self.accum + pass_val.sum(axis=0)
            s += b
            self._accum_passes = s
            done = s - self.spp_done
            if cfg.log_every and done % cfg.log_every == 0:
                self.accum.block_until_ready()
                dt = time.time() - start
                nan_note = f" nan={self.nan_count}" if self.nan_count else ""
                print(f"pass {s}: {done / dt:.2f} passes/s{nan_note}")
            if self.live is not None:
                total = self.spp_done + cfg.num_samples
                # throttle check FIRST: the full tone-mapped readback is
                # a forced device sync that would otherwise run (and be
                # discarded) every ~50ms pass
                if self.live.want_frame(s, total):
                    self.live.publish(np.asarray(self.image()), s, total,
                                      self.nan_count)
                else:
                    self.live.update_status(s, total, self.nan_count)
            if cfg.preview_every and cfg.preview_path and (done % cfg.preview_every == 0):
                self._write_preview()
            if cfg.ansi_every and done % cfg.ansi_every == 0:
                print(self.ansi_preview(cfg.ansi_cols))
            if progress_cb is not None:
                progress_cb(s, self.image())
            if cfg.interactive and self._console(s):
                # early stop: record the passes actually accumulated
                self.spp_done = s
                return self.image()
        self.spp_done += cfg.num_samples
        return self.image()

    def _write_nan_log(self, nan_px: np.ndarray, spp0: int):
        """Re-trace NaN samples under the logging integrator and append
        their per-bounce records — the wavefront form of the reference's
        NaN handler (main.cpp:127-136: detect -> pathTraceLogging ->
        trace_log.txt -> substitute; SampleLog fields trace.h:176-219).
        The retrace replays the EXACT offending path: the counter RNG keys
        every decision off (seed, pixel, spp, bounce, dim) alone."""
        cfg = self.config
        from craytracer_tpu.camera import generate_rays
        from craytracer_tpu.integrator.wavefront import (CAMERA_BOUNCE,
                                                         trace_paths_logged)
        from craytracer_tpu.sampling import uniforms
        from craytracer_tpu.sampling.multijitter import stratified_jitter

        rows, cols = np.nonzero(nan_px)
        with open(cfg.nan_log_path, "a") as f:
            for r, p in list(zip(rows, cols))[:max(1, cfg.nan_log_max)]:
                spp = int(spp0 + r)
                pid = jnp.asarray([int(p)], jnp.int32)
                if cfg.sampler is not None:
                    from craytracer_tpu.sampling.tables import table_sample

                    jitter = table_sample(cfg.sampler, cfg.seed, pid, spp,
                                          dim=0)
                else:
                    jitter = stratified_jitter(cfg.seed, pid, spp)
                lens_u = uniforms(cfg.seed, pid, spp, CAMERA_BOUNCE, 2, 2)
                o, d = generate_rays(self.camera, self.film, pid, jitter,
                                     lens_u)
                L, good, log = trace_paths_logged(
                    self.scene, o, d, cfg.seed, pid, spp, cfg.max_depth)
                x, y = int(p) % self.film.width, int(p) // self.film.width
                f.write(f"NaN/Inf sample: pixel ({x},{y}) id {int(p)} "
                        f"spp {spp} seed {cfg.seed}\n")
                for bo in range(cfg.max_depth + 1):
                    be = np.asarray(log["beta"][bo, 0])
                    dc = np.asarray(log["direct_contrib"][bo, 0])
                    em = np.asarray(log["emissive_indirect_contrib"][bo, 0])
                    ev = np.asarray(log["env_indirect_contrib"][bo, 0])
                    f.write(
                        f"  bounce {bo}: alive={int(log['alive'][bo, 0])} "
                        f"t={float(log['t'][bo, 0]):.6g} "
                        f"beta=({be[0]:.6g} {be[1]:.6g} {be[2]:.6g}) "
                        f"direct=({dc[0]:.6g} {dc[1]:.6g} {dc[2]:.6g}) "
                        f"emit=({em[0]:.6g} {em[1]:.6g} {em[2]:.6g}) "
                        f"env=({ev[0]:.6g} {ev[1]:.6g} {ev[2]:.6g}) "
                        f"new_pdf={float(log['new_sample_pdf'][bo, 0]):.6g}\n")
                Lr = np.asarray(L[0])
                f.write(f"  L=({Lr[0]:.6g} {Lr[1]:.6g} {Lr[2]:.6g}) "
                        f"good={int(good[0])}\n")

    def _probe(self, x: int, y: int, spp: int):
        i = y * self.film.width + x
        acc = np.asarray(self.accum[i])
        mean = acc / max(spp, 1)
        tm = np.asarray(tone_map(jnp.asarray(mean)[None]))[0]
        print(f"probe ({x},{y}) @ {spp} spp: accum={acc.tolist()} "
              f"mean={mean.tolist()} tonemapped={tm.tolist()}")

    def _console(self, spp: int) -> bool:
        """Drain pending stdin commands; returns True on early stop."""
        import select
        import sys

        paused = False
        while True:
            timeout = None if paused else 0.0
            r, _, _ = select.select([sys.stdin], [], [], timeout)
            if not r:
                return False
            line = sys.stdin.readline().strip().lower()
            if not line:
                if paused:
                    continue
                return False
            if line in ("q", "stop", "quit"):
                print(f"stopped at {spp} spp (state remains resumable)")
                return True
            if line in ("pause", " "):
                paused = True
                print(f"paused at {spp} spp — 'p X,Y' to probe, "
                      "'resume' to continue, 'stop' to end")
                continue
            if line in ("resume", "r"):
                paused = False
                continue
            if line.startswith("p"):
                try:
                    x, y = (int(v) for v in
                            line[1:].replace(",", " ").split())
                    if 0 <= x < self.film.width and 0 <= y < self.film.height:
                        self._probe(x, y, spp)
                    else:
                        print("probe out of bounds")
                except ValueError:
                    print("usage: p X,Y")
                continue
            print("commands: p X,Y | pause | resume | stop")

    def _write_preview(self):
        try:
            from PIL import Image

            img = np.asarray(tone_map(self.accum / max(self._accum_passes, 1)))
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(img.reshape(self.film.height, self.film.width, 3)).save(
                self.config.preview_path
            )
        except Exception:
            pass

    def image(self) -> np.ndarray:
        """Tone-mapped [H, W, 3] image of the running mean (the per-pass
        display path, main.cpp:321-325 + genImageFromColorBuffer)."""
        spp = max(self._accum_passes, self.spp_done, 1)
        mean = self.accum / spp
        img = tone_map(mean)
        return np.asarray(img).reshape(self.film.height, self.film.width, 3)

    def raw_mean(self) -> np.ndarray:
        spp = max(self._accum_passes, self.spp_done, 1)
        return np.asarray(self.accum / spp).reshape(self.film.height, self.film.width, 3)

    def ansi_preview(self, cols: int = 48) -> str:
        """The running image as 24-bit ANSI half-blocks (2 pixels/char
        row): a terminal stand-in for the reference's GLFW live window
        (gl/glcode.h:108-151) that works on a headless host."""
        img = np.asarray(tone_map(self.accum / max(self._accum_passes, 1)))
        img = np.clip(img, 0.0, 1.0).reshape(
            self.film.height, self.film.width, 3)
        h, w = img.shape[:2]
        cols = max(2, min(cols, w))
        rows = max(2, (h * cols) // max(w, 1))
        rows += rows % 2  # half-blocks consume two pixel rows per char
        ys = (np.arange(rows) * (h / rows)).astype(int).clip(0, h - 1)
        xs = (np.arange(cols) * (w / cols)).astype(int).clip(0, w - 1)
        small = (img[ys][:, xs] * 255).astype(np.uint8)
        out = []
        for r in range(0, rows - 1, 2):
            line = []
            for c in range(cols):
                tr, tg, tb = small[r, c]
                br, bg, bb = small[r + 1, c]
                line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                            f"\x1b[48;2;{br};{bg};{bb}m▀")
            out.append("".join(line) + "\x1b[0m")
        return "\n".join(out)
