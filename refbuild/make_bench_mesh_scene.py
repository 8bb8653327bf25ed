"""Write the procedural icosphere-field mesh scene (deterministic, seed 0)
in the reference's scene grammar, so the SAME geometry/camera/lights can
be rendered by both renderers. Emits

* scenes/bench_mesh.obj   — the spheres as one world-space OBJ group
                            (shared vertices, 1-indexed faces)
* scenes/bench_mesh.txt   — a scene file in the grammar the reference
                            parser implements (scene/scenefile.h:92-791):
                            film header, MATTE+EMISSIVE materials, floor
                            and lamp RECTANGLEs, OBJECT MESH with
                            identity transform (world-space verts baked).

Camera: eye (0, 40, 3.2*sqrt(count)+40), look (0, 2, 0), FOV 50, square
film. chip_smoke.py calls `write_scene` for its deployment-size mesh.

Usage: python refbuild/make_bench_mesh_scene.py [--tris 327680]
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "..", "scenes")
sys.path.insert(0, SCENES)


def write_scene(tris: int = 327680, size: int = 256,
                name: str = "bench_mesh", out_dir: str = SCENES):
    """Write <out_dir>/<name>.obj (about `tris` triangles, whole
    1280-triangle icospheres) and <out_dir>/<name>.txt; returns the path
    of the scene file."""
    from make_fixtures import icosphere

    v, f = icosphere(3)  # 1280 tris, 642 verts per sphere
    per = f.shape[0]
    count = max(1, tris // per)
    grid = int(np.ceil(np.sqrt(count)))

    # placement: seed 0; one rng.random() for height then one for scale,
    # per sphere
    rng = np.random.default_rng(0)
    verts_out, faces_out = [], []
    base = 0
    n = 0
    for i in range(grid):
        for j in range(grid):
            if n >= count:
                break
            c = np.array([i * 6.0 - 3 * grid, 1.0 + rng.random() * 2,
                          j * 6.0 - 3 * grid])
            s = 0.8 + rng.random()
            verts_out.append(v * s + c)
            faces_out.append(f + base)
            base += v.shape[0]
            n += 1
    verts = np.concatenate(verts_out).astype(np.float32)
    faces = np.concatenate(faces_out) + 1  # OBJ is 1-indexed

    obj_path = os.path.join(out_dir, name + ".obj")
    buf = io.StringIO()
    np.savetxt(buf, verts, fmt="v %.6f %.6f %.6f")
    np.savetxt(buf, faces, fmt="f %d %d %d")
    with open(obj_path, "w") as fh:
        fh.write(buf.getvalue())

    eye_z = 3.2 * (count * per / 1280) ** 0.5 + 40
    scene = f"""WINDOW_WIDTH {size}
WINDOW_HEIGHT {size}
IMAGE_WIDTH {size}
IMAGE_HEIGHT {size}
FOV 50.0
CAMERA_POS 0 40 {eye_z:.4f}
LOOK_POINT 0 2 0

MATERIAL MATTE
NAME w
COLOR 0.7 0.7 0.7
SIGMA 0.0
END

MATERIAL EMISSIVE
NAME l
COLOR 1 1 1
INTENSITY 40
END

END_MATERIALS

ENV_LIGHT
TYPE CONSTANT
COLOR WHITE
INTENSITY 0

OBJECT RECTANGLE
POINT -200 0 -200
WIDTH 400 0 0
HEIGHT 0 0 400
MATERIAL w

OBJECT MESH
FILE_NAME {name}.obj
SMOOTH no
SCALING 1 1 1
LOCATION 0 0 0
ORIENTATION 0 0 0
MATERIAL w

OBJECT RECTANGLE
POINT -10 80 -10
WIDTH 20 0 0
HEIGHT 0 0 20
MATERIAL l
"""
    txt_path = os.path.join(out_dir, name + ".txt")
    with open(txt_path, "w") as fh:
        fh.write(scene)
    print(f"wrote {obj_path} ({faces.shape[0]} tris, {verts.shape[0]} verts)")
    print(f"wrote {txt_path} (eye z {eye_z:.2f})")
    return txt_path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=327680)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--name", default="bench_mesh")
    args = ap.parse_args()
    write_scene(args.tris, args.size, args.name)


if __name__ == "__main__":
    main()
