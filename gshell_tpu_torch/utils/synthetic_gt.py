"""Deterministic synthetic ground-truth meshes for quality runs (the port's
copy of ``tools/make_synthetic_gt.py``, numpy only).

The synthetic reconstruction runs train against ``DatasetMesh`` renders of
these meshes.

Usage:
    python -m gshell_tpu_torch.utils.synthetic_gt sphere /tmp/sphere.obj
    python -m gshell_tpu_torch.utils.synthetic_gt skirt  /tmp/skirt.obj
"""
import sys

import numpy as np


def write_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")
    print(f"{path}: {len(verts)} verts, {len(faces)} faces")


def sphere(nu=64, nv=48):
    vs, fs = [], []
    for i in range(nv + 1):
        th = np.pi * i / nv
        for j in range(nu):
            ph = 2 * np.pi * j / nu
            vs.append((np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)))
    for i in range(nv):
        for j in range(nu):
            a = i * nu + j
            b = i * nu + (j + 1) % nu
            c = (i + 1) * nu + (j + 1) % nu
            d = (i + 1) * nu + j
            fs.append((a, b, c))
            fs.append((a, c, d))
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


def skirt(nu=96, nv=64):
    """Open wavy 'skirt': surface of revolution, open top AND bottom, with
    angular waves whose amplitude grows toward the hem — thin features that
    stress the mSDF cut and fine silhouette gradients (~12k faces)."""
    vs, fs = [], []
    for i in range(nv + 1):
        t = i / nv  # 0 = waist (top), 1 = hem (bottom)
        y = 0.9 - 1.8 * t
        r0 = 0.35 + 0.55 * t**1.3  # flare
        amp = 0.02 + 0.10 * t**2  # waves grow toward hem
        for j in range(nu):
            ph = 2 * np.pi * j / nu
            r = r0 + amp * np.sin(8 * ph + 3.0 * t) + 0.015 * np.sin(17 * ph)
            vs.append((r * np.cos(ph), y, r * np.sin(ph)))
    for i in range(nv):
        for j in range(nu):
            a = i * nu + j
            b = i * nu + (j + 1) % nu
            c = (i + 1) * nu + (j + 1) % nu
            d = (i + 1) * nu + j
            fs.append((a, b, c))
            fs.append((a, c, d))
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


def blob(nu=96, nv=72):
    """WATERTIGHT quality-rung shape (the NeRF-chair-like regime of
    ``train_gshelltet_synthetic.py`` / ``configs/nerf_chair.json``): a closed
    genus-0 surface with low-frequency lobes + medium-frequency bumps —
    concavities and curvature variety without open boundaries, so the mSDF
    must learn to stay closed (msdf_reg_close_scale) while the SDF carries
    all the geometry."""
    vs, fs = [], []
    for i in range(nv + 1):
        th = np.pi * i / nv
        s = np.sin(th)  # φ-dependent displacement → 0 at the poles
        for j in range(nu):
            ph = 2 * np.pi * j / nu
            r = (
                0.78
                + 0.16 * np.sin(3 * th) * np.cos(2 * ph) * s
                + 0.10 * np.cos(5 * th + 1.0) * np.sin(3 * ph) * s
                + 0.05 * np.sin(7 * th) * np.sin(5 * ph + 0.5) * s
            )
            vs.append((r * s * np.cos(ph), r * np.cos(th), r * s * np.sin(ph)))
    # weld each pole row to one vertex (a ring of distinct coincident verts
    # would leave a topological boundary → not watertight)
    vs = np.asarray(vs, np.float32)
    remap = np.arange(len(vs))
    remap[0:nu] = 0
    remap[nv * nu : (nv + 1) * nu] = nv * nu
    for i in range(nv):
        for j in range(nu):
            a = remap[i * nu + j]
            b = remap[i * nu + (j + 1) % nu]
            c = remap[(i + 1) * nu + (j + 1) % nu]
            d = remap[(i + 1) * nu + j]
            if a != b and b != c and c != a:
                fs.append((a, b, c))
            if a != c and c != d and d != a:
                fs.append((a, c, d))
    return vs, np.asarray(fs, np.int32)


SHAPES = {"sphere": sphere, "skirt": skirt, "blob": blob}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in SHAPES:
        print(f"usage: python -m gshell_tpu_torch.utils.synthetic_gt {{{'|'.join(SHAPES)}}} OUT.obj",
              file=sys.stderr)
        return 2
    v, f = SHAPES[argv[0]]()
    write_obj(argv[1], v, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
