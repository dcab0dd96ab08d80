"""The port's mesh IO against the JAX package's: ``load_obj`` (fan
triangulation, ``with_attrs``), ``unit_size`` and ``save_obj`` (padded,
degenerate and unreferenced elements dropped) on a small skirt.  Positions,
faces and written text exactly; smooth normals to rtol 1e-5."""
import numpy as np
import pytest

from gshell_tpu.render import mesh as jmesh
from gshell_tpu_torch.render import mesh as tmesh
from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj
from torch_parity import assert_close, n


@pytest.fixture
def skirt_obj(tmp_path):
    v, f = skirt(nu=24, nv=8)
    path = str(tmp_path / "skirt.obj")
    write_obj(path, v, f)
    with open(path, "a") as out:  # a textured quad and a pentagon, to triangulate as fans
        base = len(v) + 1
        out.write("vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\nusemtl cloth\n")
        out.write("v 2 0 0\nv 3 0 0\nv 3 1 0\nv 2 1 0\nv 2.5 1.5 0\n")
        out.write(f"f {base}/1/1 {base + 1}/2/1 {base + 2}/3/1 {base + 3}/4/1\n")
        out.write(f"f {base} {base + 1} {base + 2} {base + 4} {base + 3}\n")
    return path


def test_load_obj_and_unit_size_match_jax(skirt_obj):
    tm, ta = tmesh.load_obj(skirt_obj, with_attrs=True)
    jm, ja = jmesh.load_obj(skirt_obj, with_attrs=True)
    np.testing.assert_array_equal(n(tm.v_pos), np.asarray(jm.v_pos))
    np.testing.assert_array_equal(n(tm.t_pos_idx), np.asarray(jm.t_pos_idx))
    np.testing.assert_array_equal(n(tm.v_tex), np.asarray(jm.v_tex))
    assert_close(tm.v_nrm, jm.v_nrm, rtol=1e-5, atol=1e-6, what="v_nrm")
    for k in ("t_tex_idx", "t_nrm_idx", "v_nrm_file", "m_face_idx"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert ta["mat_names"] == ja["mat_names"] == ["cloth"] and ta["mtllib"] == ja["mtllib"]
    tu, ju = tmesh.unit_size(tm), jmesh.unit_size(jm)
    np.testing.assert_array_equal(n(tu.v_pos), np.asarray(ju.v_pos))
    assert float(tu.v_pos.max() - tu.v_pos.min()) <= 1.0 + 1e-6


def test_save_obj_matches_jax(tmp_path, skirt_obj):
    m = tmesh.load_obj(skirt_obj)
    v, f = n(m.v_pos), n(m.t_pos_idx)
    rng = np.random.default_rng(0)
    pad = np.full((7, 3), v.shape[0] - 1)  # padding routed to one vertex
    faces = np.concatenate([f, pad, [[3, 3, 5], [4, 6, 4]]])  # and degenerate faces
    valid = np.concatenate([rng.random(len(f)) < 0.8, np.zeros(7, bool), [True, True]])
    nt = tmesh.save_obj(str(tmp_path / "t.obj"), m.v_pos, faces, valid)
    jmesh.save_obj(str(tmp_path / "j.obj"), v, faces, valid)
    text = (tmp_path / "t.obj").read_text()
    assert text == (tmp_path / "j.obj").read_text()
    assert nt == text.count("\nf ") + text.startswith("f ") == int(valid[: len(f)].sum())
