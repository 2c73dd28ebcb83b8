"""The port's command line: ``render``, ``info`` and ``fit`` through
``main([...])`` at 16x16 on the CPU, against what the JAX package's CLI gives
for the same files, and an import of the CLI in an interpreter where ``jax``
cannot be imported."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu import cli as j_cli
from pbrpathtracer_tpu_torch import MaterialSpec, cli, load_pts, save_pts
from pbrpathtracer_tpu_torch.io.png import read_png
from pbrpathtracer_tpu_torch.scene.editor import EditorScene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROOM_OBJ = textwrap.dedent("""\
    o floor
    v -1 0 -1
    v 1 0 -1
    v 1 0 1
    v -1 0 1
    vt 0 0
    vt 1 0
    vt 1 1
    vt 0 1
    f 1/1 2/2 3/3 4/4
    o lamp
    v -1 0 -1
    v -1 2 -1
    v 1 2 -1
    v 1 0 -1
    f 5/1 6/2 7/3 8/4
    """)


@pytest.fixture
def scene_files(tmp_path):
    obj = tmp_path / "room.obj"
    obj.write_text(ROOM_OBJ)
    ed = EditorScene()
    assert ed.load_object(str(obj))
    ed.set_material(0, 0, MaterialSpec(diffuse=(0.6, 0.5, 0.4),
                                       specular=(0, 0, 0)))
    ed.set_material(0, 1, MaterialSpec(diffuse=(0.7, 0.7, 0.7),
                                       emissive=(1.0, 0.9, 0.8),
                                       emissive_intensity=2.0))
    ed.set_camera((0.1, 1.0, 4.0))
    ed.rotate_camera((0.0, 3.141592653589793, 0.0))    # look down -z
    pts = tmp_path / "room.pts"
    save_pts(str(pts), ed, {"trace_depth": 2, "width": 16, "height": 16,
                            "auto_res": True})
    return str(obj), str(pts)


def test_render_pts_and_obj(scene_files, tmp_path, capsys):
    obj, pts = scene_files
    out = str(tmp_path / "out.png")
    cli.main(["render", pts, "-o", out, "--spp", "2", "--device", "cpu"])
    said = capsys.readouterr().out
    assert "16x16@2spp depth 2 on cpu" in said and out in said
    img = read_png(out)
    assert img.shape == (16, 16, 4) and img[..., :3].max() > 25   # lit
    # the JAX CLI on the same file: the same PNG but for knife-edge pixels
    ref = str(tmp_path / "ref.png")
    j_cli.main(["render", pts, "-o", ref, "--spp", "2"])
    d = np.abs(img[..., :3].astype(int) - read_png(ref)[..., :3]).max(-1)
    assert (d > 1).mean() <= 0.02, f"{(d > 1).sum()} pixels differ"
    # overrides, --aspect on an auto-res file, and a bare OBJ into a
    # directory with an automatic name
    cli.main(["render", pts, "-o", out, "--spp", "1", "--device", "cpu",
              "--aspect", "2.0", "--depth", "1", "--auto-segments"])
    h, w = read_png(out).shape[:2]
    assert w > h and abs(w * h - 256) <= 32
    cli.main(["render", obj, "-o", str(tmp_path), "--spp", "1", "--width",
              "8", "--height", "8", "--device", "cpu"])
    (auto,) = [f for f in os.listdir(tmp_path) if f.startswith("scene_")]
    assert read_png(str(tmp_path / auto)).shape == (8, 8, 4)


def test_render_builtin_and_errors(tmp_path, scene_files):
    out = str(tmp_path / "b.png")
    cli.main(["render", "--builtin", "cornell", "-o", out, "--spp", "1",
              "--width", "16", "--height", "16", "--device", "cpu"])
    assert read_png(out)[..., :3].max() > 100
    with pytest.raises(SystemExit, match="scene file or --builtin"):
        cli.main(["render", "--device", "cpu"])
    with pytest.raises(SystemExit, match="cannot load"):
        cli.main(["render", str(tmp_path / "absent.obj"), "--device", "cpu"])
    os.remove(scene_files[0])
    with pytest.raises(SystemExit, match="missing OBJ assets"):
        cli.main(["render", scene_files[1], "--device", "cpu"])
    # the JAX CLI's --intersector went with the config field it drove
    with pytest.raises(SystemExit):
        cli.main(["render", "--builtin", "cornell", "--intersector", "bvh"])
    if not torch.cuda.is_available():
        # the default device is the card, and bench measures only the card:
        # torch's own error without one
        for argv in (["render", "--builtin", "cornell", "--spp", "1",
                      "--width", "8", "--height", "8"], ["bench"]):
            with pytest.raises((AssertionError, RuntimeError),
                               match="(?i)cuda|nvidia"):
                cli.main(argv)


def test_info(scene_files, capsys):
    _, pts = scene_files
    cli.main(["info", pts])
    info = json.loads(capsys.readouterr().out)
    assert info["triangles"] == 4
    assert info["resolution"] == [16, 16] and info["trace_depth"] == 2
    assert [e["name"] for e in info["objects"][0]["elements"]] == \
        ["floor", "lamp"]
    j_cli.main(["info", pts])
    assert json.loads(capsys.readouterr().out) == info
    cli.main(["info", pts, "--no-assets"])
    bare = json.loads(capsys.readouterr().out)
    assert "triangles" not in bare and bare["missing_objects"] == []
    assert bare["objects"][0]["elements"][1]["type"] == "OPAQUE"


def test_fit(scene_files, tmp_path, capsys):
    _, pts = scene_files
    target = str(tmp_path / "target.png")
    cli.main(["render", pts, "-o", target, "--spp", "4", "--device", "cpu"])
    saved = str(tmp_path / "params.npz")
    cli.main(["fit", pts, "--target", target, "--steps", "3", "--spp", "1",
              "--device", "cpu", "--save-params", saved])
    said = capsys.readouterr().out
    assert "step 0: loss" in said and "final loss:" in said
    params = np.load(saved)
    assert params["mat.diffuse"].shape == (2, 3)
    assert np.isfinite(params["mat.diffuse"]).all()
    before = load_pts(pts)[0].objects[0].elements[0].material.diffuse
    assert not np.allclose(params["mat.diffuse"][0], before)   # it moved
    cli.main(["fit", "--builtin", "cornell", "--steps", "1", "--spp", "1",
              "--width", "16", "--height", "16", "--device", "cpu"])
    assert "self-calibration" in capsys.readouterr().out


def test_cli_imports_without_jax():
    """The CLI and every module it reaches load, and a render runs, in an
    interpreter where importing jax fails."""
    code = textwrap.dedent("""\
        import sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None          # import -> ImportError
        import pbrpathtracer_tpu_torch.cli as cli
        import pbrpathtracer_tpu_torch.__main__
        from pbrpathtracer_tpu_torch import api
        import pbrpathtracer_tpu_torch.utils.observability
        cli.main(["render", "--builtin", "cornell", "-o", sys.argv[1],
                  "--spp", "1", "--width", "8", "--height", "8",
                  "--device", "cpu"])
        assert not [m for m in sys.modules
                    if m.split(".")[0] == "pbrpathtracer_tpu"]
        """)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "o.png")
        subprocess.run([sys.executable, "-c", code, out], cwd=REPO,
                       check=True, timeout=240)
        assert read_png(out).shape == (8, 8, 4)


def test_api_exports_every_name_of_the_jax_api():
    from pbrpathtracer_tpu import api as j_api
    from pbrpathtracer_tpu_torch import api as p_api
    assert set(j_api.__all__) <= set(p_api.__all__)
    for name in p_api.__all__:
        assert getattr(p_api, name) is not None


def test_module_entry_point(scene_files, tmp_path):
    """``python -m pbrpathtracer_tpu_torch`` is the CLI."""
    _, pts = scene_files
    res = subprocess.run(
        [sys.executable, "-m", "pbrpathtracer_tpu_torch", "info", pts,
         "--no-assets"], cwd=REPO, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["resolution"] == [16, 16]
    res = subprocess.run(
        [sys.executable, "-m", "pbrpathtracer_tpu_torch", "render", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert "--device" in res.stdout and "--intersector" in res.stdout
