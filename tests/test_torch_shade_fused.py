"""The fused forward shading segment on the CPU: its dispatch, and its
kernels' arithmetic.

* Dispatch (``ops/shade._shade``): CPU lanes take the torch chain
  (``shade_plain``), and so does a call that records a graph, on any
  device; neither counts a ``fused_shades``, and the gradients through the
  chain are what they were. The fused kernels run only for lanes on the
  card with no graph to record (``tests/test_torch_gpu.py``).
* Arithmetic: ``csrc/shade.cu`` built for the host by g++
  (``tests/shade_host/cuda_runtime.h``: the grid as a loop, ``rsqrtf`` as
  ``1 / sqrtf``), launched by ``_shade_fused`` in place of the card, on the
  cases of ``tests/_shade_cases.py``, every segment of a sample, against
  ``shade_plain`` from the same state and hits. The CPU's torch kernels are
  not the card's (``torch.rsqrt``, ``torch.cos`` differ from the host's
  functions in the last bits), so floats agree to 2e-5 and the decisions
  (alive, inside, itr, depth) exactly, on all but a rare lane. Bit for bit
  is the card's test.
* The struct the kernels take is laid out as ``kernels/shade.py`` fills it,
  and the pack columns the kernels read are ``ops/shadepack``'s.
"""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import pytest
import torch

import _shade_cases as cases
from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu_torch import get_params
from pbrpathtracer_tpu_torch.diff.loss import eager_loss_and_grad
from pbrpathtracer_tpu_torch.kernels import shade as ks
from pbrpathtracer_tpu_torch.ops import shade, shadepack
from pbrpathtracer_tpu_torch.ops.integrator import render_sample
from pbrpathtracer_tpu_torch.utils import observability as obs

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, os.pardir, "pbrpathtracer_tpu_torch", "csrc",
                      "shade.cu")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' source for the host")
    lib = str(tmp_path_factory.mktemp("shade_host") / "libshadehost.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", os.path.join(HERE, "shade_host"),
                    "-x", "c++", SOURCE, "-o", lib], check=True)
    return ctypes.CDLL(lib)


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """``_shade_fused`` launching the host build; a 0-d tensor word is
    read through its pointer, as on the card."""
    def launch(kernel, **kw):
        args = ks.ShadeArgs()
        for k, v in kw.items():
            setattr(args, k, v.data_ptr() if isinstance(v, torch.Tensor)
                    else v)
        assert getattr(host_lib, kernel)(ctypes.addressof(args), None) == 0

    def word(x):
        if isinstance(x, torch.Tensor):
            return x, x.element_size(), 0
        return None, 0, int(x)
    monkeypatch.setattr(ks, "launch", launch)
    monkeypatch.setattr(ks, "word", word)
    for k in ("pbr_shade_s1", "pbr_shade_s2", "pbr_shade_s3"):
        getattr(host_lib, k).argtypes = [ctypes.c_void_p, ctypes.c_void_p]


def _compare(a, b, where):
    floats = ("ro", "rd", "throughput", "radiance")
    for f in cases.FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, f)
        if f in floats:
            torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5,
                                       msg=lambda m: f"{where} {f}: {m}")
        else:
            off = int((x != y).sum())
            assert off <= max(1, x.shape[0] // 500), (where, f, off)


@pytest.mark.parametrize("name", cases.CASES)
@pytest.mark.parametrize("word", ["int", "tensor"])
def test_host_build_follows_the_torch_chain(on_host, name, word):
    scene, cam, cfg = cases.case(name, "cpu", 16, 12, 3000)
    seed, sample_idx = 2 ** 31 + 17, 3
    if word == "tensor":
        seed = torch.tensor(seed, dtype=torch.int64)
        sample_idx = torch.tensor(sample_idx, dtype=torch.int32)
    segs = 0
    for seg, a, b in cases.segment_pairs(scene, cam, cfg, seed, sample_idx,
                                         shade._shade_fused, shade.shade_plain):
        _compare(a, b, (name, seg))
        assert a.pixel is b.pixel
        segs += 1
    assert segs >= 2


def test_host_build_of_a_dead_wavefront_keeps_its_state(on_host):
    """Every lane dead: the state comes back as it went in (the radiance
    plus 0)."""
    scene, cam, cfg = cases.case("cornell", "cpu", 8, 8, 0)
    dead = []

    def shade_dead(scene, cfg, state, *rest):
        st = dataclasses.replace(state, alive=torch.zeros_like(state.alive))
        out = shade._shade_fused(scene, cfg, st, *rest)
        dead.append((st, out))
        return out
    for _ in cases.segment_pairs(scene, cam, cfg, 1, 0, shade_dead,
                                 shade.shade_plain):
        break
    st, out = dead[0]
    for f in cases.FIELDS:
        assert torch.equal(getattr(st, f), getattr(out, f)), f


def test_cpu_lanes_take_the_torch_chain():
    scene, cam, cfg = cases.case("cornell", "cpu", 12, 8, 0)
    calls = []
    plain = shade.shade_plain

    def spy(*args):
        calls.append(1)
        return plain(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shade, "shade_plain", spy)
        mp.setattr(shade, "_shade_fused", None)   # a call would raise
        out, moved = obs.counted(lambda: render_sample(scene, cam, cfg, 0))
    assert calls and moved.get("fused_shades", 0) == 0
    assert moved["segments"] == len(calls)
    assert torch.equal(out, render_sample(scene, cam, cfg, 0))


@pytest.mark.parametrize("leaves", ["materials", "textures", "camera"])
def test_a_call_that_records_a_graph_takes_the_torch_chain(leaves,
                                                           monkeypatch):
    """A fwd+bwd shades by ``shade_plain`` and counts no ``fused_shades``,
    and its loss and gradients are the torch chain's own; what decides
    it (``records_graph``) reads only grad mode and the inputs, not the
    device."""
    scene, cam, cfg = cases.case("textured", "cpu", 10, 8, 3000)
    target = torch.full((cfg.height, cfg.width, 3), 0.3)
    params = get_params(scene, cam, materials=leaves == "materials",
                        textures=leaves == "textures",
                        camera_lens=leaves == "camera")
    calls, decided = [], []
    plain, decide = shade.shade_plain, shade.records_graph

    def spy(*args):
        calls.append(1)
        return plain(*args)

    def decide_spy(*inputs):
        decided.append(decide(*inputs))
        return decided[-1]
    monkeypatch.setattr(shade, "shade_plain", spy)
    monkeypatch.setattr(shade, "records_graph", decide_spy)
    (loss, grads), moved = obs.counted(
        lambda: eager_loss_and_grad(params, scene, cam, cfg, target))
    assert calls and moved.get("fused_shades", 0) == 0
    # every segment saw its graph by what it reads, whatever the device
    assert decided == [True] * len(calls)
    # the chain called directly, without the dispatch
    monkeypatch.setattr(shade, "_shade", lambda *a: plain(*a))
    loss_p, grads_p = eager_loss_and_grad(params, scene, cam, cfg, target)
    assert torch.equal(loss, loss_p) and grads.keys() == grads_p.keys()
    assert all(torch.equal(grads[k], grads_p[k]) for k in grads)
    assert any(bool(g.abs().sum() > 0) for g in grads.values())


@pytest.mark.parametrize("leaves", cases.LEAVES)
def test_a_segment_that_records_a_graph_takes_the_torch_chain(leaves,
                                                              monkeypatch):
    """One segment under grad with the leaves of ``leaves`` requiring grad:
    what decides the dispatch (``records_graph``, which does not look at
    the device) sees the graph, no ``fused_shades`` is counted, and the
    loss and gradients are those of ``shade_plain`` called directly."""
    scene, cam, cfg = cases.case("textured", "cpu", 10, 8, 3000)
    decided = []
    decide = shade.records_graph

    def decide_spy(*inputs):
        decided.append(decide(*inputs))
        return decided[-1]
    monkeypatch.setattr(shade, "records_graph", decide_spy)
    (loss, grads), moved = obs.counted(lambda: cases.segment_grads(
        scene, cam, cfg, leaves, shade.shade_segment))
    assert decided == [True] and moved.get("fused_shades", 0) == 0
    loss_p, grads_p = cases.segment_grads(scene, cam, cfg, leaves,
                                          shade.shade_plain)
    assert torch.equal(loss, loss_p) and grads.keys() == grads_p.keys()
    for k, g in grads.items():
        assert (g is None) == (grads_p[k] is None), k
        assert g is None or torch.equal(g, grads_p[k]), k
    assert any(g is not None and bool(g.abs().sum() > 0)
               for g in grads.values())


def test_what_decides_the_dispatch():
    x = torch.zeros(3)
    w = torch.zeros(3, requires_grad=True)
    assert not shade.records_graph(x, None, x)
    assert shade.records_graph(x, None, w)
    with torch.no_grad():
        assert not shade.records_graph(x, w)
    with torch.inference_mode():
        assert not shade.records_graph(x)


def test_the_struct_is_laid_out_as_the_launcher_fills_it():
    src = open(SOURCE).read()
    body = re.search(r"struct ShadeArgs \{(.*?)\n\};", src, re.S).group(1)
    names = re.findall(r"^\s*[\w\s\*]+?\b(\w+);", body, re.M)
    assert tuple(names) == ks._ARGS
    assert ctypes.sizeof(ks.ShadeArgs) == 8 * len(ks._ARGS)


def test_the_kernels_read_the_packs_columns():
    src = open(SOURCE).read()
    col = {k: int(v) for k, v in re.findall(r"\bk(\w+) = (\d+)", src)}
    sp = shadepack
    tri = {"Normal": sp.NORMAL, "N0": sp.N0, "N1": sp.N1, "N2": sp.N2,
           "UV0": sp.UV0, "UV1": sp.UV1, "UV2": sp.UV2,
           "Smooth": sp.SMOOTH, "Diffuse": sp.DIFFUSE,
           "Specular": sp.SPECULAR, "Emissive": sp.EMISSIVE,
           "EmissInt": sp.EMISS_INT, "Roughness": sp.ROUGHNESS,
           "Reflectiveness": sp.REFLECTIVENESS,
           "Translucency": sp.TRANSLUCENCY, "Ior": sp.IOR,
           "MatType": sp.MAT_TYPE, "TexIdx": sp.TEX_IDX,
           "Tangent": sp.TANGENT, "Bitangent": sp.BITANGENT,
           "LV0": sp.L_V0, "LE1": sp.L_E1, "LE2": sp.L_E2,
           "LColor": sp.L_COLOR, "LTri": sp.L_TRI}
    for k, field in tri.items():
        start = field.start if isinstance(field, slice) else field
        assert col[k] == start, k
    from pbrpathtracer_tpu_torch.utils import constants as c
    for k in ("TexDiffuse", "TexNormal", "TexEmissive", "TexRoughness",
              "TexMetallic"):
        name = "TEX_" + k[3:].upper()
        assert col[k] == getattr(c, name), k


def test_the_rng_word_goes_by_pointer_only_from_the_card():
    assert ks.word(7) == (None, 0, 7)
    assert ks.word(2 ** 40 + 5) == (None, 0, 2 ** 40 + 5)
    assert ks.word(torch.tensor(9)) == (None, 0, 9)
    with pytest.raises(ValueError):
        ks.launch("pbr_shade_s2", ro=torch.zeros(3))


def test_the_kernels_work_is_reckoned_from_their_lanes():
    """``utils/roofline``: a recorded launch of S1-S3 is priced from its
    live lanes (alive and hit) and, after S1, its lanes that cast a shadow
    ray (the mask S2 wrote); a dead lane costs less than a live one, a
    casting lane more, and lights and textures only add bytes; no
    operation is reckoned."""
    from pbrpathtracer_tpu_torch.utils import roofline as rl
    alive = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.bool)
    hit = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool)
    cast = torch.tensor([1, 0, 0, 0, 0, 1], dtype=torch.bool)
    for k in ("shade_s1", "shade_s2", "shade_s3"):
        shapes = {"n": 6, "alive": alive, "hit": hit, "lights": True,
                  "textured": True, "cast": None if k == "shade_s1" else cast}
        assert rl.launch_work(k, shapes) == rl.shade_work(
            k, 6, 3, 0 if k == "shade_s1" else 2, True, True)
        for lights in (False, True):
            for textured in (False, True):
                dead = rl.shade_work(k, 1, 0, 0, lights, textured)
                live = rl.shade_work(k, 1, 1, 0, lights, textured)
                lit = rl.shade_work(k, 1, 1, 1, lights, textured)
                assert 0 < dead[0] <= live[0] <= lit[0]
                assert dead[1] == live[1] == lit[1] == 0
                assert k == "shade_s3" or dead[0] < live[0]
                assert k == "shade_s1" or live[0] < lit[0]
        assert rl.shade_work(k, 4, 2, 1, True, True)[0] >= \
            rl.shade_work(k, 4, 2, 1, False, False)[0]
    with pytest.raises(ValueError):
        rl.shade_work("shade_s4", 1, 1, 0, True, True)
