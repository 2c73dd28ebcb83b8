"""The port's scaling model (``utils/scaling.py``) against the JAX
package's, on the CPU: the gradient all-reduce bytes over the port's dict of
tensors equal the JAX value (exact, integers) on Cornell and on the 50k
textured scene's params, and every model function equals its JAX twin when
both are given the same link rates (the JAX module's ICI and DCN constants;
rel 1e-12: the same float operations). Without a step time,
``scaling_report`` measures one on the card: without a card it raises.
"""

import functools

import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.diff.params import get_params as j_get_params
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                mesh_scene_camera)
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu.utils import scaling as js
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.utils import scaling

params_from_reference = functools.partial(bridge.params_from_reference,
                                          device="cpu")
BW = dict(intra_bw=js.ICI_BYTES_PER_S, inter_bw=js.DCN_BYTES_PER_S)
POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)


def _approx(a, b):
    """Dicts and lists of floats equal to rel 1e-12, other values exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _approx(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _approx(x, y)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12)
    else:
        assert a == b


@pytest.fixture(scope="module")
def jax_params():
    cornell = j_get_params(jb.cornell_box(), JCamera.make(**POSE),
                           materials=True, camera_lens=True)
    textured = j_get_params(mesh_scene(50_000), mesh_scene_camera(),
                            materials=True, textures=True)
    return {"cornell": cornell, "50k textured": textured}


@pytest.mark.parametrize("which", ["cornell", "50k textured"])
def test_grad_psum_bytes_matches_jax(jax_params, which):
    jp = jax_params[which]
    assert scaling.grad_psum_bytes(params_from_reference(jp)) == \
        js.grad_psum_bytes(jp)


@pytest.mark.parametrize("bytes_,n,bw", [(340, 1, 1e11), (8_400_000, 4, 1e11),
                                         (131_072, 8, 4.5e11), (0, 2, 5e10)])
def test_ring_allreduce_time_matches_jax(bytes_, n, bw):
    assert scaling.ring_allreduce_time(bytes_, n, bw) == pytest.approx(
        js.ring_allreduce_time(bytes_, n, bw), rel=1e-12)


CASES = [(0.0209, 340, 1, 4, 1), (0.15, 8_400_000, 8, 4, 8),
         (0.15, 131_072, 2, 8, 4), (1e-4, 100_000_000, 4, 8, 16)]


@pytest.mark.parametrize("t,b,hosts,per_host,spp", CASES)
def test_efficiency_estimates_match_jax(t, b, hosts, per_host, spp):
    _approx(scaling.efficiency_estimate(t, b, hosts, per_host, spp, **BW),
            js.efficiency_estimate(t, b, hosts, per_host, spp=spp))
    _approx(scaling.efficiency_estimate_overlapped(t, b, hosts, spp,
                                                   per_host, **BW),
            js.efficiency_estimate_overlapped(t, b, hosts, spp, per_host))


@pytest.mark.parametrize("meas", [
    {"2": 0.001, "4": 0.0021, "8": 0.0038},
    {"1": 0.5, "2": 0.52, "3": 0.49, "8": 0.7}])
def test_fit_virtual_psum_model_matches_jax(meas):
    assert scaling.fit_virtual_psum_model(meas, 8_400_000) == \
        js.fit_virtual_psum_model(meas, 8_400_000)


@pytest.mark.parametrize("which", ["cornell", "50k textured"])
def test_scaling_report_matches_jax(jax_params, which):
    jp = jax_params[which]
    mine = scaling.scaling_report(params_from_reference(jp), 0.15,
                                  chips_per_host=4, **BW)
    ref = js.scaling_report(jp, 0.15, chips_per_host=4)
    for key in ("grad_psum_bytes", "t_step_1chip_s", "spp", "by_hosts",
                "by_hosts_overlapped"):
        _approx(mine[key], ref[key])
    assert mine["assumptions"]["chips_per_host"] == 4


def test_defaults_are_the_h100_cluster():
    rep = scaling.scaling_report({"x": torch.zeros(10)}, 0.1)
    assert rep["assumptions"] == {
        **rep["assumptions"], "intra_host_bytes_per_s": 4.5e11,
        "inter_host_bytes_per_s": 5e10, "chips_per_host": 8}
    assert rep["grad_psum_bytes"] == 40
    assert [e["n_chips"] for e in rep["by_hosts"]] == [8, 16, 32, 64]


def test_scaling_report_measures_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    with pytest.raises((AssertionError, RuntimeError),
                       match="(?i)cuda|nvidia"):
        scaling.scaling_report({"x": torch.zeros(10)})
