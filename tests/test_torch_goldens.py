"""The port's own golden comparison (``utils/goldens.compare``) against the
JAX package's ``benchmarks.goldens.compare``: the same numpy inputs must give
equal reports, field for field, and both must resolve the same golden
directory."""

import os

import numpy as np
import pytest

from benchmarks import goldens as j_goldens
from pbrpathtracer_tpu_torch.utils import goldens as p_goldens


def _golden(rs, shape=(16, 16, 3), spp=16):
    return {"mean": rs.uniform(0, 1, shape).astype(np.float32),
            "var": rs.uniform(0.01, 0.05, shape).astype(np.float32),
            "spp": np.int32(spp)}


def _case(kind):
    rs = np.random.RandomState(7)
    g = _golden(rs)
    noise = rs.normal(size=g["mean"].shape).astype(np.float32)
    mean = g["mean"] + 0.01 * noise * np.sqrt(g["var"])
    if kind == "drift":
        mean = mean + 0.01
    elif kind == "outlier":
        mean[::3, ::2] += 5.0
    return mean, g["var"].copy(), g


@pytest.mark.parametrize("kind,ok", [("ok", True), ("drift", False),
                                     ("outlier", False)])
def test_compare_equals_the_jax_packages(kind, ok):
    mean, var, g = _case(kind)
    ref = j_goldens.compare(mean, var, g)
    got = p_goldens.compare(mean, var, g)
    assert got == ref
    assert set(got) == {"mean_drift", "rmse", "outlier_frac", "ok"}
    assert got["ok"] is ok


def test_compare_separates_drift_from_outliers():
    mean, var, g = _case("drift")
    rep = p_goldens.compare(mean, var, g)
    assert rep["mean_drift"] > 2e-3 and rep["outlier_frac"] < 2e-3
    mean, var, g = _case("outlier")
    rep = p_goldens.compare(mean, var, g)
    assert rep["outlier_frac"] > 2e-3


def test_golden_directory_is_the_repositorys():
    assert os.path.samefile(p_goldens.GOLDEN_DIR, j_goldens.GOLDEN_DIR)
    for name in ("rung1_cornell", "rung2_spheres", "rung3_mesh50k",
                 "rung4_translucent", "rung5_million"):
        g = np.load(os.path.join(p_goldens.GOLDEN_DIR, f"{name}.npz"))
        assert {"mean", "var", "spp"} <= set(g.files)


def test_a_golden_compares_ok_with_itself():
    g = np.load(os.path.join(p_goldens.GOLDEN_DIR, "rung1_cornell.npz"))
    rep = p_goldens.compare(g["mean"], g["var"], g)
    assert rep == j_goldens.compare(g["mean"], g["var"], g)
    assert rep["ok"] and rep["rmse"] == 0.0
