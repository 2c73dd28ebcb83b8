"""Comparison of a rendered image with a committed golden record
(``tests/goldens/*.npz``: per-pixel ``mean`` and ``var`` of the samples, and
``spp``), as the JAX package's golden check compares them: the port's own
copy, so that nothing of the port reaches outside its package and the golden
data."""

from __future__ import annotations

import os

import numpy as np

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "goldens")


def compare(mean, var, g):
    """Bound mean drift and outlier-pixel fraction against a golden record.

    The tolerance per pixel is six standard deviations of the mean estimate
    (from the golden's and the render's sample variances) plus 1e-4: float
    accumulation order moves a pixel far less, a flipped decision (hit
    choice, roulette gate) shows as an isolated outlier."""
    gm, gv = g["mean"], g["var"]
    spp = int(g["spp"])
    sigma = np.sqrt((gv + var) / spp) + 1e-4
    diff = np.abs(mean - gm)
    outlier_frac = float((diff > 6.0 * sigma).mean())
    return {
        "mean_drift": float(np.abs(mean.mean() - gm.mean())),
        "rmse": float(np.sqrt(((mean - gm) ** 2).mean())),
        "outlier_frac": outlier_frac,
        "ok": bool(np.abs(mean.mean() - gm.mean()) < 2e-3
                   and outlier_frac < 2e-3),
    }
