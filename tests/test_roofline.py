"""Roofline accounting (utils/roofline.py): measured per-iteration cost and
peak lookups behave sanely.  The FLOP numerator is also pinned loosely so a
solver change that silently bloats per-iteration work shows up here."""

import jax.numpy as jnp
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu.models import asset_path
from optik_tpu.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def robot():
    return Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", dtype=jnp.float32)


def test_lane_iter_cost(robot):
    cfg = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32)
    cost = roofline.lane_iter_cost(robot.spec, cfg)
    # Hand count for the 7-DoF Panda LM body: fused residual+Jacobian
    # ~2.1 kFLOP + step/gain linear algebra ~0.9 kFLOP.  Anything far
    # outside is a regression (or a counting bug).
    assert 2000 < cost["flops"] < 6000
    assert 10 < cost["transcendentals"] < 150
    # Amortized one-time setup must stay small: a bigger batch barely
    # changes the per-lane figure.
    cost2 = roofline.lane_iter_cost(robot.spec, cfg, b=256)
    assert abs(cost2["flops"] - cost["flops"]) / cost["flops"] < 0.05


def test_vpu_peak_lookup():
    """The peak table is keyed by device_kind; unknown kinds raise."""
    peaks = roofline.device_peaks(H100)
    assert peaks["f32_flops"] == pytest.approx(67e12)
    assert peaks["hbm_bytes"] == pytest.approx(3.35e12)
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no published peaks"):
            roofline.device_peaks(kind)


def test_utilization_shape(robot):
    out = roofline.utilization(1e6, 0.01, 3000.0, H100)
    assert out["model_gflops_per_s"] == pytest.approx(3e11 / 1e9)
    assert out["f32_util"] == pytest.approx(3e11 / 67e12)
    with pytest.raises(ValueError):
        roofline.utilization(1e6, 0.01, 3000.0, "cpu")
