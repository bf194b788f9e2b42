"""Roofline / utilization accounting for the LM solver.

SURVEY §5 asks for "per-kernel roofline accounting" in place of the
reference's criterion micro-benches (kylc/optik crates/optik/benches/
bench.rs).  The solver is element-wise float32 math on lane-shaped arrays
(the SoA path, ops/soa.py) with no matrix products, so its compute roof is
the card's float32 peak outside the tensor cores:

    util = lane_iters * flops_per_lane_iter / seconds / f32_peak

* ``lane_iters`` comes from the solve itself (IKResult.lane_iters, counted
  on device: every executed loop iteration of every lane, including lanes
  frozen by Speed-mode pose freezing — frozen lanes still occupy issue
  slots, their selects just keep the old state).
* ``flops_per_lane_iter`` is measured, not hand-counted: XLA's
  HloCostAnalysis counts a ``while`` body exactly ONCE per call site, so
  the flop count of the lowered batch solver is one loop iteration over all
  B*S lanes plus the one-time setup/selection (seed-table generation,
  per-pose argmin) — a few percent of the body at realistic lane counts.
  Dividing by the lane count gives FLOPs per lane-iteration with that
  one-time work amortized in.  The analysis runs on the UN-optimized
  module: post-optimization HLO duplicates producers into every consumer
  fusion, which counts compiler-materialized recomputation, not
  algorithmic work.  (Calibration: the count matches a hand count of the
  LM body — fused residual+Jacobian ~2.1 kFLOP/lane + J J^T build / 6x6
  Cholesky / step / gain-ratio ~0.9 kFLOP/lane for the 7-DoF Panda.)
* Transcendentals (sin/cos/sqrt/atan2 in the Rodrigues/log-map chain) are
  reported separately — XLA does not fold them into ``flops``, and they
  cost several instructions each, so utilization here is a LOWER bound.
"""

from __future__ import annotations

# Published peaks per device_kind (NVIDIA H100 data sheet, SXM part, at the
# full 700 W power limit): float32 outside the tensor cores, and HBM
# bandwidth.  A device kind not listed here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks for a jax ``device_kind``; raises for unknown kinds."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"optik_tpu/utils/roofline.PEAKS with its source") from None


def lane_iter_cost(spec, cfg, dtype=None, b: int = 64) -> dict:
    """Measured per-lane-iteration cost of the LM loop for one robot+config.

    Lowers the XLA-path batch solver (solver/ik.build_batch_solver — the
    exact loop core the Pallas kernel shares, solver/lm_soa.lm_loop) for the
    CPU backend and reads XLA's HloCostAnalysis.  Returns a dict with
    ``flops`` and ``transcendentals`` per lane-iteration.
    """
    import jax
    import jax.numpy as jnp

    from ..solver import ik as ik_mod

    dtype = dtype or jnp.float32
    s = min(cfg.seed_batch, cfg.total_restarts)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        fn = ik_mod.build_batch_solver(spec, cfg, dtype)
        args = (
            jax.ShapeDtypeStruct((b, 3, 3), dtype),
            jax.ShapeDtypeStruct((b, 3), dtype),
            jax.ShapeDtypeStruct((b, spec.num_positions), dtype),
        )
        # Pre-optimization analysis: each traced op once (see module doc).
        cost = fn.lower(*args).cost_analysis()
    lanes = float(b * s)
    return {
        "flops": float(cost.get("flops", 0.0)) / lanes,
        "transcendentals": float(cost.get("transcendentals", 0.0)) / lanes,
    }


def utilization(lane_iters: float, seconds: float, flops_per_iter: float,
                device_kind: str) -> dict:
    """Achieved model FLOP/s and its share of the float32 peak."""
    achieved = lane_iters * flops_per_iter / max(seconds, 1e-12)
    peak = device_peaks(device_kind)["f32_flops"]
    return {"model_gflops_per_s": achieved / 1e9,
            "f32_peak_gflops": peak / 1e9,
            "f32_util": achieved / peak}
