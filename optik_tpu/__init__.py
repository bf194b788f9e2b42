"""optik_tpu — a batched inverse-kinematics and differential-IK engine.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of kylc/optik:
serial-chain SE(3) forward kinematics with an analytic geometric Jacobian, a
TRAC-IK-style nonlinear IK solver with deterministic random restarts and
Speed/Quality solution modes, per-axis error weighting, joint limits, and a
velocity-limited differential-IK QP step.

Where the reference parallelizes with a rayon work-stealing thread pool around
NLopt/SLSQP, this engine turns restarts and pose queries into batch axes:
thousands of seeds advance in lockstep through a fixed-iteration projected
Levenberg-Marquardt solver, and winners are chosen with argmin reductions that
shard over a device mesh.
"""

from .config import SolutionMode, SolverConfig
from .robot import Robot

__version__ = "0.1.0"

__all__ = ["Robot", "SolverConfig", "SolutionMode", "__version__"]
