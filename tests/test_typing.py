"""Executable typing gate for the public surface.

mypy is not installable in the build environment (artifacts/typing_r04.md
records the attempts; the CI job runs it where pip works), so this test
EVALUATES every public annotation instead: ``typing.get_type_hints``
resolves each one at runtime, catching undefined names, typos, and broken
forward references (NameError/TypeError on eval).  This is weaker than
mypy's static analysis — e.g. the r4 ``__import__``-call annotation
evaluates fine at runtime and only mypy rejects it — but it is the
strongest typing gate this environment can EXECUTE, and it pins the
public surface as annotated at all.  Reference parity target: the
reference ships a fully-annotated stub (optik.pyi:9-49).
"""

import inspect
import typing

import pytest

import optik_tpu
from optik_tpu import config as config_mod
from optik_tpu import robot as robot_mod
from optik_tpu.solver import ik as ik_mod


def _check_callable(fn, where):
    try:
        hints = typing.get_type_hints(fn)
    except Exception as exc:  # invalid annotation expression
        pytest.fail(f"{where}: annotation failed to evaluate: {exc!r}")
    return hints


def test_public_robot_annotations_evaluate():
    cls = robot_mod.Robot
    for name, member in inspect.getmembers(cls):
        if name.startswith("_"):
            continue
        if inspect.isfunction(member):
            _check_callable(member, f"Robot.{name}")


def test_config_annotations_evaluate():
    hints = typing.get_type_hints(config_mod.SolverConfig)
    # Every reference SolverConfig field is present and annotated
    # (config.rs:22-50 + the batch-budget extensions).
    for field in ("solution_mode", "max_time", "max_restarts", "tol_f",
                  "tol_df", "tol_dx", "linear_weight", "angular_weight",
                  "max_iters", "seed_batch", "rng_seed"):
        assert field in hints, f"SolverConfig.{field} missing annotation"


def test_module_surface_annotations_evaluate():
    for mod, names in ((robot_mod, ("_parse_pose", "_pose_to_mat")),
                       (ik_mod, ("build_batch_solver", "ik_one",
                                 "ik_batch", "restart_seeds"))):
        for name in names:
            fn = getattr(mod, name)
            target = getattr(fn, "__wrapped__", fn)
            if inspect.isfunction(target):
                _check_callable(target, f"{mod.__name__}.{name}")


def test_package_exports_exist():
    for name in ("Robot", "SolverConfig", "SolutionMode"):
        assert hasattr(optik_tpu, name)
    # py.typed marker ships with the package (PEP 561).
    import pathlib

    assert (pathlib.Path(optik_tpu.__file__).parent / "py.typed").exists()
