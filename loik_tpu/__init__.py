"""loik_tpu — a batched constrained differential inverse kinematics engine.

A from-scratch JAX/XLA rebuild of the capabilities of
Simple-Robotics/LoIK (RSS 2024 "Linear-time Differential Inverse Kinematics:
an Augmented Lagrangian Perspective"): first-order ADMM over Riccati-like
linear-time sweeps of the kinematic tree, with hard 6-D task equality
constraints and joint-velocity box constraints.

Two solver tiers, mirroring the reference's reference/optimized split
(SURVEY.md §1):

- ``loik_tpu.oracle``  — dense, single-problem, f64 solver whose residuals
  come from the literal OSQP-form QP matrices; the semantic specification.
- ``loik_tpu.solver``  — the production path: batched structure-of-arrays
  state with a trailing batch dim, trace-time-unrolled tree
  sweeps, masked ``lax.while_loop`` termination, per-problem penalty
  adaptation; validated pass-by-pass against the oracle.
"""

from . import spatial
from .api import DiffIkSolver
from .model import KinematicTree, load_urdf, make_tree, robots
from .params import MuUpdateStrat, SolverParams
from .problem import IkProblem, make_problem
from .solver import solve
from .solver.refine import (solve_delta_duals, solve_delta_refined,
                            solve_two_stage)
from .solver.state import SolveResult, SolverState
from .solver.diff import solve_unrolled
from .solver.stream import StreamResult, solve_stream
from .solver.clik import ClikResult, solve_clik

__version__ = "0.1.0"
