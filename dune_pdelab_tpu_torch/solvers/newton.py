"""Inexact Newton with line search for nonlinear PDE systems.

PyTorch port of dune_pdelab_tpu/solvers/newton.py, PDELab's NewtonMethod
(reference:
dune/pdelab/solver/newton.hh:63, apply loop :177-340) with:
  * defect-ratio-triggered Jacobian reuse (`reassemble_threshold`,
    reference: newton.hh prepareStep :98-120),
  * adaptive forcing terms bounding the linear reduction
    (reference: newton.hh linearSolve :145-161),
  * line-search strategies None / Hackbusch-Reusken (reference:
    dune/pdelab/solver/linesearch.hh:36,71),
  * termination on absolute + relative defect (reference:
    dune/pdelab/solver/terminate.hh:29).

Newton runs as a host-side loop over residuals and linear solves; the
matrix-free path never forms J. Defects are read on the host once per
residual (the stopping and line-search rules need them there).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass

import torch

from dune_pdelab_tpu_torch.utils.common import Timer
from dune_pdelab_tpu_torch.utils.config import ParameterTree


class NewtonError(RuntimeError):
    pass


@dataclass
class NewtonResult:
    """Statistics struct (NewtonMethod::Result analog)."""
    iterations: int = 0
    linear_solver_iterations: int = 0
    assemblies: int = 0           # Jacobian (re)linearizations performed
    assembler_time: float = 0.0
    linear_solver_time: float = 0.0
    line_search_time: float = 0.0
    first_defect: float = 0.0
    defect: float = 0.0
    conv_rate: float = 0.0
    converged: bool = False


class NewtonMethod:
    def __init__(self, gridoperator, linear_solver,
                 reduction=1e-8, absolute_limit=1e-12, max_iterations=20,
                 min_linear_reduction=1e-3, fixed_linear_reduction=False,
                 reassemble_threshold=0.0,
                 line_search="hackbusch_reusken",
                 line_search_max_iterations=10,
                 line_search_damping_factor=0.5,
                 line_search_accept_best=False,
                 terminate_on_linear_failure=False,
                 verbose=1):
        self.go = gridoperator
        self.ls = linear_solver
        self.reduction = reduction
        self.absolute_limit = absolute_limit
        self.max_iterations = max_iterations
        self.min_linear_reduction = min_linear_reduction
        self.fixed_linear_reduction = fixed_linear_reduction
        self.reassemble_threshold = reassemble_threshold
        self.line_search = line_search
        self.ls_max_it = line_search_max_iterations
        self.ls_damping = line_search_damping_factor
        self.ls_accept_best = line_search_accept_best
        self.terminate_on_linear_failure = terminate_on_linear_failure
        self.verbose = verbose
        self.result = NewtonResult()

    @classmethod
    def from_parameters(cls, gridoperator, linear_solver, ptree: ParameterTree):
        """setParameters(ParameterTree) analog (reference: newton.hh)."""
        g = ptree.get
        return cls(
            gridoperator, linear_solver,
            reduction=g("reduction", 1e-8, float),
            absolute_limit=g("absolute_limit", 1e-12, float),
            max_iterations=g("max_iterations", 20, int),
            min_linear_reduction=g("min_linear_reduction", 1e-3, float),
            fixed_linear_reduction=g("fixed_linear_reduction", False, bool),
            reassemble_threshold=g("reassemble_threshold", 0.0, float),
            line_search=g("line_search", "hackbusch_reusken"),
            line_search_max_iterations=g("line_search_max_iterations", 10, int),
            line_search_damping_factor=g("line_search_damping_factor", 0.5, float),
            verbose=g("verbose", 1, int),
        )

    def _defect(self, x, time):
        return float(torch.linalg.norm(self.go.residual(x, time)))

    def apply(self, x, time=0.0):
        """Solve r(x) = 0 starting from x (with Dirichlet data already
        interpolated). Returns the converged iterate."""
        res = self.result = NewtonResult()
        timer = Timer()
        defect = self._defect(x, time)
        res.first_defect = res.defect = defect
        prev_defect = defect
        lin_point = x
        supports_reuse = "reuse" in inspect.signature(
            self.ls.solve).parameters

        for it in range(self.max_iterations):
            if defect <= self.absolute_limit or (
                res.first_defect > 0.0
                and defect <= self.reduction * res.first_defect
            ):
                res.converged = True
                break
            # forcing term: require enough linear reduction that the
            # quadratic model can reach the target (newton.hh:145-161)
            if self.fixed_linear_reduction:
                lin_red = self.min_linear_reduction
            else:
                stop_defect = max(res.first_defect * self.reduction,
                                  self.absolute_limit)
                want = stop_defect / (10.0 * defect) if defect > 0 else 0.1
                rho = defect / prev_defect if it > 0 else 1.0
                lin_red = min(self.min_linear_reduction, max(want, rho * rho)) \
                    if it > 0 else self.min_linear_reduction
                lin_red = max(min(lin_red, self.min_linear_reduction), 1e-14)

            # defect-ratio-triggered Jacobian reuse (prepareStep analog,
            # reference: solver/newton.hh:98-120): re-linearize only when
            # the defect dropped by less than reassemble_threshold; else
            # keep solving with J(lin_point) from the previous step.
            rho = defect / prev_defect if it > 0 else 1.0
            reassemble = it == 0 or rho > self.reassemble_threshold
            if reassemble:
                lin_point = x
                res.assemblies += 1

            r = self.go.residual(x, time)
            timer.reset()
            kw = {"reuse": not reassemble} if supports_reuse else {}
            z, stats = self.ls.solve(self.go, lin_point, r, lin_red, time,
                                     **kw)
            res.linear_solver_time += timer.elapsed()
            res.linear_solver_iterations += int(stats.iterations)
            if not bool(stats.converged) and self.terminate_on_linear_failure:
                raise NewtonError("linear solver did not converge")

            timer.reset()
            x, defect = self._line_search(x, z, defect, time)
            res.line_search_time += timer.elapsed()
            res.iterations += 1
            prev_defect = res.defect
            res.defect = defect
            if self.verbose:
                red = defect / prev_defect if prev_defect > 0 else 0.0
                print(f"Newton {res.iterations:3d}: defect {defect:.6e} "
                      f"rate {red:.4e} (lin it {int(stats.iterations)})")
        else:
            if defect <= self.absolute_limit or (
                res.first_defect > 0.0
                and defect <= self.reduction * res.first_defect
            ):
                res.converged = True
        if res.iterations:
            res.conv_rate = (res.defect / res.first_defect) ** (1.0 / res.iterations) \
                if res.first_defect > 0 else 0.0
        if not res.converged:
            raise NewtonError(
                f"Newton did not converge in {self.max_iterations} iterations "
                f"(defect {res.defect:.3e})"
            )
        if self.go.cg is not None and getattr(self.go.cg, "has_affine", False):
            x = self.go.cg.prolong(x)  # conforming hanging-node values
        return x

    def _line_search(self, x, z, defect, time):
        """Returns (x_new, defect_new)."""
        if self.line_search in (None, "none"):
            x_new = x - z
            return x_new, self._defect(x_new, time)
        # Hackbusch-Reusken backtracking (linesearch.hh:71): accept first
        # lambda with defect <= (1 - lambda/4) * old defect
        lam = 1.0
        best = (x, defect)
        for _ in range(self.ls_max_it):
            x_try = x - lam * z
            d_try = self._defect(x_try, time)
            if d_try <= (1.0 - lam / 4.0) * defect:
                return x_try, d_try
            if d_try < best[1]:
                best = (x_try, d_try)
            lam *= self.ls_damping
        if self.ls_accept_best or self.line_search == "hackbusch_reusken_accept_best":
            return best
        if best[1] < defect:
            return best
        raise NewtonError("line search failed to reduce the defect")
