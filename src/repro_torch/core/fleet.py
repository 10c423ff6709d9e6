"""Fleet-scale SCOPe: T tenants' placement problems in one device dispatch.

Port of ``repro.core.fleet``. :class:`FleetEngine` batches
the AssignStage of every tenant into a single
:func:`~repro_torch.core.optassign.capacitated_assign_batch` dispatch —
ragged problems padded to ``(T, N_max, L, K)``, one batched Lagrangian
scan on ``cfg.device``, its tenant axis optionally spread over a mesh —
then finishes billing / migration bookkeeping per tenant on host.

Parity contract (pinned by ``tests/test_torch_fleet.py``): with no
*shared* fleet-wide capacity rows, every per-tenant result is
**bit-identical** to the per-tenant
:class:`~repro_torch.core.engine.PlacementEngine` path. Shared
rows (``fleet_provider_capacity_gb`` or explicit
``shared_tier_groups``/``shared_capacity_gb``) couple the tenants: one
provider's global capacity then binds the fleet total rather than each
tenant separately.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import (MigrationPlan, PlacementEngine,
                                     PlacementPlan, PlacementProblem)
from repro_torch.core.optassign import (FleetAssignment,
                                        capacitated_assign_batch,
                                        greedy_assign_batch)

__all__ = ["FleetEngine", "FleetPlan"]


@dataclasses.dataclass
class FleetPlan:
    """One fleet solve: per-tenant plans plus the fleet-level assignment."""

    plans: List[PlacementPlan]
    fleet: FleetAssignment

    @property
    def total_cents(self) -> float:
        return float(sum(p.report.total_cents for p in self.plans))


def _seq_or_scalar(x, T: int):
    """Per-tenant view of an argument that may be one scalar/array for all
    tenants or a length-T sequence of per-tenant values."""
    if isinstance(x, (list, tuple)):
        if len(x) != T:
            raise ValueError(f"expected a scalar or a length-{T} sequence, "
                             f"got length {len(x)}")
        return list(x)
    return [x] * T


class FleetEngine:
    """Batched AssignStage/BillingStage for a fleet of tenants.

    All tenants share one :class:`~repro_torch.core.costs.CostTable` and
    one :class:`~repro_torch.core.engine.ScopeConfig` (a fleet is one operator's
    pricing + policy applied to many datasets); per-tenant problems may
    have any sizes ``N_t`` including zero.

    ``fleet_provider_capacity_gb`` (``{provider_name: gb}``, multi-cloud
    tables only) is the convenience spelling of shared rows: each named
    provider's capacity caps the *fleet-wide* usage of its tiers. Explicit
    ``shared_tier_groups``/``shared_capacity_gb`` pass arbitrary shared
    rows straight to the solver. The solves run on ``cfg.device``
    (default ``"cuda"``; asking for the card where there is none raises
    here). ``mesh`` (a DeviceMesh) spreads the capacitated scan's tenant
    axis over the ranks of its first dimension; every rank gets the same
    plans, those of one device.
    """

    def __init__(self, table, cfg, *, mesh=None,
                 shared_tier_groups: Optional[np.ndarray] = None,
                 shared_capacity_gb: Optional[np.ndarray] = None,
                 fleet_provider_capacity_gb: Optional[dict] = None):
        self.mesh = mesh
        self.engine = PlacementEngine(table, cfg)
        self.table = table
        self.cfg = cfg
        if fleet_provider_capacity_gb is not None:
            if shared_tier_groups is not None or shared_capacity_gb is not None:
                raise ValueError("pass either fleet_provider_capacity_gb or "
                                 "explicit shared_tier_groups/"
                                 "shared_capacity_gb, not both")
            pnames = getattr(table, "provider_names", None)
            if pnames is None:
                raise ValueError("fleet_provider_capacity_gb requires a "
                                 "MultiCloudCostTable")
            unknown = set(fleet_provider_capacity_gb) - set(pnames)
            if unknown:
                raise ValueError(f"unknown providers {sorted(unknown)}; "
                                 f"table has {pnames}")
            caps = np.full(len(pnames), np.inf)
            for name, gb in fleet_provider_capacity_gb.items():
                caps[list(pnames).index(name)] = float(gb)
            shared_tier_groups = np.asarray(table.provider_of_tier, int)
            shared_capacity_gb = caps
        self.shared_tier_groups = shared_tier_groups
        self.shared_capacity_gb = shared_capacity_gb

    @property
    def coupled(self) -> bool:
        """True when finite shared rows actually couple the tenants."""
        return (self.shared_capacity_gb is not None
                and bool(np.isfinite(self.shared_capacity_gb).any()))

    # ------------------------------------------------------------- assign
    def assign_batch(self, problems: Sequence[PlacementProblem],
                     extra_costs: Optional[Sequence] = None,
                     locked_schemes: Optional[Sequence] = None,
                     ) -> FleetAssignment:
        """One batched solver dispatch for all tenants' assignments.

        Mirrors ``AssignStage.__call__`` exactly: the greedy batch when
        neither per-tier caps, provider caps, nor shared rows constrain
        anything, the capacitated batch otherwise.
        """
        T = len(problems)
        extra_costs = list(extra_costs) if extra_costs is not None \
            else [None] * T
        locked_schemes = list(locked_schemes) if locked_schemes is not None \
            else [None] * T
        ins = [self.engine.assign.solver_inputs(p, ec, lk)
               for p, ec, lk in zip(problems, extra_costs, locked_schemes)]
        costs = [i[0] for i in ins]
        feases = [i[1] for i in ins]
        if T == 0 or (ins[0][3] is None and ins[0][4] is None
                      and self.shared_tier_groups is None):
            assignments = greedy_assign_batch(costs, feases,
                                              device=self.cfg.device)
            feasible = all(a.feasible for a in assignments)
            cost = (float(sum(a.cost for a in assignments)) if feasible
                    else float("inf"))
            return FleetAssignment(assignments, cost, feasible, None)
        L = self.table.num_tiers
        caps = [i[3] if i[3] is not None else np.full(L, np.inf)
                for i in ins]
        tg = ins[0][4]
        gcaps = [i[5] for i in ins] if tg is not None else None
        return capacitated_assign_batch(
            costs, feases, [i[2] for i in ins], caps,
            tier_groups=tg, group_capacity_gb=gcaps,
            shared_tier_groups=self.shared_tier_groups,
            shared_capacity_gb=self.shared_capacity_gb, mesh=self.mesh,
            device=self.cfg.device)

    # -------------------------------------------------------------- solve
    def solve(self, problems: Sequence[PlacementProblem]) -> FleetPlan:
        """Assignment + billing for every tenant, one assignment dispatch."""
        fleet = self.assign_batch(problems)
        plans = [PlacementPlan(p, a, self.engine.billing(p, a))
                 for p, a in zip(problems, fleet.assignments)]
        return FleetPlan(plans, fleet)

    # --------------------------------------------------------- reoptimize
    def reoptimize(self, plans: Sequence[PlacementPlan], new_rhos: Sequence,
                   months_held=0.0, lock_unchanged: bool = True,
                   rho_rel_tol: float = 0.25, rho_abs_tol: float = 0.0,
                   rho_refs: Optional[Sequence] = None,
                   ) -> Tuple[List[MigrationPlan], FleetAssignment]:
        """T incremental migration solves in one assignment dispatch.

        Per tenant this is exactly :meth:`PlacementEngine.reoptimize` —
        the same pre-dispatch terms (drift gate, early-delete penalties,
        recompression and egress re-basing) and the same post-dispatch
        bookkeeping, with only the assignment solve batched. With no
        shared rows the returned plans are bit-identical to T independent
        ``reoptimize`` calls.
        """
        T = len(plans)
        held = _seq_or_scalar(months_held, T)
        refs = list(rho_refs) if rho_refs is not None else [None] * T
        probs2, curs, pens, extras, lockeds = [], [], [], [], []
        for t in range(T):
            prob = plans[t].problem
            new_rho = np.asarray(new_rhos[t], np.float64)
            cur_l = plans[t].assignment.tier.astype(int)
            cur_k = plans[t].assignment.scheme.astype(int)
            problem2 = dataclasses.replace(prob, rho=new_rho,
                                           current_tier=cur_l)
            ref = (np.asarray(prob.rho, np.float64) if refs[t] is None
                   else np.asarray(refs[t], np.float64))
            extra, locked, pen = self.engine._migration_terms(
                problem2, cur_l, cur_k, plans[t].stored_gb,
                np.asarray(held[t], np.float64), lock_unchanged,
                rho_rel_tol, ref, rho_abs_tol)
            probs2.append(problem2)
            curs.append((cur_l, cur_k))
            pens.append(pen)
            extras.append(extra)
            lockeds.append(locked)
        fleet = self.assign_batch(probs2, extras, lockeds)
        migs = [self.engine._finalize_migration(
                    probs2[t], fleet.assignments[t], curs[t][0], curs[t][1],
                    plans[t].stored_gb, pens[t])
                for t in range(T)]
        return migs, fleet
