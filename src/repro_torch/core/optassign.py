"""OPTASSIGN — optimal tier + compression-scheme assignment (paper §IV).

Port of ``repro.core.optassign``'s batch solvers. The device parts of the
reference (the argmin of ``greedy_assign`` and the Lagrangian dual ascent
of ``capacitated_assign``) run as torch on ``device`` in float32, as the
reference runs them in float32 under JAX's default precision; everything
else is the reference's numpy, copied.

``greedy_assign``       exact for unbounded capacities (Thm 3), O(NLK).
``matching_assign``     exact for equal-size/no-compression with capacities
                        (Thm 2) via min-cost flow, on the host.
``capacitated_assign``  general capacitated case: Lagrangian dual ascent
                        on ``device`` + argsort-based greedy repair +
                        delta-matrix 1-swap local search in numpy.
``budgeted_moves``      the migration-budget knapsack: candidates ranked on
                        ``device``, the greedy walk on the host.
``capacitated_assign_ref``  the original pure-Python solver (test oracle).
``brute_force``         exact enumeration oracle for tiny instances.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve

BIG = 1e18


@dataclasses.dataclass
class Assignment:
    tier: np.ndarray       # (N,) int
    scheme: np.ndarray     # (N,) int
    cost: float            # objective value of chosen cells
    feasible: bool         # capacity + latency respected


def _masked(cost: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    return np.where(feasible, cost, BIG)


def lock_schemes(feasible: np.ndarray, locked_scheme: np.ndarray) -> np.ndarray:
    """Paper's last ILP constraint: existing partitions keep their scheme.

    ``locked_scheme[n] == -1`` means partition n is new (free choice).
    """
    K = feasible.shape[2]
    locked = np.asarray(locked_scheme).astype(int)
    keep = (locked[:, None] < 0) | (np.arange(K)[None, :] == locked[:, None])
    return feasible & keep[:, None, :]


# --------------------------------------------------------------------- greedy
def _greedy_device(cost: np.ndarray, feasible: np.ndarray,
                   dev: torch.device) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Per-row argmin over the flattened (L, K) cells, in float32."""
    c = torch.as_tensor(cost, dtype=torch.float32, device=dev)
    f = torch.as_tensor(feasible, dtype=torch.bool, device=dev)
    masked = torch.where(f, c, torch.full((), BIG, dtype=torch.float32,
                                          device=dev))
    flat = masked.reshape(masked.shape[0], -1)
    idx = flat.argmin(dim=1)
    best = flat.gather(1, idx[:, None])[:, 0]
    K = masked.shape[2]
    return ((idx // K).cpu().numpy(), (idx % K).cpu().numpy(),
            best.cpu().numpy())


def greedy_assign(cost: np.ndarray, feasible: np.ndarray, *,
                  device: DeviceLike = "cuda") -> Assignment:
    """Exact when capacities are unbounded (Thm 3). O(NLK)."""
    dev = resolve(device)
    if cost.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return Assignment(z, z.copy(), 0.0, True)
    tier, scheme, best = _greedy_device(cost, feasible, dev)
    tier, scheme = tier.astype(int), scheme.astype(int)
    ok = bool((best < BIG).all())
    # argmin runs in f32 on device; re-total the objective in f64 for exactness
    n = np.arange(cost.shape[0])
    total = float(np.asarray(cost, np.float64)[n, tier, scheme].sum()) if ok \
        else float("inf")
    return Assignment(tier, scheme, total, ok)


# ------------------------------------------------------------------- matching
class _MCMF:
    """Successive-shortest-path min-cost max-flow (SPFA variant). Exact."""

    def __init__(self, n: int):
        self.n = n
        self.to: list[int] = []
        self.cap: list[float] = []
        self.cost: list[float] = []
        self.head: list[list[int]] = [[] for _ in range(n)]

    def add(self, u: int, v: int, cap: float, cost: float) -> None:
        self.head[u].append(len(self.to)); self.to.append(v)
        self.cap.append(cap); self.cost.append(cost)
        self.head[v].append(len(self.to)); self.to.append(u)
        self.cap.append(0.0); self.cost.append(-cost)

    def run(self, s: int, t: int):
        flow = cost = 0.0
        INF = float("inf")
        while True:
            dist = [INF] * self.n
            in_q = [False] * self.n
            prev_e = [-1] * self.n
            dist[s] = 0.0
            queue = collections.deque([s])
            in_q[s] = True
            while queue:
                u = queue.popleft()
                in_q[u] = False
                for e in self.head[u]:
                    if self.cap[e] > 1e-12 and dist[u] + self.cost[e] < dist[self.to[e]] - 1e-12:
                        dist[self.to[e]] = dist[u] + self.cost[e]
                        prev_e[self.to[e]] = e
                        if not in_q[self.to[e]]:
                            queue.append(self.to[e])
                            in_q[self.to[e]] = True
            if dist[t] == INF:
                return flow, cost
            # bottleneck
            push, v = INF, t
            while v != s:
                e = prev_e[v]
                push = min(push, self.cap[e])
                v = self.to[e ^ 1]
            v = t
            while v != s:
                e = prev_e[v]
                self.cap[e] -= push
                self.cap[e ^ 1] += push
                v = self.to[e ^ 1]
            flow += push
            cost += push * dist[t]


def matching_assign(cost_nl: np.ndarray, feasible_nl: np.ndarray,
                    capacity_units: np.ndarray) -> Assignment:
    """Equal-size partitions, no compression (Thm 2).

    Min-weight bipartite matching of N unit-size partitions onto Z_l tier
    copies; the tier-copy graph collapses to a transportation problem solved
    exactly by min-cost max-flow (source -> partition -> tier -> sink).
    """
    N, L = cost_nl.shape
    cost = _masked(cost_nl, feasible_nl)
    cap = np.minimum(capacity_units.astype(np.float64), N)
    S, T = N + L, N + L + 1
    g = _MCMF(N + L + 2)
    for n in range(N):
        g.add(S, n, 1.0, 0.0)
        for l in range(L):
            if cost[n, l] < BIG:
                g.add(n, N + l, 1.0, float(cost[n, l]))
    for l in range(L):
        g.add(N + l, T, float(cap[l]), 0.0)
    flow, total = g.run(S, T)
    if flow < N - 1e-9:
        return Assignment(np.full(N, -1), np.zeros(N, int), float("inf"), False)
    assign = np.full(N, -1, np.int64)
    for n in range(N):
        for e in g.head[n]:
            v = g.to[e]
            if N <= v < N + L and e % 2 == 0 and g.cap[e] < 0.5:
                assign[n] = v - N
    return Assignment(assign, np.zeros(N, int), float(total), True)


# ---------------------------------------------------------------- capacitated
def _chosen_usage(stored_gb: np.ndarray, tier: np.ndarray,
                  scheme: np.ndarray) -> np.ndarray:
    """Per-tier GB occupied by the chosen (tier, scheme) cells, shape (L,)."""
    use = np.zeros(stored_gb.shape[1])
    np.add.at(use, tier, stored_gb[np.arange(tier.shape[0]), tier, scheme])
    return use


def _constraint_rows(capacity_gb: np.ndarray,
                     tier_groups: Optional[np.ndarray],
                     group_capacity_gb: Optional[np.ndarray],
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Capacity constraints as a membership matrix ``A`` (C, L) + caps (C,).

    Rows 0..L-1 are the per-tier capacities (identity); optional group rows
    (e.g. per-provider totals over a block of flat tiers in the multi-cloud
    placement space) follow. A constraint is ``A[c] @ use <= cap_all[c]``.
    """
    if (tier_groups is None) != (group_capacity_gb is None):
        raise ValueError("tier_groups and group_capacity_gb must be "
                         "passed together")
    L = capacity_gb.shape[0]
    A = np.eye(L, dtype=bool)
    cap_all = np.asarray(capacity_gb, np.float64)
    if tier_groups is not None:
        g = np.asarray(tier_groups, int)
        gcap = np.asarray(group_capacity_gb, np.float64)
        G = gcap.shape[0]
        if g.min() < 0 or g.max() >= G:
            raise ValueError(f"tier_groups ids must lie in [0, {G}) to "
                             f"match group_capacity_gb")
        A = np.concatenate([A, np.arange(G)[:, None] == g[None, :]], 0)
        cap_all = np.concatenate([cap_all, gcap])
    return A, cap_all


def _lagrangian_scan(masked: np.ndarray, stored: np.ndarray, cap: np.ndarray,
                     group_of_tier: np.ndarray, gcap: np.ndarray,
                     step0: float, iters: int,
                     dev: torch.device) -> np.ndarray:
    """Dual ascent over all N*L*K cells on ``dev``; one candidate per step.

    Dualizes both the per-tier capacities and the group (per-provider)
    capacities: a tier's effective multiplier is its own lambda plus its
    group's. Runs in float32 like the reference's jitted scan. Per-tier and
    per-group usage are summed through one-hot masks and ``sum(0)``, a
    reduction whose order is fixed (float atomics, as in ``index_add_``,
    would change the low bits from run to run). Returns the (iters, N)
    flat cell indices.
    """
    f32 = torch.float32
    N, L, K = masked.shape
    G = gcap.shape[0]
    m = torch.as_tensor(masked, dtype=f32, device=dev)
    s = torch.as_tensor(stored, dtype=f32, device=dev)
    cap_t = torch.as_tensor(cap, dtype=f32, device=dev)
    gcap_t = torch.as_tensor(gcap, dtype=f32, device=dev)
    finite_cap = torch.isfinite(cap_t)
    finite_gcap = torch.isfinite(gcap_t)
    g_of_t = torch.as_tensor(group_of_tier, dtype=torch.long, device=dev)
    tier_of = torch.arange(L, device=dev)
    in_group = g_of_t[:, None] == torch.arange(G, device=dev)[None, :]
    flat_cost = m.reshape(N, -1)
    flat_stored = s.reshape(N, -1)
    step = torch.tensor(step0, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    lam = torch.zeros(L + G, dtype=f32, device=dev)
    cells = torch.empty((iters, N), dtype=torch.long, device=dev)
    for it in range(iters):
        eff = lam[:L] + lam[L:][g_of_t]
        adj = flat_cost + (eff[None, :, None] * s).reshape(N, -1)
        idx = adj.argmin(dim=1)
        chosen = flat_stored.gather(1, idx[:, None])[:, 0]
        on_tier = (idx // K)[:, None] == tier_of[None, :]             # (N, L)
        use = torch.where(on_tier, chosen[:, None], zero).sum(0)
        use_g = torch.where(in_group, use[:, None], zero).sum(0)
        grad = torch.cat([torch.where(finite_cap, use - cap_t, zero),
                          torch.where(finite_gcap, use_g - gcap_t, zero)])
        rate = step / (1.0 + torch.tensor(float(it), dtype=f32, device=dev))
        lam = torch.clamp_min(lam + rate * grad, 0.0)
        cells[it] = idx
    return cells.cpu().numpy()

def _repair_vec(tier: np.ndarray, scheme: np.ndarray, masked: np.ndarray,
                stored: np.ndarray, A: np.ndarray, cap_all: np.ndarray,
                finite_all: np.ndarray) -> Optional[np.ndarray]:
    """Argsort-based greedy repair: evict cheapest-delta members of the most
    over-capacity constraint (a tier, or a group such as a provider) until
    every finite capacity is respected."""
    N, L, K = masked.shape
    use = _chosen_usage(stored, tier, scheme)
    Af = A & finite_all[:, None]                    # (C, L)
    A_f = A.astype(np.float64)
    for _ in range(4 * N + 8):
        # einsum, not @: the reference accumulates in this exact
        # ascending-l order, so decisions agree bitwise
        use_c = np.einsum("cl,l->c", A_f, use)
        over = np.where(finite_all & (use_c > cap_all + 1e-9))[0]
        if over.size == 0:
            return use
        c = over[np.argmax((use_c - cap_all)[over])]
        in_c = A[c]                                 # (L,) tiers in constraint
        members = np.where(in_c[tier])[0]
        if members.size == 0:
            return None
        cur = masked[members, tier[members], scheme[members]]
        # per-tier room = tightest finite constraint containing that tier
        slack_c = np.where(finite_all, cap_all - use_c, np.inf)
        room = np.where(Af, slack_c[:, None], np.inf).min(0)         # (L,)
        ok = (masked[members] < BIG) & (stored[members]
                                        <= room[None, :, None] + 1e-9)
        ok[:, in_c, :] = False                      # must leave the constraint
        delta = np.where(ok, masked[members] - cur[:, None, None],
                         np.inf).reshape(members.size, -1)
        best_cell = delta.argmin(1)
        best_delta = delta[np.arange(members.size), best_cell]
        moved = False
        for m in np.argsort(best_delta):
            if use_c[c] <= cap_all[c] + 1e-9:
                break
            if not np.isfinite(best_delta[m]):
                break
            l2, k2 = divmod(int(best_cell[m]), K)
            n = int(members[m])
            room2 = np.where(Af[:, l2], cap_all - use_c, np.inf).min() \
                if Af[:, l2].any() else np.inf
            if stored[n, l2, k2] > room2 + 1e-9:
                continue             # room shrank this batch; retry next round
            l1 = tier[n]
            s1, s2 = stored[n, l1, scheme[n]], stored[n, l2, k2]
            use[l1] -= s1
            use[l2] += s2
            use_c += A[:, l2] * s2 - A[:, l1] * s1
            tier[n], scheme[n] = l2, k2
            moved = True
        if not moved:
            return None
    return None


def _local_search_vec(tier: np.ndarray, scheme: np.ndarray, use: np.ndarray,
                      masked: np.ndarray, stored: np.ndarray, A: np.ndarray,
                      cap_all: np.ndarray, finite_all: np.ndarray) -> None:
    """Best-improvement 1-swap descent with a full (N,L,K) delta matrix,
    at most ``8 * N + 64`` moves."""
    N, L, K = masked.shape
    n_idx = np.arange(N)
    Af = A & finite_all[:, None]                    # (C, L)
    A_f = A.astype(np.float64)
    any_finite = bool(finite_all.any())
    for _ in range(8 * N + 64):
        cur = masked[n_idx, tier, scheme]
        stored_cur = stored[n_idx, tier, scheme]
        if any_finite:
            # einsum, not @: the reference accumulates in this exact
            # ascending-l order, so trajectories agree bitwise
            use_c = np.einsum("cl,l->c", A_f, use)
            # slack[n, c]: room left in constraint c once n vacates its cell
            slack = ((cap_all - use_c)[None, :]
                     + A[:, tier].T * stored_cur[:, None])           # (N, C)
            # per-destination room = tightest finite constraint containing it
            room = np.where(Af[None, :, :], slack[:, :, None],
                            np.inf).min(1)                           # (N, L)
            ok = (masked < BIG) & (stored <= room[:, :, None] + 1e-9)
        else:
            ok = masked < BIG
        delta = np.where(ok, masked - cur[:, None, None], np.inf)
        j = int(delta.argmin())
        n, rem = divmod(j, L * K)
        l2, k2 = divmod(rem, K)
        if not delta[n, l2, k2] < -1e-12:
            break
        use[tier[n]] -= stored[n, tier[n], scheme[n]]
        use[l2] += stored[n, l2, k2]
        tier[n], scheme[n] = l2, k2


def _step0(masked: np.ndarray, cap_all: np.ndarray,
           finite_all: np.ndarray) -> float:
    """Dual-ascent step size heuristic: mean finite cell cost over mean
    finite capacity. Guarded against the all-infinite-capacity and
    empty-finite-cells corners so it never divides by an empty mean."""
    finite_cells = masked[masked < BIG]
    if not (finite_all.any() and finite_cells.size):
        return 0.0
    return float(finite_cells.mean() / max(cap_all[finite_all].mean(), 1e-9))


def _dedupe_candidates(rows, max_candidates: int) -> List[np.ndarray]:
    """Distinct relaxed assignments emitted by the dual ascent, in emission
    order, truncated head/tail to ``max_candidates``."""
    uniq, seen = [], set()
    for row_ in rows:
        key = row_.tobytes()
        if key not in seen:
            seen.add(key)
            uniq.append(np.asarray(row_, np.int64))
    if len(uniq) > max_candidates:
        head = max_candidates // 4
        uniq = uniq[:head] + uniq[-(max_candidates - head):]
    return uniq

def _best_from_candidates(uniq: List[np.ndarray], masked: np.ndarray,
                          stored: np.ndarray, A: np.ndarray,
                          cap_all: np.ndarray,
                          finite_all: np.ndarray) -> Assignment:
    """Repair + polish every candidate cell vector, keep the best f64 score."""
    N, _, K = masked.shape
    best: Optional[Assignment] = None
    fallback: Optional[Tuple[np.ndarray, np.ndarray]] = None
    for cand in uniq:
        tier, scheme = cand // K, cand % K
        if fallback is None:
            fallback = (tier.copy(), scheme.copy())
        use = _repair_vec(tier, scheme, masked, stored, A, cap_all,
                          finite_all)
        if use is None:
            continue
        _local_search_vec(tier, scheme, use, masked, stored, A, cap_all,
                          finite_all)
        total = float(masked[np.arange(N), tier, scheme].sum())
        if total < BIG and (best is None or total < best.cost):
            best = Assignment(tier.copy(), scheme.copy(), total, True)
    if best is None:
        tier, scheme = fallback if fallback is not None else (
            np.zeros(N, np.int64), np.zeros(N, np.int64))
        return Assignment(tier, scheme, float("inf"), False)
    return best


def capacitated_assign(
    cost: np.ndarray,            # (N,L,K)
    feasible: np.ndarray,        # (N,L,K)
    stored_gb: np.ndarray,       # (N,L,K) size occupied if cell chosen
    capacity_gb: np.ndarray,     # (L,)
    iters: int = 200,
    seed: int = 0,
    max_candidates: int = 16,
    tier_groups: Optional[np.ndarray] = None,       # (L,) group id per tier
    group_capacity_gb: Optional[np.ndarray] = None,  # (G,)
    sla_penalty: Optional[np.ndarray] = None,        # (N,L,K) violation units
    sla_lambda: float = 0.0,
    *,
    device: DeviceLike = "cuda",
) -> Assignment:
    """Vectorized capacitated OPTASSIGN.

    The Lagrangian inner solves run as a loop of ``iters`` float32 steps on
    ``device``; the distinct relaxed assignments it emits are then repaired
    (argsort eviction) and polished (delta-matrix 1-swap descent) in
    vectorized NumPy, scoring in f64. Matches :func:`brute_force` on tiny
    instances.

    ``tier_groups``/``group_capacity_gb`` add group capacity constraints on
    top of the per-tier ones: ``sum(use[tier_groups == g]) <= group_cap[g]``.
    This is how per-provider capacity rows of the flattened multi-cloud
    ``(provider, tier)`` space enter the solver — each group is one
    provider's block of flat tiers.

    ``sla_penalty``/``sla_lambda`` extend the objective to ``cost +
    sla_lambda * sla_penalty`` (soft per-partition latency SLAs,
    :func:`repro_torch.core.costs.sla_penalty_tensor`): the weighted
    penalty rides through the Lagrangian scan, the repair, and the 1-swap
    polish exactly like cost. ``sla_lambda=0`` (or no penalty) leaves
    every array untouched.
    """
    dev = resolve(device)
    if sla_lambda and sla_penalty is not None:
        cost = (np.asarray(cost, np.float64)
                + float(sla_lambda) * np.asarray(sla_penalty, np.float64))
    N, L, K = cost.shape
    masked = _masked(np.asarray(cost, np.float64), feasible)
    stored = np.asarray(stored_gb, np.float64)
    cap = np.asarray(capacity_gb, np.float64)
    A, cap_all = _constraint_rows(cap, tier_groups, group_capacity_gb)
    finite_all = np.isfinite(cap_all)

    if N == 0:
        z = np.zeros(0, np.int64)
        return Assignment(z, z.copy(), 0.0, True)

    # lam=0 greedy = the unconstrained optimum; if it fits the capacities it
    # is optimal outright and the dual ascent can be skipped entirely.
    cell0 = masked.reshape(N, -1).argmin(1)
    tier0, scheme0 = cell0 // K, cell0 % K
    use0 = _chosen_usage(stored, tier0, scheme0)
    if (~finite_all | (A @ use0 <= cap_all + 1e-9)).all():
        total = float(masked[np.arange(N), tier0, scheme0].sum())
        ok = bool(total < BIG)
        return Assignment(tier0, scheme0, total if ok else float("inf"), ok)

    step0 = _step0(masked, cap_all, finite_all)
    if tier_groups is None:
        g_of_t = np.zeros(L, np.int32)
        gcap = np.array([np.inf])
    else:
        g_of_t = np.asarray(tier_groups, np.int32)
        gcap = np.asarray(group_capacity_gb, np.float64)
    cells = _lagrangian_scan(masked, stored, cap, g_of_t, gcap, step0,
                             iters, dev)

    uniq = _dedupe_candidates(cells, max_candidates)
    return _best_from_candidates(uniq, masked, stored, A, cap_all,
                                 finite_all)


def capacitated_assign_ref(
    cost: np.ndarray,            # (N,L,K)
    feasible: np.ndarray,        # (N,L,K)
    stored_gb: np.ndarray,       # (N,L,K) size occupied if cell chosen
    capacity_gb: np.ndarray,     # (L,)
    iters: int = 200,
    seed: int = 0,
) -> Assignment:
    """Pure-Python reference: Lagrangian + repair + local search (original)."""
    N, L, K = cost.shape
    masked = _masked(cost, feasible)
    lam = np.zeros(L)
    cap = capacity_gb.copy()
    finite_cap = np.isfinite(cap)
    best: Optional[Assignment] = None
    step0 = masked[masked < BIG].mean() / max(cap[finite_cap].mean(), 1e-9) \
        if finite_cap.any() else 0.0

    def solve(lam_vec: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        adj = masked + (lam_vec[None, :, None] * stored_gb)
        flat = adj.reshape(N, -1)
        idx = flat.argmin(1)
        return idx // K, idx % K

    def repair_and_score(tier: np.ndarray, scheme: np.ndarray) -> Assignment:
        tier, scheme = tier.copy(), scheme.copy()
        use = _chosen_usage(stored_gb, tier, scheme)
        # Greedy repair: move cheapest-delta items out of over-capacity tiers.
        for l in np.argsort(-(use - cap)):
            while finite_cap[l] and use[l] > cap[l] + 1e-9:
                members = [n for n in range(N) if tier[n] == l]
                best_mv, best_delta = None, np.inf
                for n in members:
                    cur = masked[n, l, scheme[n]]
                    for l2 in range(L):
                        if l2 == l:
                            continue
                        for k2 in range(K):
                            if masked[n, l2, k2] >= BIG:
                                continue
                            room = cap[l2] - use[l2] if finite_cap[l2] else np.inf
                            if stored_gb[n, l2, k2] > room + 1e-9:
                                continue
                            delta = masked[n, l2, k2] - cur
                            if delta < best_delta:
                                best_delta, best_mv = delta, (n, l2, k2)
                if best_mv is None:
                    return Assignment(tier, scheme, float("inf"), False)
                n, l2, k2 = best_mv
                use[l] -= stored_gb[n, l, scheme[n]]
                use[l2] += stored_gb[n, l2, k2]
                tier[n], scheme[n] = l2, k2
        # 1-move local search
        improved = True
        while improved:
            improved = False
            for n in range(N):
                cur_c = masked[n, tier[n], scheme[n]]
                for l2 in range(L):
                    for k2 in range(K):
                        if masked[n, l2, k2] >= cur_c - 1e-12:
                            continue
                        new_use_l2 = use[l2] + stored_gb[n, l2, k2] \
                            - (stored_gb[n, tier[n], scheme[n]] if l2 == tier[n] else 0)
                        if finite_cap[l2] and new_use_l2 > cap[l2] + 1e-9:
                            continue
                        use[tier[n]] -= stored_gb[n, tier[n], scheme[n]]
                        use[l2] += stored_gb[n, l2, k2]
                        tier[n], scheme[n] = l2, k2
                        improved = True
                        break
                    else:
                        continue
                    break
        total = float(sum(masked[n, tier[n], scheme[n]] for n in range(N)))
        ok = total < BIG
        return Assignment(tier, scheme, total if ok else float("inf"), ok)

    for it in range(iters):
        tier, scheme = solve(lam)
        cand = repair_and_score(tier, scheme)
        if cand.feasible and (best is None or cand.cost < best.cost):
            best = cand
        use = _chosen_usage(stored_gb, tier, scheme)
        grad = np.where(finite_cap, use - cap, 0.0)
        if np.all(grad <= 1e-9) and it > 0:
            break
        lam = np.maximum(0.0, lam + step0 / (1 + it) * grad)
    if best is None:
        tier, scheme = solve(lam)
        best = repair_and_score(tier, scheme)
    return best


# ------------------------------------------------------------ budgeted moves
def _knapsack_scan(order: np.ndarray, cents: np.ndarray, gb: np.ndarray,
                   ok: np.ndarray, cap_cents: float,
                   cap_gb: float) -> np.ndarray:
    """Greedy knapsack walk over pre-ranked items, in float32 on the host.

    Items arrive in ``order`` (best ratio first); each is taken iff it is
    eligible and fits both remaining budgets. Returns take flags in walk
    order (scatter back through ``order``).

    The reference runs this walk as a jitted float32 ``lax.scan``. It is
    the one such scan that the port runs on the host: each item depends on
    the budgets the one before left, so on the device it would be a loop
    of about six launches per item (600,000 at N = 100,000). ``np.float32``
    scalars give the scan's bits: every subtraction and comparison is one
    float32 operation, as in the scan.
    """
    f32 = np.float32
    c = np.asarray(cents, np.float64).astype(f32)[order]
    g = np.asarray(gb, np.float64).astype(f32)[order]
    elig = np.asarray(ok, bool)[order]
    tol = f32(1e-9)
    rem_c, rem_g = f32(cap_cents), f32(cap_gb)
    takes = np.zeros(order.shape[0], bool)
    for i in np.flatnonzero(elig):
        ci, gi = c[i], g[i]
        if ci <= rem_c + tol and gi <= rem_g + tol:
            takes[i] = True
            rem_c = rem_c - ci
            rem_g = rem_g - gi
    return takes


def _exact_moves(savings: np.ndarray, cents: np.ndarray, gb: np.ndarray,
                 cand: np.ndarray, budget_cents: float, budget_gb: float,
                 ) -> np.ndarray:
    """Exact subset enumeration (vectorized bit-matrix), tiny instances only.

    Maximizes total (priority-weighted) savings subject to both caps;
    ties broken toward the cheaper subset, then the lexicographically
    first one, so the result is deterministic."""
    idx = np.where(cand)[0]
    n = idx.size
    M = ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1).astype(bool)
    tot_c = M @ cents[idx]
    tot_g = M @ gb[idx]
    obj = M @ savings[idx]
    feas = (tot_c <= budget_cents + 1e-9) & (tot_g <= budget_gb + 1e-9)
    obj = np.where(feas, obj, -np.inf)
    # lexsort keys: last key is primary — max obj, then min cost, then the
    # smallest subset id (M rows are already in lexicographic order)
    best = int(np.lexsort((np.arange(1 << n), tot_c, -obj))[0])
    keep = np.zeros(savings.shape[0], bool)
    keep[idx[M[best]]] = True
    return keep


def budgeted_moves(
    savings_cents: np.ndarray,   # (N,) projected steady-state saving per move
    move_cents: np.ndarray,      # (N,) one-off charge per move (cents)
    budget_cents: float,         # per-cycle cents cap (np.inf = unbounded)
    *,
    candidates: Optional[np.ndarray] = None,   # (N,) bool; None = all
    move_gb: Optional[np.ndarray] = None,      # (N,) bytes leaving their cell
    budget_gb: float = np.inf,                 # per-cycle GB cap
    priority: Optional[np.ndarray] = None,     # (N,) aging boost (>= 1)
    method: str = "auto",                      # 'auto' | 'greedy' | 'exact'
    exact_max: int = 12,
    paid_cents: Optional[np.ndarray] = None,   # (N,) credit already banked
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Select which candidate migrations to execute under a per-cycle budget.

    The savings-per-migration-cent knapsack of the re-optimization daemon:
    maximize total projected steady-state savings subject to a cents cap
    (and optionally a GB cap) on the one-off migration spend. The
    production path is a greedy-ratio walk: rank every candidate by
    ``priority * savings / cents`` on ``device`` (a stable argsort of the
    float32 ratios, as the reference ranks them), then take items in rank
    order while they fit both budgets (:func:`_knapsack_scan`, on the
    host). ``method='exact'`` enumerates subsets instead (tiny
    instances; the validation oracle for the greedy path). ``'auto'``
    uses the exact path when there are at most ``exact_max`` candidates.

    Zero-cost moves rank first and never consume budget; with both caps
    infinite every candidate is selected (the daemon's parity mode).
    Candidates with non-positive projected savings stay eligible — the
    assignment solver already justified the move (its objective sees
    constraint and one-off terms this per-cell projection does not), and
    selection only schedules spend — but their selection value is floored
    at a priority-scaled epsilon, so they rank below every
    positive-savings candidate on BOTH paths and only fill leftover
    budget. Returns an (N,) boolean mask — always a subset of
    ``candidates``.

    ``paid_cents`` is per-move credit already banked by earlier cycles
    (the daemon's amortized move-splitting): each candidate is weighed
    against the budgets at its *residual* charge ``max(move_cents -
    paid_cents, 0)``, so an oversized move whose installments have
    accumulated eventually fits the per-cycle cap and lands.
    """
    dev = resolve(device)
    s = np.asarray(savings_cents, np.float64)
    c = np.asarray(move_cents, np.float64)
    if paid_cents is not None:
        c = np.maximum(c - np.asarray(paid_cents, np.float64), 0.0)
    N = s.shape[0]
    cand = (np.ones(N, bool) if candidates is None
            else np.asarray(candidates, bool).copy())
    g = (np.zeros(N) if move_gb is None
         else np.asarray(move_gb, np.float64))
    pr = np.ones(N) if priority is None else np.asarray(priority, np.float64)
    if N == 0 or not cand.any():
        return np.zeros(N, bool)
    if np.isinf(budget_cents) and np.isinf(budget_gb):
        return cand
    if method not in ("auto", "greedy", "exact"):
        raise ValueError(f"unknown method {method!r}")
    val = pr * s
    val = np.where(val > 0, val, 1e-9 * pr)   # take-if-fits, ranked last
    if method == "exact" or (method == "auto"
                             and int(cand.sum()) <= exact_max):
        return _exact_moves(val, c, g, cand, budget_cents, budget_gb)

    ratio = np.where(cand, val / np.maximum(c, 1e-12), -np.inf)
    key = torch.as_tensor(ratio, dtype=torch.float32, device=dev)
    order = torch.argsort(-key, stable=True).cpu().numpy()
    takes = _knapsack_scan(order, c, g, cand, budget_cents, budget_gb)
    keep = np.zeros(N, bool)
    keep[order] = takes
    keep &= cand
    # the scan ran in f32; re-walk the selected set in f64 and shed the
    # worst-ratio items if rounding let the total creep past a cap
    while keep.any() and (c[keep].sum() > budget_cents + 1e-9
                          or g[keep].sum() > budget_gb + 1e-9):
        sel = np.where(keep)[0]
        keep[sel[np.argmin(ratio[sel])]] = False
    return keep


# ---------------------------------------------------------------- brute force
def brute_force(cost: np.ndarray, feasible: np.ndarray,
                stored_gb: Optional[np.ndarray] = None,
                capacity_gb: Optional[np.ndarray] = None,
                tier_groups: Optional[np.ndarray] = None,
                group_capacity_gb: Optional[np.ndarray] = None) -> Assignment:
    """Exact oracle by enumeration — only for tiny test instances."""
    if (tier_groups is None) != (group_capacity_gb is None):
        raise ValueError("tier_groups and group_capacity_gb must be "
                         "passed together")
    N, L, K = cost.shape
    masked = _masked(cost, feasible)
    cells = [[(l, k) for l in range(L) for k in range(K)
              if masked[n, l, k] < BIG] for n in range(N)]
    best_cost, best_pick = float("inf"), None
    for pick in itertools.product(*cells):
        if capacity_gb is not None or group_capacity_gb is not None:
            use = np.zeros(L)
            for n, (l, k) in enumerate(pick):
                use[l] += stored_gb[n, l, k]
            if capacity_gb is not None and np.any(use > capacity_gb + 1e-9):
                continue
            if group_capacity_gb is not None:
                g = np.asarray(tier_groups, int)
                gcap = np.asarray(group_capacity_gb, np.float64)
                use_g = np.zeros(gcap.shape[0])
                np.add.at(use_g, g, use)
                if np.any(use_g > gcap + 1e-9):
                    continue
        c = sum(masked[n, l, k] for n, (l, k) in enumerate(pick))
        if c < best_cost:
            best_cost, best_pick = c, pick
    if best_pick is None:
        return Assignment(np.zeros(N, int), np.zeros(N, int), float("inf"), False)
    tier = np.array([l for l, _ in best_pick])
    scheme = np.array([k for _, k in best_pick])
    return Assignment(tier, scheme, float(best_cost), True)
