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
``capacitated_assign_batch``  the fleet path: T ragged tenant problems padded
                        into one (T, N_max, L, K) batch and solved by one
                        batched dual ascent on ``device``, then a lockstep
                        host finish. Bit-identical per tenant to
                        ``capacitated_assign`` when no *shared* (fleet-wide)
                        capacity rows couple the tenants.
``greedy_assign_batch`` batched unbounded path, one argmin for T tenants.
``budgeted_moves``      the migration-budget knapsack: candidates ranked on
                        ``device``, the greedy walk on the host.
``capacitated_assign_ref``  the original pure-Python solver (test oracle).
``brute_force``         exact enumeration oracle for tiny instances.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import ctx
from repro_torch.kernels import ops

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
    """Per-row argmin over the flattened (L, K) cells, in float32: the
    batched argmin for a fleet of one."""
    tier, scheme, best = _greedy_device_batch(cost[None], feasible[None], dev)
    return tier[0], scheme[0], best[0]


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


def _fleet_scan(masked_b: np.ndarray, stored_b: np.ndarray,
                cap_b: np.ndarray, group_of_tier: np.ndarray,
                gcap_b: np.ndarray, sgroup_of_tier: np.ndarray,
                scap: np.ndarray, step0_b: np.ndarray, sstep0: float,
                iters: int, dev: torch.device, group=None) -> np.ndarray:
    """Batched dual ascent over a padded tenant batch (T, N, L, K) on
    ``dev``; one candidate per tenant per step. Returns the
    (iters, T, N) int32 flat cell indices, copied to the host once.
    With a process ``group`` the batch is this rank's tenants of a fleet
    spread over the group (:func:`_run_fleet_scan`): the shared rows sum
    over every rank's tenants.

    Each tenant's body is :func:`_lagrangian_scan`'s: float32 costs,
    stored bytes and multipliers, ``step0 / (1 + it)`` with ``it`` a
    float32 step count, per-tier and per-group multipliers. On top ride
    the *shared* fleet-wide rows: ``sgroup_of_tier`` maps each tier to a
    shared group whose usage is summed over the whole tenant axis and
    dualized by one fleet-global multiplier vector.

    Each tenant's per-tier usage is summed as the reference sums it: in
    float32, row after row, each addition rounded (its scatter-add on the
    CPU, ``.at[t_idx, idx // K].add(chosen)``), by ``ops.usage_sum``: the
    ``usage_sum`` CUDA kernel on the card, one thread per (tenant, tier),
    and ``np.add.at`` in float32 on the CPU, the same bits. The per-group
    usage adds a tenant's tier usages in tier order in float32, as the
    reference's second scatter-add does. So the multipliers, and the
    cells, are the reference's at every step, and a tenant gets the same
    cells alone or in any fleet (padding rows carry BIG cost and zero
    stored bytes and add exactly 0.0). The order of a tenant's rows
    reaches its sums, as it does in the reference.

    The sum over tenants for the shared rows stays exact: the float32
    terms are accumulated in float64 and the sum rounded once to float32.
    The reference sums over tenants with ``use.sum(0)``, in an order that
    XLA chooses and does not document, so no order can be matched there
    (ROADMAP queue 3). A float64 sum of n float32 terms is exact when n
    times the largest over the smallest nonzero term is at most 2**28
    (every partial sum is then a multiple of the smallest term's ulp,
    below 2**53 of them), and an exact sum has no order: the shared
    multipliers are the same on the card and on the CPU. Past that bound
    the float64 sums of two orders differ by at most about n * 2**-53 of
    the terms' total, and round to different float32 values only where
    they straddle a float32 rounding boundary. Over a ``group`` each rank
    sums its tenants' terms in float64, and the ranks' float64 sums are
    all-reduced (SUM, in float64) before the one rounding: still exact
    under the same condition, with n the whole fleet's count, so a
    sharded fleet takes the multipliers of one device. With no finite
    shared cap the shared multipliers stay exactly 0.0 and are not
    updated, so the all-reduce runs only where ``scap`` has a finite entry:
    ``scap`` is the whole fleet's, so every rank makes the same choice,
    whatever caps its own tenants carry. With no finite group cap on this
    batch either, the group multipliers stay 0.0 too, and the lean body
    that skips both gives the same bits.
    """
    f32, f64 = torch.float32, torch.float64
    T, N, L, K = masked_b.shape
    G = gcap_b.shape[1]
    S = scap.shape[0]
    shared = bool(np.isfinite(scap).any())      # the same on every rank
    lean = not (shared or np.isfinite(gcap_b).any())
    t32 = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=f32,
                                    device=dev)
    m = t32(masked_b.reshape(T, N, L * K))
    s = t32(stored_b)
    flat_s = s.reshape(T, N, L * K)
    cap_t = t32(cap_b)
    fin_cap = torch.isfinite(cap_t)
    step = t32(step0_b)[:, None]
    zero = torch.zeros((), dtype=f32, device=dev)
    zero64 = torch.zeros((), dtype=f64, device=dev)
    its = 1.0 + torch.arange(iters, dtype=f32, device=dev)
    cells = torch.empty((iters, T, N), dtype=torch.int32, device=dev)
    lam = torch.zeros((T, L), dtype=f32, device=dev)
    if not lean:
        gcap_t = t32(gcap_b)
        fin_g = torch.isfinite(gcap_t)
        g_of_t = torch.as_tensor(group_of_tier, dtype=torch.long, device=dev)
        in_g = g_of_t[:, None] == torch.arange(G, device=dev)[None, :]
        sg = torch.as_tensor(sgroup_of_tier, dtype=torch.long, device=dev)
        in_s = sg[:, None] == torch.arange(S, device=dev)[None, :]
        scap_t = t32(scap)
        fin_s = torch.isfinite(scap_t)
        sstep = t32(sstep0)
        lam_g = torch.zeros((T, G), dtype=f32, device=dev)
        lam_s = torch.zeros(S, dtype=f32, device=dev)
    for it in range(iters):
        eff = lam
        if not lean:
            eff = lam + lam_g[:, g_of_t] + lam_s[sg][None, :]
        adj = m + (eff[:, None, :, None] * s).reshape(T, N, L * K)
        idx = adj.argmin(dim=2)                                   # (T, N)
        chosen = flat_s.gather(2, idx[:, :, None])[:, :, 0]
        use = ops.usage_sum(idx, chosen, K, L)                   # (T, L)
        rate = step / its[it]
        lam = torch.clamp_min(
            lam + rate * torch.where(fin_cap, use - cap_t, zero), 0.0)
        if not lean:
            use_g = torch.zeros((T, G), dtype=f32, device=dev)
            for l in range(L):                   # tier order, float32
                use_g = use_g + torch.where(in_g[l], use[:, l:l + 1], zero)
            lam_g = torch.clamp_min(lam_g + rate * torch.where(
                fin_g, use_g - gcap_t, zero), 0.0)
        if shared:
            tot = use.double().sum(0)
            if group is not None:
                ctx.all_reduce(tot, dist.ReduceOp.SUM, group)
            use_s = torch.where(in_s, tot[:, None], zero64).sum(0)
            lam_s = torch.clamp_min(lam_s + sstep / its[it] * torch.where(
                fin_s, use_s.float() - scap_t, zero), 0.0)
        cells[it] = idx
    return cells.cpu().numpy()


def _run_fleet_scan(mesh, masked_b: np.ndarray, stored_b: np.ndarray,
                    cap_b: np.ndarray, group_of_tier: np.ndarray,
                    gcap_b: np.ndarray, sgroup_of_tier: np.ndarray,
                    scap: np.ndarray, step0_b: np.ndarray, sstep0: float,
                    iters: int, dev: torch.device) -> np.ndarray:
    """:func:`_fleet_scan` on one device, or with its tenant axis spread
    over the ranks of ``mesh``'s first dimension when it has more than
    one, the counterpart of ``repro/core/optassign.py``'s
    ``_run_fleet_scan``: the tenants are padded to a multiple of that
    size with the reference's dummies (BIG cost, zero stored bytes,
    unbounded caps: their duals never move and their usage is exactly
    0.0), each rank scans its block, and the cells are all-gathered over
    that dimension, so every rank returns the whole (iters, T, N)."""
    if mesh is None or mesh.shape[0] == 1:
        return _fleet_scan(masked_b, stored_b, cap_b, group_of_tier, gcap_b,
                           sgroup_of_tier, scap, step0_b, sstep0, iters, dev)
    group, n, r = ctx.first_axis(mesh)
    T = masked_b.shape[0]
    pad = (-T) % n
    if pad:
        more = lambda x, v: np.concatenate(
            [x, np.full((pad,) + x.shape[1:], v)])
        masked_b, stored_b = more(masked_b, BIG), more(stored_b, 0.0)
        cap_b, gcap_b = more(cap_b, np.inf), more(gcap_b, np.inf)
        step0_b = more(step0_b, 0.0)
    per = (T + pad) // n
    mine = slice(r * per, (r + 1) * per)
    cells = _fleet_scan(masked_b[mine], stored_b[mine], cap_b[mine],
                        group_of_tier, gcap_b[mine], sgroup_of_tier, scap,
                        step0_b[mine], sstep0, iters, dev, group)
    cells = ctx.all_gather(torch.as_tensor(cells, device=dev), 1, group)
    return cells.cpu().numpy()[:, :T]


def _lagrangian_scan(masked: np.ndarray, stored: np.ndarray, cap: np.ndarray,
                     group_of_tier: np.ndarray, gcap: np.ndarray,
                     step0: float, iters: int,
                     dev: torch.device) -> np.ndarray:
    """Dual ascent over all N*L*K cells on ``dev``; one candidate per step.

    Dualizes both the per-tier capacities and the group (per-provider)
    capacities: a tier's effective multiplier is its own lambda plus its
    group's. It is :func:`_fleet_scan` for a fleet of one tenant, so a
    tenant solved alone and the same tenant in an uncoupled fleet emit the
    same cells. Returns the (iters, N) flat cell indices.
    """
    L = masked.shape[1]
    return _fleet_scan(masked[None], stored[None], cap[None], group_of_tier,
                       np.asarray(gcap, np.float64)[None],
                       np.zeros(L, np.int64), np.array([np.inf]),
                       np.array([step0]), 0.0, iters, dev)[:, 0]


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
                      cap_all: np.ndarray, finite_all: np.ndarray,
                      max_moves: Optional[int] = None) -> None:
    """Best-improvement 1-swap descent with a full (N,L,K) delta matrix.

    ``max_moves`` overrides the default ``8 * N + 64`` budget so the
    lockstep fleet descent can hand its tail rows over mid-trajectory
    with their remaining budget intact.
    """
    N, L, K = masked.shape
    n_idx = np.arange(N)
    Af = A & finite_all[:, None]                    # (C, L)
    A_f = A.astype(np.float64)
    any_finite = bool(finite_all.any())
    for _ in range(8 * N + 64 if max_moves is None else max_moves):
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


def _dedupe_candidates_arr(arr: np.ndarray,
                           max_candidates: int) -> List[np.ndarray]:
    """Distinct relaxed assignments emitted by the dual ascent, rows of an
    (iters, N) matrix, in first-emission order (one ``np.unique`` over row
    bytes), truncated head/tail to ``max_candidates``."""
    arr = np.ascontiguousarray(arr)
    if arr.shape[1] == 0:
        return [np.zeros(0, np.int64)]
    keys = arr.view(np.dtype((np.void, arr.dtype.itemsize * arr.shape[1])))
    _, first = np.unique(keys.ravel(), return_index=True)
    uniq = [arr[i].astype(np.int64) for i in np.sort(first)]
    if len(uniq) > max_candidates:
        head = max_candidates // 4
        uniq = uniq[:head] + uniq[-(max_candidates - head):]
    return uniq


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

    return _batch_candidate_finish(
        [0], cells[:, None, :], masked[None], stored[None], [masked],
        [stored], [A], [cap_all], [finite_all], [N], K, max_candidates)[0]


# ---------------------------------------------------------------- fleet batch
# below this many alive rows the lockstep descent hands the stragglers to
# the sequential per-row search (same trajectory, no per-round overhead)
_LOCKSTEP_TAIL = 8


def _lockstep_local_search(tier_r: np.ndarray, scheme_r: np.ndarray,
                           use_r: np.ndarray, alive: np.ndarray,
                           jrow: np.ndarray, masked_b: np.ndarray,
                           stored_b: np.ndarray, A_fb: np.ndarray,
                           Af_b: np.ndarray, cap_b: np.ndarray,
                           budget: np.ndarray) -> None:
    """Vectorized best-improvement 1-swap descent over independent rows.

    Replicates :func:`_local_search_vec` move-for-move for every (tenant,
    candidate) row at once: the same einsum ``use_c`` accumulation, the
    same slack/room/ok/delta expressions, the same first-occurrence argmin
    over the flattened cell grid (padding cells are ``+inf`` and can never
    win), and the same per-row iteration budget ``8 * N + 64``. Rows
    deactivate independently, so the Python-level loop runs once per step
    of the longest trajectory instead of once per row.
    """
    M, n_max = tier_r.shape
    L, K = masked_b.shape[2], masked_b.shape[3]
    n_idx = np.arange(n_max)
    while alive.size:
        if alive.size <= _LOCKSTEP_TAIL:
            # the few long-trajectory survivors finish sequentially: rows
            # are independent and the sequential descent applies the same
            # update rule, so continuing with the remaining per-row move
            # budget lands on the same fixed point bit-for-bit — without
            # paying a full vectorized round per move for a handful of rows
            for r in alive:
                j = jrow[r]
                _local_search_vec(tier_r[r], scheme_r[r], use_r[r],
                                  masked_b[j], stored_b[j],
                                  A_fb[j] != 0.0, cap_b[j],
                                  np.isfinite(cap_b[j]),
                                  max_moves=int(budget[r]))
            return
        jr = jrow[alive]
        mrows = masked_b[jr]                                  # (A, N, L, K)
        srows = stored_b[jr]
        tr, sc = tier_r[alive], scheme_r[alive]
        a_idx = np.arange(alive.size)[:, None]
        cur = mrows[a_idx, n_idx[None, :], tr, sc]            # (A, N)
        stored_cur = srows[a_idx, n_idx[None, :], tr, sc]
        use_c = np.einsum("acl,al->ac", A_fb[jr], use_r[alive])
        At = np.take_along_axis(A_fb[jr], tr[:, None, :], axis=2)
        slack = ((cap_b[jr] - use_c)[:, None, :]
                 + At.transpose(0, 2, 1) * stored_cur[:, :, None])
        room = np.where(Af_b[jr][:, None, :, :], slack[..., None],
                        np.inf).min(2)                        # (A, N, L)
        ok = (mrows < BIG) & (srows <= room[..., None] + 1e-9)
        delta = np.where(ok, mrows - cur[..., None, None], np.inf)
        flat = delta.reshape(alive.size, -1)
        jarg = flat.argmin(1)
        dmin = flat[np.arange(alive.size), jarg]
        g = np.where(dmin < -1e-12)[0]
        if g.size == 0:
            break
        rows = alive[g]
        n, rem = np.divmod(jarg[g], L * K)
        l2, k2 = np.divmod(rem, K)
        l1 = tier_r[rows, n]
        k1 = scheme_r[rows, n]
        jg = jrow[rows]
        use_r[rows, l1] -= stored_b[jg, n, l1, k1]
        use_r[rows, l2] += stored_b[jg, n, l2, k2]
        tier_r[rows, n] = l2
        scheme_r[rows, n] = k2
        budget[rows] -= 1
        alive = rows[budget[rows] > 0]


def _batch_candidate_finish(solve_idx, cells: np.ndarray,
                            masked_b: np.ndarray, stored_b: np.ndarray,
                            maskeds, storeds, As, cap_alls, finite_alls,
                            Ns, K: int, max_candidates: int) -> dict:
    """Repair + 1-swap finish of the dual ascent's candidates for an
    uncoupled tenant batch (a single tenant is a batch of one); returns
    ``{tenant: Assignment}``, each tenant's best f64 score.

    Each tenant's distinct candidates (:func:`_dedupe_candidates_arr`) are
    rows of one host batch: one scatter computes every candidate's usage,
    one einsum makes every round-0 feasibility decision, only rows that
    actually violate a capacity pay the sequential :func:`_repair_vec`,
    and all surviving rows descend in one lockstep
    :func:`_lockstep_local_search`, move for move the per-row
    :func:`_local_search_vec`. A tenant none of whose candidates repairs
    keeps its first candidate, infeasible.
    """
    iters_n, Tp, n_max = cells.shape
    L = masked_b.shape[2]
    rows_of: List[List[int]] = [[] for _ in range(Tp)]
    uniq_all: List[np.ndarray] = []
    row_j: List[int] = []
    for j in range(Tp):
        t = solve_idx[j]
        uniq = _dedupe_candidates_arr(cells[:, j, :Ns[t]], max_candidates)
        for cand in uniq:
            rows_of[j].append(len(uniq_all))
            uniq_all.append(cand)
            row_j.append(j)
    M = len(uniq_all)
    jrow = np.asarray(row_j)

    # constraint rows, padded to a common C with inert (cap=inf) rows
    C_max = max(As[t].shape[0] for t in solve_idx)
    A_b = np.zeros((Tp, C_max, L), bool)
    cap_b2 = np.full((Tp, C_max), np.inf)
    fin_b = np.zeros((Tp, C_max), bool)
    for j, t in enumerate(solve_idx):
        C = As[t].shape[0]
        A_b[j, :C] = As[t]
        cap_b2[j, :C] = cap_alls[t]
        fin_b[j, :C] = finite_alls[t]
    A_fb = A_b.astype(np.float64)
    Af_b = A_b & fin_b[:, :, None]

    # decode candidates; keep each tenant's first decode as the fallback
    tier_r = np.zeros((M, n_max), np.int64)
    scheme_r = np.zeros((M, n_max), np.int64)
    fallbacks = {}
    for m, cand in enumerate(uniq_all):
        tier_r[m, :cand.shape[0]] = cand // K
        scheme_r[m, :cand.shape[0]] = cand % K
        j = row_j[m]
        if j not in fallbacks:
            fallbacks[j] = (tier_r[m, :cand.shape[0]].copy(),
                            scheme_r[m, :cand.shape[0]].copy())

    # per-row usage: one scatter, ascending-n within each row, so it is
    # bit-identical to _chosen_usage (padding rows add exact 0.0)
    sval = stored_b[jrow[:, None], np.arange(n_max)[None, :], tier_r,
                    scheme_r]
    use_r = np.zeros((M, L))
    np.add.at(use_r, (np.repeat(np.arange(M), n_max), tier_r.ravel()),
              sval.ravel())

    # round-0 repair decision for every row at once; only violating rows
    # pay the sequential eviction loop
    use_c0 = np.einsum("acl,al->ac", A_fb[jrow], use_r)
    viol = (fin_b[jrow] & (use_c0 > cap_b2[jrow] + 1e-9)).any(1)
    dead = np.zeros(M, bool)
    for m in np.where(viol)[0]:
        j = row_j[m]
        t = solve_idx[j]
        use = _repair_vec(tier_r[m, :Ns[t]], scheme_r[m, :Ns[t]],
                          maskeds[t], storeds[t], As[t], cap_alls[t],
                          finite_alls[t])
        if use is None:
            dead[m] = True
        else:
            use_r[m] = use

    budget = 8 * np.asarray([Ns[solve_idx[j]] for j in row_j]) + 64
    _lockstep_local_search(tier_r, scheme_r, use_r, np.where(~dead)[0],
                           jrow, masked_b, stored_b, A_fb, Af_b, cap_b2,
                           budget)

    out = {}
    for j in range(Tp):
        t = solve_idx[j]
        n_t = Ns[t]
        best: Optional[Assignment] = None
        for m in rows_of[j]:
            if dead[m]:
                continue
            tr, sc = tier_r[m, :n_t], scheme_r[m, :n_t]
            total = float(maskeds[t][np.arange(n_t), tr, sc].sum())
            if total < BIG and (best is None or total < best.cost):
                best = Assignment(tr.copy(), sc.copy(), total, True)
        if best is None:
            ftr, fsc = fallbacks.get(
                j, (np.zeros(n_t, np.int64), np.zeros(n_t, np.int64)))
            best = Assignment(ftr, fsc, float("inf"), False)
        out[t] = best
    return out


def _greedy_device_batch(cost: np.ndarray, feasible: np.ndarray,
                         dev: torch.device) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """Per-(tenant, row) argmin over the flattened (L, K) cells of a
    (T, N, L, K) batch, in float32."""
    c = torch.as_tensor(cost, dtype=torch.float32, device=dev)
    f = torch.as_tensor(feasible, dtype=torch.bool, device=dev)
    masked = torch.where(f, c, torch.full((), BIG, dtype=torch.float32,
                                          device=dev))
    flat = masked.reshape(masked.shape[0], masked.shape[1], -1)
    idx = flat.argmin(dim=2)
    best = flat.gather(2, idx[:, :, None])[:, :, 0]
    K = masked.shape[3]
    return ((idx // K).cpu().numpy(), (idx % K).cpu().numpy(),
            best.cpu().numpy())


def greedy_assign_batch(costs: Sequence[np.ndarray],
                        feasibles: Sequence[np.ndarray], *,
                        device: DeviceLike = "cuda") -> List[Assignment]:
    """Unbounded-capacity assignment for T ragged tenants in one argmin on
    ``device``. Bit-identical per tenant to :func:`greedy_assign` (same f32
    argmin, same f64 host re-total); padding rows are BIG-masked and
    sliced off before scoring."""
    dev = resolve(device)
    T = len(costs)
    if T == 0:
        return []
    Ns = [int(c.shape[0]) for c in costs]
    L, K = costs[0].shape[1], costs[0].shape[2]
    n_max = max(Ns)
    if n_max == 0:
        z = np.zeros(0, np.int64)
        return [Assignment(z.copy(), z.copy(), 0.0, True) for _ in range(T)]
    cost_b = np.full((T, n_max, L, K), BIG)
    feas_b = np.zeros((T, n_max, L, K), bool)
    for t in range(T):
        cost_b[t, :Ns[t]] = costs[t]
        feas_b[t, :Ns[t]] = feasibles[t]
    tier_b, scheme_b, best_b = _greedy_device_batch(cost_b, feas_b, dev)
    out = []
    for t in range(T):
        n = Ns[t]
        tier = tier_b[t, :n].astype(int)
        scheme = scheme_b[t, :n].astype(int)
        ok = bool((best_b[t, :n] < BIG).all())
        n_idx = np.arange(n)
        total = float(np.asarray(costs[t], np.float64)
                      [n_idx, tier, scheme].sum()) if ok else float("inf")
        out.append(Assignment(tier, scheme, total, ok))
    return out


def _fleet_repair_shared(tiers, schemes, uses, maskeds, storeds, As,
                         cap_alls, finite_alls, A_sh, cap_sh,
                         finite_sh) -> Optional[np.ndarray]:
    """Cross-tenant greedy eviction until every finite *shared* (fleet-wide)
    capacity row is respected; per-tenant rows stay respected throughout.
    Mirrors :func:`_repair_vec` at fleet scope: each round, the cheapest-
    delta members of the most over-capacity shared row move — across any
    tenant — to cells outside that row with room in both scopes. Returns
    the (S,) shared usage vector, or None if repair is impossible."""
    T = len(tiers)
    A_shf = A_sh & finite_sh[:, None]
    su = np.zeros(cap_sh.shape[0])
    for t in range(T):
        su += A_sh @ uses[t]
    total_n = sum(int(x.shape[0]) for x in tiers)
    for _ in range(4 * total_n + 8):
        over = np.where(finite_sh & (su > cap_sh + 1e-9))[0]
        if over.size == 0:
            return su
        s = over[np.argmax((su - cap_sh)[over])]
        in_s = A_sh[s]                              # (L,)
        slack_sh = np.where(finite_sh, cap_sh - su, np.inf)
        room_sh = np.where(A_shf, slack_sh[:, None], np.inf).min(0)   # (L,)
        moves = []                                  # (delta, t, n, l2, k2)
        for t in range(T):
            if tiers[t].shape[0] == 0:
                continue
            members = np.where(in_s[tiers[t]])[0]
            if members.size == 0:
                continue
            masked, stored = maskeds[t], storeds[t]
            K = masked.shape[2]
            Af = As[t] & finite_alls[t][:, None]
            use_c = As[t] @ uses[t]
            slack_own = np.where(finite_alls[t], cap_alls[t] - use_c, np.inf)
            room_own = np.where(Af, slack_own[:, None], np.inf).min(0)  # (L,)
            cur = masked[members, tiers[t][members], schemes[t][members]]
            cur_st = stored[members, tiers[t][members], schemes[t][members]]
            ok = (masked[members] < BIG) & (stored[members]
                                            <= room_own[None, :, None] + 1e-9)
            # leaving the row needs room in the destination's shared row;
            # staying inside it is allowed iff the move strictly shrinks the
            # row's usage (better compression) — shared rows are disjoint,
            # so an in-row move touches no other shared row
            ok &= np.where(in_s[None, :, None],
                           stored[members] < cur_st[:, None, None] - 1e-9,
                           stored[members] <= room_sh[None, :, None] + 1e-9)
            delta = np.where(ok, masked[members] - cur[:, None, None],
                             np.inf).reshape(members.size, -1)
            cell = delta.argmin(1)
            d = delta[np.arange(members.size), cell]
            for m in range(members.size):
                if np.isfinite(d[m]):
                    moves.append((float(d[m]), t, int(members[m]),
                                  int(cell[m]) // K, int(cell[m]) % K))
        if not moves:
            return None
        moves.sort()
        moved = False
        for d, t, n, l2, k2 in moves:
            if su[s] <= cap_sh[s] + 1e-9:
                break
            stored = storeds[t]
            if not in_s[tiers[t][n]]:
                continue
            l1, k1 = int(tiers[t][n]), int(schemes[t][n])
            s1, s2 = stored[n, l1, k1], stored[n, l2, k2]
            # room may have shrunk this round; re-check before applying
            Af = As[t] & finite_alls[t][:, None]
            use_c = As[t] @ uses[t]
            room_own = np.where(Af[:, l2], cap_alls[t] - use_c,
                                np.inf).min() if Af[:, l2].any() else np.inf
            if in_s[l2]:
                if s2 >= s1 - 1e-9:
                    continue                        # shrink no longer strict
                room_s2 = np.inf
            else:
                slack2 = np.where(finite_sh, cap_sh - su, np.inf)
                room_s2 = np.where(A_shf[:, l2], slack2, np.inf).min() \
                    if A_shf[:, l2].any() else np.inf
            if s2 > min(room_own, room_s2) + 1e-9:
                continue
            uses[t][l1] -= s1
            uses[t][l2] += s2
            su += A_sh[:, l2] * s2 - A_sh[:, l1] * s1
            tiers[t][n], schemes[t][n] = l2, k2
            moved = True
        if not moved:
            return None
    return None


def _fleet_polish(tiers, schemes, uses, maskeds, storeds, As, cap_alls,
                  finite_alls, A_sh, cap_sh, finite_sh,
                  su: np.ndarray) -> None:
    """Round-robin 1-swap descent under the shared rows: each tenant runs
    :func:`_local_search_vec` against its own constraints augmented with the
    shared rows at their *residual* caps (fleet cap minus the other tenants'
    usage), sweeping until a full pass changes nothing."""
    T = len(tiers)
    for _ in range(8):
        changed = False
        for t in range(T):
            if tiers[t].shape[0] == 0:
                continue
            own_sh = A_sh @ uses[t]
            A_aug = np.concatenate([As[t], A_sh], 0)
            cap_aug = np.concatenate([cap_alls[t], cap_sh - (su - own_sh)])
            fin_aug = np.concatenate([finite_alls[t], finite_sh])
            t0, k0 = tiers[t].copy(), schemes[t].copy()
            _local_search_vec(tiers[t], schemes[t], uses[t], maskeds[t],
                              storeds[t], A_aug, cap_aug, fin_aug)
            if not ((tiers[t] == t0).all() and (schemes[t] == k0).all()):
                changed = True
                su += A_sh @ uses[t] - own_sh
        if not changed:
            return


@dataclasses.dataclass
class FleetAssignment:
    """Result of one batched fleet solve.

    ``assignments[t]`` is tenant t's :class:`Assignment`; ``cost`` is the
    fleet-total objective (inf if any tenant is infeasible); ``feasible``
    requires every tenant feasible *and* the shared caps respected;
    ``shared_use_gb`` is the fleet usage per shared group (None when no
    shared rows were given).
    """

    assignments: List[Assignment]
    cost: float
    feasible: bool
    shared_use_gb: Optional[np.ndarray] = None


def _per_tenant_seq(x, T: int, name: str) -> list:
    """Broadcast one vector to all T tenants, or validate a per-tenant
    sequence (list/tuple of vectors, or a (T, ...) array)."""
    if x is None:
        return [None] * T
    if isinstance(x, np.ndarray) and x.ndim == 1:
        return [x] * T
    xs = list(x)
    if len(xs) != T:
        raise ValueError(f"{name}: expected one vector or a length-{T} "
                         f"sequence, got length {len(xs)}")
    return xs


def capacitated_assign_batch(
    costs: Sequence[np.ndarray],         # T x (N_t, L, K), ragged N_t
    feasibles: Sequence[np.ndarray],     # T x (N_t, L, K)
    stored_gbs: Sequence[np.ndarray],    # T x (N_t, L, K)
    capacity_gb,                         # (L,) for all tenants, or T x (L,)
    *,
    iters: int = 200,
    seed: int = 0,
    max_candidates: int = 16,
    tier_groups: Optional[np.ndarray] = None,        # (L,) — one tier space
    group_capacity_gb=None,                          # (G,) or T x (G,)
    shared_tier_groups: Optional[np.ndarray] = None,  # (L,) fleet-wide rows
    shared_capacity_gb: Optional[np.ndarray] = None,  # (S,)
    mesh=None,
    sla_penalties: Optional[Sequence] = None,        # T x (N_t,L,K) or None
    sla_lambda: float = 0.0,
    device: DeviceLike = "cuda",
) -> FleetAssignment:
    """Solve T tenants' capacitated OPTASSIGN problems in one batched dual
    ascent on ``device``.

    Heterogeneous tenant problems are ragged-padded into a
    ``(T, N_max, L, K)`` batch (padding rows: BIG cost, zero stored bytes —
    they contribute zero cost and zero usage, so they never perturb duals or
    capacities) and run through one batched Lagrangian scan
    (:func:`_fleet_scan`, the whole fleet in one batch); repair and 1-swap
    polish then run on the host exactly as in :func:`capacitated_assign`.
    **With no shared constraints the per-tenant results are bit-identical
    to T independent** :func:`capacitated_assign` **calls** (pinned by
    ``tests/test_torch_fleet.py``) — same greedy shortcut, same dual
    trajectories, same candidate set, same repair/polish.

    ``shared_tier_groups``/``shared_capacity_gb`` add *fleet-wide* capacity
    rows: ``sum over all tenants of use[shared_tier_groups == s] <=
    shared_capacity_gb[s]``. This is how one provider's global capacity caps
    the whole fleet rather than each tenant separately. Shared rows are
    dualized by fleet-global multipliers in the scan; on host a
    cross-tenant eviction repair (:func:`_fleet_repair_shared`) and a
    residual-cap round-robin polish (:func:`_fleet_polish`) enforce them
    exactly.

    ``mesh`` (a DeviceMesh) spreads the scan's tenant axis over the ranks
    of its first dimension (:func:`_run_fleet_scan`), each rank on
    ``device``; the shared rows' usage is summed over all of them, exactly,
    so the cells are those of one device. Every rank then runs the host
    finish on the whole cells and returns the same result.
    """
    dev = resolve(device)
    if (shared_tier_groups is None) != (shared_capacity_gb is None):
        raise ValueError("shared_tier_groups and shared_capacity_gb must be "
                         "passed together")
    # Soft-SLA term, exactly as in capacitated_assign: folded into the
    # per-tenant cost tensors before padding, so the weighted penalty rows
    # ride the batched fleet scan too. sla_lambda=0 touches nothing.
    if sla_lambda and sla_penalties is not None:
        costs = [c if p is None
                 else (np.asarray(c, np.float64)
                       + float(sla_lambda) * np.asarray(p, np.float64))
                 for c, p in zip(costs, sla_penalties)]
    T = len(costs)
    if T == 0:
        su = (np.zeros(np.asarray(shared_capacity_gb).shape[0])
              if shared_capacity_gb is not None else None)
        return FleetAssignment([], 0.0, True, su)
    L, K = int(costs[0].shape[1]), int(costs[0].shape[2])
    caps = [np.asarray(c, np.float64) for c in
            _per_tenant_seq(np.asarray(capacity_gb, np.float64)
                            if not isinstance(capacity_gb, (list, tuple))
                            else capacity_gb, T, "capacity_gb")]
    gcaps = _per_tenant_seq(group_capacity_gb, T, "group_capacity_gb")

    maskeds, storeds, As, cap_alls, finite_alls, Ns = [], [], [], [], [], []
    for t in range(T):
        maskeds.append(_masked(np.asarray(costs[t], np.float64),
                               feasibles[t]))
        storeds.append(np.asarray(stored_gbs[t], np.float64))
        A, cap_all = _constraint_rows(caps[t], tier_groups, gcaps[t])
        As.append(A)
        cap_alls.append(cap_all)
        finite_alls.append(np.isfinite(cap_all))
        Ns.append(int(costs[t].shape[0]))

    if shared_tier_groups is not None:
        sg = np.asarray(shared_tier_groups, int)
        scap = np.asarray(shared_capacity_gb, np.float64)
        S = scap.shape[0]
        if sg.shape != (L,) or (sg.size and (sg.min() < 0 or sg.max() >= S)):
            raise ValueError(f"shared_tier_groups ids must lie in [0, {S}) "
                             f"and have shape ({L},)")
        A_sh = np.arange(S)[:, None] == sg[None, :]
        finite_sh = np.isfinite(scap)
    else:
        sg = np.zeros(L, int)
        scap = np.array([np.inf])
        A_sh = np.ones((1, L), bool)
        finite_sh = np.zeros(1, bool)
    has_shared = bool(finite_sh.any())

    # lam=0 greedy shortcut, per tenant — identical to capacitated_assign's
    tier0s, scheme0s, use0s, own_ok = [], [], [], []
    for t in range(T):
        cell0 = maskeds[t].reshape(Ns[t], -1).argmin(1) if Ns[t] \
            else np.zeros(0, np.int64)
        tier0s.append(cell0 // K)
        scheme0s.append(cell0 % K)
        use0s.append(_chosen_usage(storeds[t], tier0s[t], scheme0s[t]))
        own_ok.append(bool((~finite_alls[t]
                            | (As[t] @ use0s[t]
                               <= cap_alls[t] + 1e-9)).all()))

    def greedy_result(t: int) -> Assignment:
        total = float(maskeds[t][np.arange(Ns[t]), tier0s[t],
                                 scheme0s[t]].sum())
        ok = bool(total < BIG)
        return Assignment(tier0s[t], scheme0s[t],
                          total if ok else float("inf"), ok)

    done: dict = {}
    if has_shared:
        su0 = A_sh @ np.sum(use0s, axis=0)
        if all(own_ok) and bool((~finite_sh | (su0 <= scap + 1e-9)).all()):
            solve_idx: List[int] = []
            done = {t: greedy_result(t) for t in range(T)}
        else:
            solve_idx = list(range(T))
    else:
        done = {t: greedy_result(t) for t in range(T) if own_ok[t]}
        solve_idx = [t for t in range(T) if not own_ok[t]]

    if solve_idx:
        n_max = max(Ns[t] for t in solve_idx)
        Tp = len(solve_idx)
        masked_b = np.full((Tp, n_max, L, K), BIG)
        stored_b = np.zeros((Tp, n_max, L, K))
        cap_b = np.zeros((Tp, L))
        step0_b = np.zeros(Tp)
        if tier_groups is None:
            g_of_t = np.zeros(L, np.int32)
            gcap_b = np.full((Tp, 1), np.inf)
        else:
            g_of_t = np.asarray(tier_groups, np.int32)
            gcap_b = np.stack([np.asarray(gcaps[t], np.float64)
                               for t in solve_idx])
        for j, t in enumerate(solve_idx):
            masked_b[j, :Ns[t]] = maskeds[t]
            stored_b[j, :Ns[t]] = storeds[t]
            cap_b[j] = caps[t]
            step0_b[j] = _step0(maskeds[t], cap_alls[t], finite_alls[t])
        if has_shared:
            fleet_cells = np.concatenate(
                [maskeds[t][maskeds[t] < BIG].ravel() for t in solve_idx])
            sstep0 = (fleet_cells.mean()
                      / max(scap[finite_sh].mean(), 1e-9)
                      if fleet_cells.size else 0.0)
        else:
            sstep0 = 0.0
        cells = _run_fleet_scan(mesh, masked_b, stored_b, cap_b, g_of_t,
                                gcap_b, sg, scap, step0_b, sstep0, iters, dev)

        if not has_shared:
            done.update(_batch_candidate_finish(
                solve_idx, cells, masked_b, stored_b, maskeds, storeds, As,
                cap_alls, finite_alls, Ns, K, max_candidates))
        else:
            joint = _dedupe_candidates_arr(
                cells.reshape(cells.shape[0], -1), max_candidates)
            best_score = float("inf")
            best_state = None
            fallback = None
            for cand in joint:
                grid = cand.reshape(Tp, n_max)
                tiers = [grid[j, :Ns[t]] // K
                         for j, t in enumerate(solve_idx)]
                schemes = [grid[j, :Ns[t]] % K
                           for j, t in enumerate(solve_idx)]
                if fallback is None:
                    fallback = ([x.copy() for x in tiers],
                                [x.copy() for x in schemes])
                m_l = [maskeds[t] for t in solve_idx]
                s_l = [storeds[t] for t in solve_idx]
                A_l = [As[t] for t in solve_idx]
                c_l = [cap_alls[t] for t in solve_idx]
                f_l = [finite_alls[t] for t in solve_idx]
                uses = []
                dead = False
                for j in range(Tp):
                    use = _repair_vec(tiers[j], schemes[j], m_l[j], s_l[j],
                                      A_l[j], c_l[j], f_l[j])
                    if use is None:
                        dead = True
                        break
                    uses.append(use)
                if dead:
                    continue
                su = _fleet_repair_shared(tiers, schemes, uses, m_l, s_l,
                                          A_l, c_l, f_l, A_sh, scap,
                                          finite_sh)
                if su is None:
                    continue
                _fleet_polish(tiers, schemes, uses, m_l, s_l, A_l, c_l, f_l,
                              A_sh, scap, finite_sh, su)
                score = sum(
                    float(m_l[j][np.arange(Ns[t]), tiers[j],
                                 schemes[j]].sum())
                    for j, t in enumerate(solve_idx))
                if score < BIG and score < best_score:
                    best_score = score
                    best_state = ([x.copy() for x in tiers],
                                  [x.copy() for x in schemes])
            if best_state is not None:
                tiers, schemes = best_state
                for j, t in enumerate(solve_idx):
                    total = float(maskeds[t][np.arange(Ns[t]), tiers[j],
                                             schemes[j]].sum())
                    done[t] = Assignment(tiers[j], schemes[j], total, True)
            else:
                tiers, schemes = fallback if fallback is not None else (
                    [np.zeros(Ns[t], np.int64) for t in solve_idx],
                    [np.zeros(Ns[t], np.int64) for t in solve_idx])
                for j, t in enumerate(solve_idx):
                    done[t] = Assignment(tiers[j], schemes[j],
                                         float("inf"), False)

    assignments = [done[t] for t in range(T)]
    feasible = all(a.feasible for a in assignments)
    shared_use = None
    if shared_tier_groups is not None:
        shared_use = np.zeros(scap.shape[0])
        for t, a in enumerate(assignments):
            if a.feasible and Ns[t]:
                shared_use += A_sh @ _chosen_usage(
                    storeds[t], a.tier.astype(int), a.scheme.astype(int))
        feasible = feasible and bool(
            (~finite_sh | (shared_use <= scap + 1e-9)).all())
    cost = (float(sum(a.cost for a in assignments))
            if feasible else float("inf"))
    return FleetAssignment(assignments, cost, feasible, shared_use)


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
