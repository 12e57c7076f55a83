"""Vectorized partition search and the portfolio (paper §6.2); port of
``repro/core/mapping/search.py``, the same numpy ``Generator`` streams.

Two layers:

1. ``framework_partition`` — the probabilistic rebalancing loop as a
   *population*: K restart seeds share ``[R, M-1, E]`` switch state and
   advance in lockstep, one iteration of every live restart per outer
   step. Within a restart, an iteration is pure array work on the flat
   occupancy planes of :class:`~repro_torch.core.mapping.books.Books` —
   candidate ranking, destination priority, and path updates are numpy
   expressions, not dict churn. Each restart consumes its own RNG
   stream exactly as the reference loop does, so restart k is
   BIT-IDENTICAL to ``legacy.partition_legacy(seed=seed+k)``
   (``tests/test_torch_mapping.py``).

2. ``portfolio_search`` — the portfolio search behind
   ``compile(search=SearchConfig(...))``: races the framework
   population against every :data:`repro_torch.core.baselines.BASELINES`
   seed, schedules each feasible candidate under every registered
   schedule strategy, and keeps the best JOINT (mapping, strategy)
   pair by (feasible, min OT depth, min memory) — §6.3
   co-optimization over both axes. Supports early exit at the first
   feasible restart and a wall-clock budget; every candidate is
   recorded in a :class:`SearchTrace` that rides on the
   ``CompileReport``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import Books, PartitionResult
from repro_torch.core.mapping.tree import lca_depths, leaf_paths, walk
from repro_torch.core.memory_model import HardwareConfig, total_memory_kb

_NEVER = -(1 << 30)

# destination priority categories, indexed by has_post*2 + has_weight:
# better-scored SPUs rank {both: 0, post: 1, weight: 2, plain: 5},
# equal-scored ones {both: 3, post: 4, weight: 6, plain: 8 = never}
_LUT_BETTER = (5, 2, 1, 0)
_LUT_EQUAL = (8, 6, 4, 3)


# ---------------------------------------------------------------------------
# The lockstep restart population.
# ---------------------------------------------------------------------------

class _Population:
    """K probabilistic searches advancing in lockstep on batched state."""

    def __init__(self, g: SNNGraph, hw: HardwareConfig, seeds: list[int], *,
                 max_iters: int, eta: float, move_mode: str,
                 stagnation_window: int, cooldown: int, scan_cap: int):
        self.g, self.hw = g, hw
        self.max_iters = max_iters
        self.eta, self.move_mode = eta, move_mode
        self.window, self.cooldown = stagnation_window, cooldown
        self.scan_cap = scan_cap

        n = len(seeds)
        m, depth, e = hw.n_spus, hw.tree_depth, g.n_synapses
        self.n, self.m, self.depth = n, m, depth
        self.rngs = [np.random.default_rng(s) for s in seeds]
        self.p = np.full((n, m - 1, e), 0.5, np.float64)
        self.r = np.stack([rng.random((m - 1, e)) for rng in self.rngs]) \
            if n else np.zeros((0, m - 1, e))
        self.post = g.post.astype(np.int64)

        # batched initial walk: the whole population in one call
        self.assign = walk(self.p, self.r, depth)           # [R, E]
        self.books = Books(g, hw, self.assign)
        self.scores = self.books.scores()                   # [R, M]
        # per-SPU membership (sorted synapse ids), maintained incrementally
        self.mem = [[np.flatnonzero(self.assign[rr] == s) for s in range(m)]
                    for rr in range(n)]
        self.SW, self.SIDE = leaf_paths(depth)
        self.LCA = lca_depths(depth)

        self.moved_at = np.full((n, e), _NEVER, np.int64)
        self.history: list[list[float]] = [[] for _ in range(n)]
        self.perturbations = np.zeros(n, np.int64)
        self.last_improve = np.zeros(n, np.int64)
        self.best_min = self.scores.min(1).astype(np.int64) if n \
            else np.zeros(0, np.int64)
        self.best_total = np.array(
            [self.books.total_usage_r(rr) for rr in range(n)], np.int64)
        self.best_state = [(self.assign[rr].copy(), self.scores[rr].copy())
                           for rr in range(n)]
        self.done = np.zeros(n, bool)
        self.results: list[PartitionResult | None] = [None] * n
        # flat [E*(M-1)] views of each restart's switch state: path updates
        # become 1D fancy indexing (much cheaper than 2D advanced indexing)
        self.e = e
        self.p_flat = [self.p[rr].reshape(-1) for rr in range(n)]
        self.r_flat = [self.r[rr].reshape(-1) for rr in range(n)]
        # per-(ov, dst) below-LCA path constants, precomputed once:
        # (switch row offsets, P deltas away from ov, dst switch offsets,
        #  dst sides == left, dst side count)
        self._paths = {}
        for a in range(m):
            for b in range(m):
                if a == b:
                    continue
                lca = int(self.LCA[a, b])
                sw_a, sd_a = self.SW[a, lca:], self.SIDE[a, lca:]
                sw_b, sd_b = self.SW[b, lca:], self.SIDE[b, lca:]
                self._paths[a, b] = (
                    sw_a * e, np.where(sd_a == 0, -self.eta, self.eta),
                    sw_b * e, sd_b == 0)

    # -- progress & perturbation (identical policy to the reference loop) ----

    def _note_progress(self, rr: int, it: int) -> None:
        scores = self.scores[rr]
        mn = int(scores.min())
        # Eq. (10): score_i = L - usage_i, so total line usage is an O(1)
        # rearrangement of the score sum — no occupancy re-scan
        tot = self.m * self.hw.unified_mem_depth - int(scores.sum())
        if mn > self.best_min[rr]:
            self.best_min[rr] = mn
            self.best_state[rr] = (self.assign[rr].copy(),
                                   self.scores[rr].copy())
            self.last_improve[rr] = it
        if tot < self.best_total[rr]:
            self.best_total[rr] = tot
            self.last_improve[rr] = it

    def _perturb(self, rr: int, it: int) -> None:
        # reflective boundaries: stay uniform, preserve locality
        r = self.r[rr]
        rn = r + self.rngs[rr].uniform(-0.1, 0.1, r.shape)
        rn = np.where(rn < 0.0, -rn, rn)
        rn = np.where(rn > 1.0, 2.0 - rn, rn)
        self.r[rr] = rn
        self.perturbations[rr] += 1
        self.last_improve[rr] = it
        self.assign[rr] = walk(self.p[rr], self.r[rr], self.depth)
        self.books.rebuild(rr, self.assign[rr])
        self.mem[rr] = [np.flatnonzero(self.assign[rr] == s)
                        for s in range(self.m)]
        self.scores[rr] = self.books.scores_r(rr)
        self._note_progress(rr, it)

    def _finish(self, rr: int, it: int, *, from_best: bool) -> None:
        if from_best:
            assign, scores = self.best_state[rr]
            feasible = bool(scores.min() >= 0)
        else:
            assign = self.assign[rr].copy()
            scores = self.scores[rr].copy()
            feasible = True
        self.results[rr] = PartitionResult(
            assign, scores, feasible, it, int(self.perturbations[rr]),
            self.history[rr])
        self.done[rr] = True

    # -- one iteration of one restart (all-array inner work) -----------------

    def _step(self, rr: int, it: int) -> bool:
        """Advance restart ``rr`` one iteration; True when it finished."""
        scores = self.scores[rr]
        ov = int(scores.argmin())
        smin = int(scores[ov])
        if smin >= 0:
            self._finish(rr, it, from_best=False)
            return True
        # == scores.mean(): M small integers are exact in float64
        self.history[rr].append(int(scores.sum()) / self.m)

        # stagnation: no worst-score progress in the window -> shake
        if it - self.last_improve[rr] >= self.window:
            self._perturb(rr, it)
            return False

        books, rng, eta = self.books, self.rngs[rr], self.eta
        cp, cw = books.cnt_post[rr], books.cnt_w[rr]

        # -- rank the overloaded SPU's members in one vector pass --
        members_all = self.mem[rr][ov]
        members = members_all
        if len(members) > self.scan_cap:
            members = members[rng.choice(len(members), self.scan_cap,
                                         replace=False)]
        members = members[it - self.moved_at[rr, members] >= self.cooldown]
        if not len(members):     # everything in ov is cooling down; shake
            self._perturb(rr, it)
            return False
        # the reference loop keeps the members of minimum rank
        # (not pu, not pa, not wu, not wa); lexicographic REFINEMENT —
        # keep the members setting each bit in turn, if any do — selects
        # the identical candidate set in the identical order, but each
        # stage runs on an ever-smaller subset.
        nb = np.flatnonzero(scores == smin)     # the not-better set, incl ov

        def present_on_better(ids, plane, npresent):
            # "present on a better-scored SPU", tested over whichever side
            # of the score split is smaller: directly over the better rows,
            # or via the global presence counter minus the minimum-score
            # rows (a member's own post/weight counts once for ov itself)
            if len(nb) == 1:
                return npresent[ids] > 1
            if 2 * len(nb) - 1 >= self.m:
                bidx = np.flatnonzero(scores > smin)
                if not len(bidx):
                    return np.zeros(len(ids), bool)
                return (plane[bidx[:, None], ids] > 0).any(0)
            nbo = nb[nb != ov]
            return (npresent[ids]
                    - (plane[nbo[:, None], ids] > 0).sum(0)) > 1

        mp = self.post[members]
        pu = cp[ov, mp] == 1                    # frees a whole line in ov
        if pu.any():
            members = members[pu]
            mp = mp[pu]
        pa = present_on_better(mp, cp, books.np_post[rr])
        if pa.any():
            members = members[pa]
        mw = books.w_id[members]
        wu = cw[ov, mw] == 1
        if wu.any():
            members = members[wu]
            mw = mw[wu]
        wa = present_on_better(mw, cw, books.np_w[rr])
        if wa.any():
            members = members[wa]
        cands = members
        syn = int(cands[rng.integers(len(cands))])
        sp = int(self.post[syn])
        swid = int(books.w_id[syn])

        # -- destination by the 4-level priority among higher-scored SPUs,
        # falling back to consolidating moves into equal-scored ones; a
        # scalar scan of the M SPUs beats array ops at M=16 --
        cat_best, s_best, dst = 9, 0, -1
        sc = scores.tolist()
        hp = (cp[:, sp] > 0).tolist()
        hw_ = (cw[:, swid] > 0).tolist()
        for i in range(self.m):
            s = sc[i]
            if i == ov or s < smin:
                continue
            if s > smin:                       # better-scored SPU
                c = _LUT_BETTER[hp[i] * 2 + hw_[i]]
            else:                              # equal: consolidating only
                c = _LUT_EQUAL[hp[i] * 2 + hw_[i]]
                if c > 6:                      # plain equal: not a dest
                    continue
            if c < cat_best or (c == cat_best and s > s_best):
                cat_best, s_best, dst = c, s, i
        if dst < 0:  # nowhere productive to move; shake and retry
            self._perturb(rr, it)
            return False

        # -- adjust probabilities along both paths below the LCA; the flat
        # views turn every update into cheap 1D fancy indexing. Only the
        # entries touched here can leave [0, 1] (decisive placements are
        # in range by construction), so clipping them IS the reference
        # loop's whole-column clip --
        off_ov, delta_ov, off_dst, left_dst = self._paths[ov, dst]
        p1, r1 = self.p_flat[rr], self.r_flat[rr]
        io = off_ov + syn
        v = p1[io] + delta_ov
        np.minimum(v, 1.0, out=v)
        np.maximum(v, 0.0, out=v)
        p1[io] = v
        idd = off_dst + syn
        if self.move_mode == "decisive":
            # land exactly in dst: put P just past R on its path
            rv = r1[idd]
            p1[idd] = np.where(left_dst,
                               np.minimum(1.0, rv + eta),
                               np.maximum(0.0, rv - eta))
        else:
            v = p1[idd] + np.where(left_dst, eta, -eta)
            np.minimum(v, 1.0, out=v)
            np.maximum(v, 0.0, out=v)
            p1[idd] = v

        # -- re-route the synapse (only its own entries changed) --
        if self.move_mode == "decisive":
            new_spu = dst
        else:
            prefix = 0
            for d in range(self.depth):
                sw = (1 << d) - 1 + prefix
                prefix = (prefix << 1) | int(r1[sw * self.e + syn]
                                             >= p1[sw * self.e + syn])
            new_spu = int(prefix)
        if new_spu != self.assign[rr, syn]:
            books.move_one(rr, syn, ov, new_spu)
            self.assign[rr, syn] = new_spu
            self.moved_at[rr, syn] = it
            mem = self.mem[rr]
            # POST-GROUP BURST: once the post exists in dst, every further
            # synapse of (ov, post) ranks dst first — fast-forward those
            # consecutive single moves as ONE sliced update (DESIGN.md §8)
            if self.move_mode == "decisive":       # new_spu == dst
                # only syn moved since members_all was taken, so ov's
                # remaining (ov, post) group is a filter of it
                mask_sp = self.post[members_all] == sp
                moving = members_all[mask_sp]      # the whole fan-in group
                mem[ov] = members_all[~mask_sp]
                darr = mem[dst]
                # sorted merge of the group into dst (np.insert, sans its
                # python overhead)
                out = np.empty(len(darr) + len(moving), darr.dtype)
                at = np.searchsorted(darr, moving) + np.arange(len(moving))
                keep = np.ones(len(out), bool)
                keep[at] = False
                out[at] = moving
                out[keep] = darr
                mem[dst] = out
                rest = moving[moving != syn]
                if len(rest):
                    nres = len(rest)
                    idx = (off_ov[:, None] + rest).ravel()
                    v = p1[idx] + np.repeat(delta_ov, nres)
                    np.minimum(v, 1.0, out=v)
                    np.maximum(v, 0.0, out=v)
                    p1[idx] = v
                    idx = (off_dst[:, None] + rest).ravel()
                    rb = r1[idx]
                    p1[idx] = np.where(np.repeat(left_dst, nres),
                                       np.minimum(1.0, rb + eta),
                                       np.maximum(0.0, rb - eta))
                    books.move_group(rr, rest, ov, dst)
                    self.assign[rr, rest] = dst
                    self.moved_at[rr, rest] = it
            else:
                pos = int(np.searchsorted(members_all, syn))
                mem[ov] = np.concatenate([members_all[:pos],
                                          members_all[pos + 1:]])
                darr = mem[new_spu]
                pos = int(np.searchsorted(darr, syn))
                mem[new_spu] = np.concatenate(
                    [darr[:pos], np.array([syn], darr.dtype), darr[pos:]])
            # only ov and the destination changed occupancy: refresh their
            # two Eq. (10) entries in place instead of rebuilding [M]
            k, l = self.hw.concentration, self.hw.unified_mem_depth
            for i in (ov, new_spu):
                scores[i] = l - (-(-(int(books.n_weights[rr, i]) + 1) // k)
                                 + int(books.n_posts[rr, i]))
            self._note_progress(rr, it)
        return False

    # -- the lockstep loop ---------------------------------------------------

    def run(self, *, early_exit: bool = True,
            deadline: float | None = None) -> bool:
        """Advance all restarts; returns True if the wall-clock budget
        cut the search short."""
        for it in range(self.max_iters):
            if self.done.all():
                return False
            feasible_now = False
            for rr in range(self.n):
                # deadline INSIDE the restart sweep: one restart's step is
                # the atomic unit, so a slow sweep over a large population
                # cannot overshoot the budget by more than a single step
                if deadline is not None and time.perf_counter() >= deadline:
                    self._abort_active(it)
                    return True
                if not self.done[rr] and self._step(rr, it):
                    feasible_now |= self.results[rr].feasible
            if early_exit and feasible_now:
                self._abort_active(it)
                return False
        # max_iters exhausted: remaining restarts fall back to best state
        for rr in range(self.n):
            if not self.done[rr]:
                self._finish(rr, self.max_iters, from_best=True)
        return False

    def _abort_active(self, it: int) -> None:
        for rr in range(self.n):
            if not self.done[rr]:
                self._finish(rr, it, from_best=True)


def framework_partition(g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                        restarts: int = 1, max_iters: int = 50000,
                        eta: float = 0.25, move_mode: str = "decisive",
                        stagnation_window: int = 300, cooldown: int = 64,
                        scan_cap: int = 384, early_exit: bool = True,
                        deadline: float | None = None,
                        ) -> tuple[PartitionResult, list[PartitionResult],
                                   bool]:
    """Run the vectorized framework search over ``restarts`` seeds.

    Returns ``(winner, all_results, budget_exhausted)``. The winner is
    the lowest-seed feasible restart, else the best worst-SPU score
    (earliest seed on ties). With ``restarts > 1`` the lockstep
    population differs from the old serial loop (DESIGN.md §8): under
    ``early_exit`` the FIRST restart to reach feasibility wins by
    iteration count, where the serial loop ran seeds to completion in
    seed order — so multi-restart results may differ from pre-refactor
    runs. Single-restart behavior is bit-identical to the reference.
    """
    seeds = [seed + k for k in range(max(restarts, 1))]
    pop = _Population(g, hw, seeds, max_iters=max_iters, eta=eta,
                      move_mode=move_mode,
                      stagnation_window=stagnation_window,
                      cooldown=cooldown, scan_cap=scan_cap)
    exhausted = pop.run(early_exit=early_exit, deadline=deadline)
    results = [res for res in pop.results if res is not None]
    # same preference order as the old serial restart loop: the first
    # feasible seed, else the best worst-SPU score (earliest on ties)
    winner = next((res for res in results if res.feasible), None)
    if winner is None:
        winner = max(results, key=lambda res: res.scores.min())
    return winner, results, exhausted


# ---------------------------------------------------------------------------
# The portfolio search.
# ---------------------------------------------------------------------------

#: above this synapse count the "auto" portfolio also races ``multilevel``
LARGE_GRAPH_SYNAPSES = 50_000


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Knobs of the portfolio mapping search (``compile(search=...)``).

    ``extra_strategies`` names registered
    :class:`~repro_torch.core.mapping.strategies.MappingStrategy` entries
    raced alongside the baselines and framework restarts. The default
    ``"auto"`` races ``hypergraph`` always and adds ``multilevel``
    above :data:`LARGE_GRAPH_SYNAPSES` synapses; pass ``()`` for the
    pre-§11 portfolio.

    ``workers > 1`` fans the mapping candidates across a process pool
    (:mod:`concurrent.futures`). Each framework restart then runs as an
    independent single-seed search (identical to
    ``framework_partition(seed=seed+k, restarts=1)``), and results are
    reduced in fixed candidate order, so the winner never depends on
    worker timing — only the wall-clock ``budget_seconds`` can shrink
    the candidate set (a deterministic PREFIX of it, plus the always-
    awaited first candidate). ``early_exit`` has no cross-restart
    effect in the parallel path.
    """
    restarts: int = 4                    # framework population size; also
                                         # sizes the multilevel coarse race
    seed: int = 0                        # first restart seed
    max_iters: int = 20000               # per-restart iteration budget
    include_baselines: bool = True       # race the round-robin seeds too
    early_exit: bool = True              # stop at the first feasible restart
    budget_seconds: float | None = None  # wall-clock cap on the whole search
    workers: int = 1                     # mapping-candidate process pool
    extra_strategies: tuple | str | None = "auto"    # see class docstring


@dataclasses.dataclass
class CandidateTrace:
    """One candidate mapping tried by the portfolio search."""
    strategy: str                 # "framework" or a baseline name
    seed: int | None              # restart seed (None for baselines)
    feasible: bool
    min_score: int                # worst-SPU Eq. (10) score
    iterations: int
    seconds: float
    ot_depth: int | None = None   # best strategy's depth (feasible only)
    memory_kb: float | None = None        # Eq. (11) at this OT depth
    memory_lines: int | None = None       # total UM lines the mapping uses
    selected: bool = False
    # joint co-optimization (§6.3): the best ScheduleStrategy for this
    # mapping, and the OT depth under every registered strategy
    schedule_method: str | None = None
    schedule_depths: dict | None = None


@dataclasses.dataclass
class SearchTrace:
    """Per-candidate record of one portfolio search."""
    candidates: list[CandidateTrace]
    seconds: float
    budget_exhausted: bool = False

    @property
    def n_feasible(self) -> int:
        return sum(c.feasible for c in self.candidates)

    @property
    def selected(self) -> CandidateTrace:
        return next(c for c in self.candidates if c.selected)

    def to_json(self) -> dict:
        return {"seconds": self.seconds,
                "budget_exhausted": self.budget_exhausted,
                "candidates": [dataclasses.asdict(c)
                               for c in self.candidates]}

    @classmethod
    def from_json(cls, d: dict) -> "SearchTrace":
        return cls(candidates=[CandidateTrace(**c)
                               for c in d.get("candidates", [])],
                   seconds=float(d.get("seconds", 0.0)),
                   budget_exhausted=bool(d.get("budget_exhausted", False)))


def _resolve_extras(cfg: SearchConfig, g: SNNGraph) -> tuple:
    if cfg.extra_strategies == "auto":
        return (("hypergraph", "multilevel")
                if g.n_synapses > LARGE_GRAPH_SYNAPSES else ("hypergraph",))
    return tuple(cfg.extra_strategies or ())


def _eval_spec(g: SNNGraph, hw: HardwareConfig, spec: tuple, seed: int,
               max_iters: int, budget: float | None = None,
               restarts: int = 1, strategy_workers: int = 1
               ) -> tuple[PartitionResult, float]:
    """Evaluate one mapping candidate (a process-pool work item).

    ``spec`` is ``("framework", restart_seed)``, ``("baseline", name)``
    or ``("strategy", name)``. Top-level so it pickles; strategies are
    resolved from the import-time registry. Workers start via *spawn*
    (a fork of a parent that holds a CUDA context is unsafe; importing
    the port in a child touches no card and builds no kernel), so only
    strategies registered at import of ``repro_torch.core.mapping`` exist
    in the children — a custom ``extra_strategies`` entry registered at
    runtime needs ``workers=1`` and surfaces here as a ``KeyError``.

    ``restarts``/``strategy_workers`` parameterize ``("strategy", ...)``
    specs only (the multilevel coarse-candidate race); framework specs
    are one restart each by construction. ``strategy_workers`` stays 1
    inside a pool worker — nesting process pools would oversubscribe —
    and strategy results are worker-count-invariant, so the serial and
    parallel portfolio paths still agree.
    """
    kind, val = spec
    t0 = time.perf_counter()
    if kind == "framework":
        deadline = None if budget is None else t0 + budget
        res, _, _ = framework_partition(g, hw, seed=val, restarts=1,
                                        max_iters=max_iters,
                                        deadline=deadline)
    elif kind == "baseline":
        from repro_torch.core.baselines import BASELINES
        res = BASELINES[val](g, hw)
    else:
        from repro_torch.core.mapping.strategies import get_strategy
        res = get_strategy(val).partition(g, hw, seed=seed,
                                          max_iters=max_iters,
                                          restarts=restarts,
                                          workers=strategy_workers)
    return res, time.perf_counter() - t0


def _trace_of(spec: tuple, cfg: SearchConfig, res: PartitionResult,
              seconds: float) -> CandidateTrace:
    kind, val = spec
    return CandidateTrace(
        strategy="framework" if kind == "framework" else val,
        seed=(val if kind == "framework"
              else cfg.seed if kind == "strategy" else None),
        feasible=res.feasible, min_score=int(res.scores.min()),
        iterations=res.iterations, seconds=seconds)


def _parallel_candidates(g, hw, cfg: SearchConfig, specs: list[tuple],
                         deadline: float | None
                         ) -> tuple[list, bool]:
    """Fan the candidate specs over a process pool; reduce in spec order.

    The first candidate is always awaited (compile needs at least one
    mapping); afterwards each result gets whatever budget remains, and
    a timeout abandons the rest — the surviving set is a prefix of the
    fixed spec order, never a function of which worker finished first.
    """
    import concurrent.futures as cf
    import multiprocessing

    entries: list[tuple[CandidateTrace, PartitionResult]] = []
    exhausted = False
    budget = None if deadline is None \
        else max(deadline - time.perf_counter(), 0.05)
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=cfg.workers,
                                mp_context=ctx) as ex:
        futs = [ex.submit(_eval_spec, g, hw, s, cfg.seed, cfg.max_iters,
                          budget, cfg.restarts) for s in specs]
        for i, fut in enumerate(futs):
            timeout = None
            if i > 0 and deadline is not None:
                timeout = max(deadline - time.perf_counter(), 0.0)
            try:
                res, secs = fut.result(timeout=timeout)
            except cf.TimeoutError:
                exhausted = True
                for other in futs[i:]:
                    other.cancel()
                ex.shutdown(wait=False, cancel_futures=True)
                break
            entries.append((_trace_of(specs[i], cfg, res, secs), res))
    return entries, exhausted


def portfolio_search(g: SNNGraph, hw: HardwareConfig,
                     config: SearchConfig | None = None):
    """Joint portfolio search over (mapping, schedule strategy) pairs.

    Framework restarts are raced against the round-robin baselines;
    every feasible candidate mapping is then scheduled under EVERY
    registered :class:`~repro_torch.core.scheduling.ScheduleStrategy`, and
    the joint pair minimizing (infeasible, OT depth, memory) wins —
    the paper's §6.3 co-optimization closed over both axes.

    Returns ``(part, trace, tables)`` where ``tables`` is the winner's
    already-scheduled OpTables under its best strategy (None if the
    winner is infeasible — callers schedule it themselves, matching
    single-seed ``compile``). The winning strategy and per-strategy
    depths ride on ``trace.selected.schedule_method`` /
    ``.schedule_depths``.
    """
    from repro_torch.core.baselines import BASELINES          # no import cycle
    from repro_torch.core.scheduling import (SCHEDULE_STRATEGIES, group_info,
                                       schedule)

    cfg = config or SearchConfig()
    t0 = time.perf_counter()
    deadline = None if cfg.budget_seconds is None else t0 + cfg.budget_seconds
    exhausted = False
    extras = _resolve_extras(cfg, g)

    if cfg.workers > 1:
        specs: list[tuple] = []
        if cfg.include_baselines:
            specs += [("baseline", name) for name in BASELINES]
        specs += [("strategy", name) for name in extras]
        specs += [("framework", cfg.seed + k)
                  for k in range(max(cfg.restarts, 1))]
        entries, exhausted = _parallel_candidates(g, hw, cfg, specs,
                                                  deadline)
    else:
        entries = []
        if cfg.include_baselines:
            for name, fn in BASELINES.items():
                if deadline is not None and time.perf_counter() >= deadline:
                    exhausted = True
                    break
                tb = time.perf_counter()
                res = fn(g, hw)
                entries.append((CandidateTrace(
                    strategy=name, seed=None, feasible=res.feasible,
                    min_score=int(res.scores.min()),
                    iterations=res.iterations,
                    seconds=time.perf_counter() - tb), res))

        for name in extras:
            if entries and deadline is not None \
                    and time.perf_counter() >= deadline:
                exhausted = True
                break
            res, secs = _eval_spec(g, hw, ("strategy", name), cfg.seed,
                                   cfg.max_iters, restarts=cfg.restarts,
                                   strategy_workers=cfg.workers)
            entries.append((_trace_of(("strategy", name), cfg, res, secs),
                            res))

        tb = time.perf_counter()
        _, fw_results, fw_exhausted = framework_partition(
            g, hw, seed=cfg.seed, restarts=cfg.restarts,
            max_iters=cfg.max_iters, early_exit=cfg.early_exit,
            deadline=deadline)
        exhausted |= fw_exhausted
        fw_seconds = time.perf_counter() - tb
        for k, res in enumerate(fw_results):
            entries.append((CandidateTrace(
                strategy="framework", seed=cfg.seed + k,
                feasible=res.feasible, min_score=int(res.scores.min()),
                iterations=res.iterations,
                seconds=fw_seconds / max(len(fw_results), 1)), res))

    # schedule the feasible candidates under EVERY registered schedule
    # strategy: min OT depth over strategies decides the race, with
    # total memory-line usage (the assignment's real footprint — memory_kb
    # is a pure function of depth for fixed hw) as the tie-breaker. The
    # budget still applies: once it is spent, at least one feasible
    # candidate is scheduled (compile needs its tables) and the rest keep
    # ot_depth=None. Strategy ties go to the earliest-registered name
    # (the 'slack' default), so results are deterministic.
    scheduled: dict[int, object] = {}
    m, l = hw.n_spus, hw.unified_mem_depth
    for i, (ct, res) in enumerate(entries):
        if not ct.feasible:
            continue
        ct.memory_lines = int(m * l - res.scores.sum())     # Eq. (10) sum
        if scheduled and deadline is not None \
                and time.perf_counter() >= deadline:
            exhausted = True
            continue
        info = group_info(g, res.assign)        # one grouping, S strategies
        depths: dict[str, int] = {}
        best_tables = best_name = None
        for name in SCHEDULE_STRATEGIES:
            tables = schedule(g, res.assign, hw, method=name, info=info)
            depths[name] = int(tables.depth)
            if best_tables is None or tables.depth < best_tables.depth:
                best_tables, best_name = tables, name
        scheduled[i] = best_tables
        ct.ot_depth = int(best_tables.depth)
        ct.schedule_method = best_name
        ct.schedule_depths = depths
        ct.memory_kb = float(total_memory_kb(hw, best_tables.depth))

    feasible = [i for i, (ct, _) in enumerate(entries) if ct.feasible]
    if feasible:
        win = min(feasible,
                  key=lambda i: (entries[i][0].ot_depth is None,
                                 entries[i][0].ot_depth or 0,
                                 entries[i][0].memory_lines))
    else:   # nothing feasible anywhere: closest-to-feasible candidate
        win = max(range(len(entries)),
                  key=lambda i: entries[i][0].min_score)
    ct, best = entries[win]
    ct.selected = True
    tables = scheduled.get(win)     # winner's tables, reused by compile
    trace = SearchTrace(candidates=[c for c, _ in entries],
                        seconds=time.perf_counter() - t0,
                        budget_exhausted=exhausted)
    return best, trace, tables
