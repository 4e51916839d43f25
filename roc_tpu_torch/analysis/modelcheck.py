"""Bounded explicit-state model checker (``roc_tpu/analysis/modelcheck.py``)
— the protocol level's exhaustive half; the port runs its own copy.

Small-scope model checking in the TLA+/Alloy spirit, applied to the
three distributed protocols this repo actually ships: every model is a
hand-derived abstraction of the code (the extraction side of
:mod:`protocol_lint` pins the code's transition sites; the declared
invariants live in :mod:`protocol_specs`), explored by exhaustive BFS
over *every* interleaving and crash-at-any-step schedule within a hard
state budget.  Pure Python, no torch, deterministic — milliseconds, so
it rides the same preflight as the AST levels.

The three models:

- **router-lifecycle** (``serve/router.py``): one admitted request,
  two replicas that can crash at any step, retryable failures bounded
  by ``max_tries``, failover requeue guarded by the per-corpse
  ``rep.requeued`` flag, the monitor's deadline backstop, and
  ``close()``.  Invariants: a request completes at most once; a dead
  replica's orphans are requeued at most once per corpse; no
  completion lands after ``ServeClosed``; every reachable state has a
  path to a terminal (the deadline makes "never a hang" a theorem of
  the model, not a hope).
- **ckpt-commit** (``utils/checkpoint.py``): the v3 two-phase commit
  with two writer processes — un-commit (manifest removal) first,
  per-process shard renames, barrier, manifest publish last — with a
  whole-job crash allowed between any two operations.  Invariants:
  the manifest is only ever present when every shard it references
  has landed (publish-last), and restore never selects torn state
  from any crash point.
- **table-swap** (``serve/server.py``): one microbatch racing a
  versioned-table publish.  The dispatcher captures ``published()``
  ONCE per microbatch; the invariant is that every row of the batch
  is served from exactly that one version, under any interleaving of
  the swap.  The sharded-serving gather leg: the batch's
  second row is FOREIGN (owned by another shard) and must be fetched
  from the owner — the correct protocol pins the fetch to the
  captured version (a mismatched answer is re-gathered, never
  served), so a mid-rollout gather can't stage rows from a version
  the batch didn't capture.

Each model carries seedable bugs (``seed=`` names one) so the test
tier can prove the checker actually bites: ``double-requeue`` drops
the per-corpse requeue guard, ``manifest-first`` publishes the
manifest before the shard renames, ``swap-mid-query`` reads the live
published version per row instead of the captured one,
``live-qmode`` keeps the captured rows but picks the dequant
program from the live published version's quant spec — the
mid-rollout fp32→int8 window ``quant-spec-pinned`` exists for — and
``shard-gather`` drops the gather's version pin and serves
whatever the owner's live table answered, the cross-shard
version-mixing window ``gather-version-pinned`` exists for.
"""

from __future__ import annotations

from collections import deque, namedtuple
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# hard per-model cap on distinct states: the preflight contract is
# milliseconds, so exploration that would exceed this aborts with
# ``complete=False`` — which protocol_lint turns into a finding (an
# unexplorable model is a broken tripwire, not a pass).  The three
# shipped models explore well under 10k states combined.
STATE_BUDGET = 20_000

MODELS = ("router-lifecycle", "ckpt-commit", "table-swap")

# the canonical seedable bug per model (test fixtures)
SEEDS = {
    "router-lifecycle": "double-requeue",
    "ckpt-commit": "manifest-first",
    "table-swap": "swap-mid-query",
}

# additional seedable bugs: the quantized-rollout window —
# "live-qmode" keeps the captured version's ROWS but selects the
# dequant program by the LIVE published version's quant spec, the
# mid-rollout bug class quant-spec-pinned exists to catch
EXTRA_SEEDS = {
    # "shard-gather": the cross-shard gather serves whatever
    # version the owner's live table answered instead of refusing a
    # version != the microbatch's capture — the mixing window
    # gather-version-pinned exists to catch
    "table-swap": ("live-qmode", "shard-gather"),
}


@dataclass
class ModelReport:
    """One model's exploration verdict."""
    name: str
    invariants: Tuple[str, ...]
    states: int = 0
    transitions: int = 0
    complete: bool = True
    violations: List[Dict[str, Any]] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"model": self.name,
                "invariants": list(self.invariants),
                "states": self.states,
                "transitions": self.transitions,
                "complete": self.complete,
                "violations": self.violations}


def _trace(seen: Dict[Any, Any], state: Any) -> List[str]:
    """Action labels from the initial state to ``state`` (the BFS
    predecessor chain — a shortest counterexample schedule)."""
    labels: List[str] = []
    while seen[state] is not None:
        prev, label = seen[state]
        labels.append(label)
        state = prev
    return list(reversed(labels))


def _bfs(name: str,
         init: Any,
         step: Callable[[Any], List[Tuple[str, Any]]],
         invariants: List[Tuple[str, Callable[[Any], Optional[str]]]],
         liveness: Optional[Tuple[str, Callable[[Any], bool]]] = None,
         budget: int = STATE_BUDGET) -> ModelReport:
    """Exhaustive BFS from ``init``.  ``step`` returns the enabled
    transitions of a state (label, successor); ``invariants`` are
    state predicates returning a violation message or None;
    ``liveness`` (name, terminal_ok) flags any deadlocked state that
    is not a sanctioned terminal.  First violation per invariant is
    reported with its counterexample trace; exploration continues so
    one broken invariant cannot mask another."""
    names = tuple(n for n, _ in invariants) + (
        (liveness[0],) if liveness else ())
    rep = ModelReport(name=name, invariants=names)
    seen: Dict[Any, Any] = {init: None}
    frontier = deque([init])
    tripped: set = set()

    def check(state: Any) -> None:
        for inv_name, fn in invariants:
            if inv_name in tripped:
                continue
            msg = fn(state)
            if msg:
                tripped.add(inv_name)
                rep.violations.append({
                    "invariant": inv_name, "msg": msg,
                    "trace": _trace(seen, state)})

    check(init)
    while frontier:
        state = frontier.popleft()
        succ = step(state)
        if not succ and liveness and liveness[0] not in tripped \
                and not liveness[1](state):
            tripped.add(liveness[0])
            rep.violations.append({
                "invariant": liveness[0],
                "msg": "deadlock: state has no enabled transition "
                       "and is not a sanctioned terminal",
                "trace": _trace(seen, state)})
        for label, nxt in succ:
            rep.transitions += 1
            if nxt in seen:
                continue
            if len(seen) >= budget:
                rep.complete = False
                rep.states = len(seen)
                return rep
            seen[nxt] = (state, label)
            check(nxt)
            frontier.append(nxt)
    rep.states = len(seen)
    return rep


def _set(tup: tuple, i: int, v: Any) -> tuple:
    out = list(tup)
    out[i] = v
    return tuple(out)


# ------------------------------------------------ model 1: router

# owners: frozenset of replica ids the request is in flight on
# crashed/orphan: per-replica flags (orphan = "owned the request when
#   it crashed" — what _mark_dead's pending scan sees)
# observed: per-replica count of _mark_dead entries processed (the
#   reader-EOF and monitor-poll paths can BOTH get there; the
#   rep.requeued guard makes the second a no-op)
# requeues: per-replica failover-requeue count for the invariant
_R = namedtuple("_R", "owners crashed orphan observed requeues tries "
                      "closed terminal completions")

_MAX_TRIES = 2
_N_REPLICAS = 2


def _router_step(seed: Optional[str]
                 ) -> Callable[[Any], List[Tuple[str, Any]]]:
    seeded = seed == "double-requeue"
    # without the guard, _mark_dead can be fully processed twice per
    # corpse (reader EOF + monitor poll racing before the requeue
    # updates sub.replica) — each pass requeues the orphans again
    max_observe = 2 if seeded else 1

    def step(s: _R) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = []
        if s.terminal is not None:
            return out      # terminal states are frozen
        # monitor deadline: authoritative and replica-independent —
        # enabled in EVERY non-terminal state (the liveness witness)
        out.append(("deadline", s._replace(
            terminal="timeout", owners=frozenset())))
        if not s.closed:
            # close() pops pending and fails typed ServeClosed; a
            # late result for a popped sub is dropped (sub is None)
            out.append(("close", s._replace(
                closed=True, terminal="closed", owners=frozenset())))
        for r in sorted(s.owners):
            if s.crashed[r]:
                continue
            # replica answers ok → _on_result pops pending, completes
            out.append((f"ok@{r}", s._replace(
                terminal="ok", owners=frozenset(),
                completions=s.completions + 1)))
            # replica answers a retryable failure → re-dispatch,
            # bounded by max_tries
            if s.tries < _MAX_TRIES:
                targets = [t for t in range(_N_REPLICAS)
                           if not s.crashed[t]]
                for t in targets:
                    out.append((f"retry@{r}->{t}", s._replace(
                        owners=frozenset({t}), tries=s.tries + 1)))
            else:
                out.append((f"fail@{r}", s._replace(
                    terminal="error", owners=frozenset())))
        for r in range(_N_REPLICAS):
            if not s.crashed[r]:
                # the replica_sigkill drill: crash at any step
                out.append((f"crash@{r}", s._replace(
                    crashed=_set(s.crashed, r, True),
                    orphan=_set(s.orphan, r, r in s.owners))))
            elif s.observed[r] < max_observe:
                # _mark_dead (reader EOF or monitor poll)
                ns = s._replace(
                    observed=_set(s.observed, r, s.observed[r] + 1))
                requeue = s.orphan[r] and (seeded
                                           or s.requeues[r] == 0)
                if not requeue:
                    out.append((f"markdead@{r}", ns._replace(
                        owners=s.owners - {r})))
                    continue
                nreq = _set(s.requeues, r, s.requeues[r] + 1)
                survivors = [t for t in range(_N_REPLICAS)
                             if not s.crashed[t]]
                if not survivors:
                    out.append((f"markdead@{r}-lost", ns._replace(
                        owners=frozenset(), requeues=nreq,
                        terminal="lost")))
                else:
                    for t in survivors:
                        out.append((
                            f"markdead@{r}-requeue@{t}",
                            ns._replace(
                                owners=(s.owners - {r}) | {t},
                                requeues=nreq)))
        return out

    return step


def _router_model(seed: Optional[str], budget: int) -> ModelReport:
    init = _R(owners=frozenset({0}),
              crashed=(False,) * _N_REPLICAS,
              orphan=(False,) * _N_REPLICAS,
              observed=(0,) * _N_REPLICAS,
              requeues=(0,) * _N_REPLICAS,
              tries=1, closed=False, terminal=None, completions=0)
    invariants = [
        ("terminal-exactly-once", lambda s: (
            None if s.completions <= 1 else
            f"request completed {s.completions} times — a late/"
            f"duplicate result overwrote a terminal state")),
        ("failover-requeue-at-most-once", lambda s: (
            None if max(s.requeues) <= 1 else
            f"corpse requeued {max(s.requeues)} times — duplicate "
            f"_mark_dead passes re-dispatched the same orphans "
            f"(the rep.requeued guard)")),
        ("no-completion-after-close", lambda s: (
            None if not (s.closed and s.completions > 0) else
            "a result completed a request after ServeClosed — "
            "close() must pop pending first")),
    ]
    return _bfs("router-lifecycle", init, _router_step(seed),
                invariants,
                liveness=("deadline-liveness",
                          lambda s: s.terminal is not None),
                budget=budget)


# ------------------------------------------- model 2: ckpt commit

# two writer processes over a pre-existing COMMITTED old checkpoint
# (the replayed-epoch rewrite — the hardest case):
#   proc0: uncommit → [barrier] → replace shard0 → [barrier] → commit
#   proc1:            [barrier] → replace shard1 → [barrier]
# The PRE barrier is the fix this model forced on landing: without
# it, proc1's replace races proc0's un-commit and a crash in that
# window leaves the old manifest live over a half-replaced shard
# set.  Shards/manifest record the generation on disk; crash freezes
# the whole job at any point (the SIGKILL-in-commit drill).
_C = namedtuple("_C", "pc0 pc1 shards manifest crashed")

_OPS0 = ("uncommit", "barrier-pre", "replace0", "barrier-commit",
         "commit")
# the seeded bug publishes the manifest before its shard rename
_OPS0_SEEDED = ("uncommit", "barrier-pre", "commit", "replace0",
                "barrier-commit")
_OPS1 = ("barrier-pre", "replace1", "barrier-commit")


def _ckpt_apply(s: _C, op: str) -> _C:
    if op == "uncommit":
        return s._replace(manifest="absent")
    if op == "replace0":
        return s._replace(shards=_set(s.shards, 0, "new"))
    if op == "replace1":
        return s._replace(shards=_set(s.shards, 1, "new"))
    if op == "commit":
        return s._replace(manifest="new")
    return s    # barrier mutates nothing on disk


def _ckpt_step(seed: Optional[str]
               ) -> Callable[[Any], List[Tuple[str, Any]]]:
    ops0 = _OPS0_SEEDED if seed == "manifest-first" else _OPS0

    def step(s: _C) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = []
        if s.crashed:
            return out
        done0, done1 = s.pc0 >= len(ops0), s.pc1 >= len(_OPS1)
        op0 = None if done0 else ops0[s.pc0]
        op1 = None if done1 else _OPS1[s.pc1]
        at_b0 = op0 is not None and op0.startswith("barrier")
        at_b1 = op1 is not None and op1.startswith("barrier")
        if at_b0 and at_b1 and op0 == op1:
            # the multi-writer barrier releases both procs together
            out.append((op0, s._replace(pc0=s.pc0 + 1,
                                        pc1=s.pc1 + 1)))
        else:
            if not done0 and not at_b0:
                out.append((f"p0:{op0}",
                            _ckpt_apply(s, op0)._replace(
                                pc0=s.pc0 + 1)))
            if not done1 and not at_b1:
                out.append((f"p1:{op1}",
                            _ckpt_apply(s, op1)._replace(
                                pc1=s.pc1 + 1)))
        if not (done0 and done1):
            # whole-job SIGKILL between any two operations
            out.append(("crash", s._replace(crashed=True)))
        return out

    return step


def _ckpt_torn(s: _C) -> Optional[str]:
    """Restore's verdict on the disk state: the manifest (when
    present) must reference a fully-landed generation.  ``old`` +
    any new shard is exactly the window the un-commit-first step
    closes; ``new`` + any old shard is the publish-last window."""
    if s.manifest == "absent":
        return None     # uncommitted dir: restore falls back, by design
    if any(sh != s.manifest for sh in s.shards):
        return (f"manifest '{s.manifest}' is live while shards are "
                f"{list(s.shards)} — restore would select torn state")
    return None


def _ckpt_model(seed: Optional[str], budget: int) -> ModelReport:
    init = _C(pc0=0, pc1=0, shards=("old", "old"), manifest="old",
              crashed=False)
    invariants = [
        ("manifest-published-last", lambda s: (
            None if not (s.manifest == "new"
                         and any(sh != "new" for sh in s.shards))
            else "manifest committed before every shard rename "
                 "landed — the commit record points at files that "
                 "may never exist")),
        ("restore-never-torn", _ckpt_torn),
    ]
    return _bfs("ckpt-commit", init, _ckpt_step(seed), invariants,
                budget=budget)


# -------------------------------------------- model 3: table swap

# one two-row microbatch racing one publish: the dispatcher captures
# published() once (step 0), then serves each row from the capture.
# The publish is a QUANTIZED rollout — version 0 is fp32,
# version 1 int8 (_QMODE), so every served row records the (version,
# decode-mode) pair and quant-spec-pinned can distinguish "read the
# wrong version's rows" from "decoded the right rows with the wrong
# version's program".
# Row 1 is FOREIGN (owned by another shard) — serving it
# requires a gather first, which stages rows read from the owner's
# LIVE published table (``gathered`` records that version).  The
# correct protocol only serves the staged rows when the gathered
# version equals the capture (a mismatch is re-gathered); the
# shard-gather seed drops that pin.
_S = namedtuple("_S", "published captured gathered served step")

# the quant spec each published version carries (the mid-rollout
# fp32→int8 swap the serve tier's versioned publish protocol covers)
_QMODE = ("fp32", "int8")


def _swap_step(seed: Optional[str]
               ) -> Callable[[Any], List[Tuple[str, Any]]]:
    live_rows = seed == "swap-mid-query"
    live_mode = seed == "live-qmode"
    unpinned_gather = seed == "shard-gather"

    def step(s: _S) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = []
        done = s.step >= 3
        if s.published == 0 and not done:
            # add_edges / quantized rollout publishes v1 at any point
            out.append(("publish@v1:int8", s._replace(published=1)))
        if s.step == 0:
            out.append(("capture", s._replace(
                captured=s.published, step=1)))
        elif not done:
            row = s.step - 1
            # seeded bug 1 reads the LIVE published version's rows
            # instead of the microbatch's captured ones
            v = s.published if live_rows else s.captured
            # seeded bug 2 keeps the captured rows but selects the
            # dequant program by the LIVE version's quant spec
            m = _QMODE[s.published if live_mode else v]
            if row == 0:
                # row 0 is LOCAL: served straight from the capture
                out.append((f"serve_row{row}@v{v}:{m}", s._replace(
                    served=_set(s.served, row, (v, m)),
                    step=s.step + 1)))
            else:
                # row 1 is FOREIGN: a gather (re-gather) reads the
                # owner's live published table at any point...
                out.append((f"gather@v{s.published}", s._replace(
                    gathered=s.published)))
                # ...and the staged rows are served only once the
                # gathered version matches the pin — unless the
                # shard-gather seed dropped the pin check
                if s.gathered is not None and (
                        unpinned_gather or s.gathered == s.captured):
                    out.append((
                        f"serve_row{row}@v{v}:{m}"
                        f":staged@v{s.gathered}",
                        s._replace(served=_set(s.served, row, (v, m)),
                                   step=s.step + 1)))
        return out

    return step


def _swap_invariant(s: _S) -> Optional[str]:
    got = {v for v, _ in (x for x in s.served if x is not None)}
    if len(got) > 1 or (got and s.captured is not None
                        and got != {s.captured}):
        return (f"microbatch served rows from versions "
                f"{sorted(got)} (captured v{s.captured}) — every "
                f"microbatch must come from exactly one published "
                f"version")
    return None


def _swap_quant_invariant(s: _S) -> Optional[str]:
    for x in s.served:
        if x is None:
            continue
        v, m = x
        if m != _QMODE[v]:
            return (f"row read from v{v} ({_QMODE[v]} table) was "
                    f"decoded with the {m} program — the quant spec "
                    f"must travel WITH the captured version, not be "
                    f"re-read from the live publication mid-batch")
    return None


def _swap_gather_invariant(s: _S) -> Optional[str]:
    # checked once the FOREIGN row was served: ``gathered`` is frozen
    # after the serve (gathers are only offered before it), so it IS
    # the version the staged rows came from
    if s.served[1] is not None and s.gathered != s.captured:
        return (f"foreign row served from rows gathered at "
                f"v{s.gathered} into a batch that captured "
                f"v{s.captured} — a cross-shard gather must be "
                f"pinned to the captured version (mismatched answers "
                f"are re-gathered, never served)")
    return None


def _swap_model(seed: Optional[str], budget: int) -> ModelReport:
    init = _S(published=0, captured=None, gathered=None,
              served=(None, None), step=0)
    return _bfs("table-swap", init, _swap_step(seed),
                [("single-version-batch", _swap_invariant),
                 ("quant-spec-pinned", _swap_quant_invariant),
                 ("gather-version-pinned", _swap_gather_invariant)],
                budget=budget)


# ----------------------------------------------------- entry points

_BUILDERS = {
    "router-lifecycle": _router_model,
    "ckpt-commit": _ckpt_model,
    "table-swap": _swap_model,
}


def model_invariants() -> Dict[str, Tuple[str, ...]]:
    """Invariant names per model, AS IMPLEMENTED — cross-checked by
    protocol_lint against the declared protocol_specs tables (drift
    in either direction is a finding)."""
    out: Dict[str, Tuple[str, ...]] = {}
    for name in MODELS:
        out[name] = run_model(name, budget=1).invariants
    return out


def run_model(name: str, seed: Optional[str] = None,
              budget: int = STATE_BUDGET) -> ModelReport:
    """Explore one model exhaustively.  ``seed`` arms that model's
    known bug (:data:`SEEDS`) so the violation machinery can be
    regression-tested; unknown names raise."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown model {name!r}; have {MODELS}")
    known = (SEEDS.get(name),) + EXTRA_SEEDS.get(name, ())
    if seed is not None and seed not in known:
        raise ValueError(f"unknown seed {seed!r} for {name!r}; "
                         f"have {known}")
    return _BUILDERS[name](seed, budget)


def check_all(budget: int = STATE_BUDGET) -> List[ModelReport]:
    """Explore all three models (un-seeded: the shipped protocol)."""
    return [run_model(name, budget=budget) for name in MODELS]
