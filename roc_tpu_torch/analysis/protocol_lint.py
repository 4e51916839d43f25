"""The protocol auditor for the serve and checkpoint state machines
(``roc_tpu/analysis/protocol_lint.py``), over the port's files.

The serve tier speaks a line-JSON wire protocol (router ↔ replica)
and the checkpoint tier runs a two-phase commit; both are distributed
protocols — a wire vocabulary plus a state machine plus a
crash-consistency argument — and every remaining ROADMAP item (live
rollout, the autoscaler, elastic resize) extends them.  This level
keeps the three legs of that argument in lock-step:

1. **Extraction** (this module): walk the AST of the five protocol
   modules and recover the ACTUAL protocol — every ``{"kind": ...}``
   literal put on a wire via ``*.send(...)`` (one level of helper
   resolution covers ``wire.send(_error_payload(...))``), every
   ``msg.get("kind")`` comparison a receiver dispatches on, the
   per-send-site field sets, and the declared lifecycle/commit
   transition sites.
2. **Declaration** (:mod:`protocol_specs`): the spec tables.  Any
   disagreement with extraction is a finding — the spec is the
   extension point later changes must edit FIRST.
3. **Exhaustion** (:mod:`modelcheck`): bounded explicit-state BFS over
   the three protocol models; an invariant violation or an
   unexplorable model is a finding.

Rules (all under the shrink-only baseline / ``roc-lint: ok=<rule>``
pragma contract; pure AST + pure-Python BFS — no torch, milliseconds):

``wire-vocabulary``
    a kind is sent with no receiver branch (the receiver would treat
    it as noise — or worse, as a request), a handled kind is never
    sent (dead vocabulary, unless the spec sanctions it with
    ``sent: False``), or a kind-dispatching receiver has no explicit
    unknown-kind rejection (a typo'd or future kind falls through).
``wire-field-contract``
    a send site omits a field the spec requires for its kind, or
    carries a field the spec does not declare.
``protocol-spec-drift``
    spec and code disagree: a declared kind is never sent/handled, an
    observed kind is undeclared, a declared transition site no longer
    exists, or the model checker's invariant set drifted from
    ``MODEL_INVARIANTS``.
``modelcheck-invariant``
    a model's exhaustive exploration found an invariant violation
    (the finding carries the counterexample schedule), or exhausted
    its state budget (an unexplorable model is a broken tripwire).
``ckpt-commit-order``
    within one function, the checkpoint manifest is published before
    a shard rename — the one source of truth; the callee vocabulary lives in
    :mod:`protocol_specs`.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import protocol_specs as specs
from .ast_lint import pragma_ok
from .concurrency_lint import (TreeModel, ModuleModel, FuncDef,
                               _call_name, _walk_own)
from .findings import Finding
from .modelcheck import ModelReport, STATE_BUDGET, check_all

PROTOCOL_RULES = (
    "wire-vocabulary",
    "wire-field-contract",
    "protocol-spec-drift",
    "modelcheck-invariant",
    "ckpt-commit-order",
)


# ----------------------------------------------------------- extraction

@dataclass
class SendSite:
    """One ``*.send({...})`` call putting a kind on the wire.
    ``fields`` is None when the payload's keys are not statically
    resolvable (computed keys / ``**`` expansion)."""
    module: str
    func: str
    kind: str
    fields: Optional[Tuple[str, ...]]
    line: int


@dataclass
class HandleSite:
    """One receiver-side comparison against ``msg.get("kind")``."""
    module: str
    func: str
    kind: str
    line: int


@dataclass
class Dispatcher:
    """A receiver function that dispatches on kinds; ``rejects`` is
    True when it explicitly rejects unknown kinds (a ``!=``/``not
    in`` guard with a body, or an ``==`` chain with a final else)."""
    module: str
    func: str
    line: int
    rejects: bool


def _dict_kind_fields(node: ast.AST
                      ) -> Optional[Tuple[str, Optional[Tuple[str, ...]]]]:
    """(kind, field names) for a dict literal with a constant
    ``"kind"`` entry; fields None when any key is computed."""
    if not isinstance(node, ast.Dict):
        return None
    kind = None
    fields: List[str] = []
    resolvable = True
    for k, v in zip(node.keys, node.values):
        if k is None or not isinstance(k, ast.Constant) \
                or not isinstance(k.value, str):
            resolvable = False      # ** expansion or computed key
            continue
        fields.append(k.value)
        if k.value == "kind" and isinstance(v, ast.Constant) \
                and isinstance(v.value, str):
            kind = v.value
    if kind is None:
        return None
    return kind, (tuple(fields) if resolvable else None)


def _helper_payload(m: ModuleModel, call: ast.Call
                    ) -> Optional[Tuple[str, Optional[Tuple[str, ...]]]]:
    """One-level helper resolution: ``send(_error_payload(...))`` —
    scan the helper's returns for a kind-carrying dict literal."""
    name = _call_name(call)
    fd = m.funcs.get(name) if name else None
    if fd is None:
        return None
    for node in _walk_own(fd.node):
        if isinstance(node, ast.Return) and node.value is not None:
            got = _dict_kind_fields(node.value)
            if got is not None:
                return got
    return None


def _find_sends(m: ModuleModel) -> List[SendSite]:
    out: List[SendSite] = []
    for fd in sorted(set(m.funcs.values()), key=lambda f: f.qualname):
        for node in _walk_own(fd.node):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute) \
                    or node.func.attr != "send" or not node.args:
                continue
            arg = node.args[0]
            got = _dict_kind_fields(arg)
            if got is None and isinstance(arg, ast.Call):
                got = _helper_payload(m, arg)
            if got is None:
                continue
            kind, fields = got
            out.append(SendSite(m.rel, fd.qualname, kind, fields,
                                node.lineno))
    return out


def _is_get_kind(node: ast.AST) -> bool:
    """``<expr>.get("kind")``."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "kind")


def _kind_cmp(node: ast.AST, kindvars: set
              ) -> Optional[Tuple[List[str], bool]]:
    """(compared kinds, is_negative) when ``node`` compares a kind
    expression against constant string(s) — ``==``/``in`` positive,
    ``!=``/``not in`` negative (the rejection-guard shape)."""
    if not isinstance(node, ast.Compare) or len(node.ops) != 1:
        return None
    left, op, comp = node.left, node.ops[0], node.comparators[0]
    is_kind = (_is_get_kind(left)
               or (isinstance(left, ast.Name) and left.id in kindvars))
    if not is_kind:
        return None
    if isinstance(op, (ast.Eq, ast.NotEq)):
        if isinstance(comp, ast.Constant) and isinstance(comp.value,
                                                         str):
            return [comp.value], isinstance(op, ast.NotEq)
        return None
    if isinstance(op, (ast.In, ast.NotIn)) \
            and isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
        kinds = [el.value for el in comp.elts
                 if isinstance(el, ast.Constant)
                 and isinstance(el.value, str)]
        if kinds:
            return kinds, isinstance(op, ast.NotIn)
    return None


def _chain_has_else(node: ast.If, kindvars: set) -> bool:
    """True when an ``== kind`` if/elif chain bottoms out in a
    non-empty else — the chain-shaped unknown-kind rejection."""
    while True:
        if not node.orelse:
            return False
        if len(node.orelse) == 1 and isinstance(node.orelse[0], ast.If):
            nxt = node.orelse[0]
            if _kind_cmp(nxt.test, kindvars) is not None:
                node = nxt
                continue
        return True     # non-chain else body: the rejection branch


def _find_handles(m: ModuleModel
                  ) -> Tuple[List[HandleSite], List[Dispatcher]]:
    handles: List[HandleSite] = []
    dispatchers: List[Dispatcher] = []
    for fd in sorted(set(m.funcs.values()), key=lambda f: f.qualname):
        kindvars = {t.id for n in _walk_own(fd.node)
                    if isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and _is_get_kind(n.value)
                    for t in n.targets}
        fn_handles: List[HandleSite] = []
        rejects = False
        for node in _walk_own(fd.node):
            got = _kind_cmp(node, kindvars) if isinstance(
                node, ast.Compare) else None
            if got is not None:
                for kind in got[0]:
                    fn_handles.append(HandleSite(m.rel, fd.qualname,
                                                 kind, node.lineno))
            if isinstance(node, ast.If):
                test = _kind_cmp(node.test, kindvars)
                if test is None:
                    continue
                if test[1]:
                    rejects = True       # != / not-in guard
                elif _chain_has_else(node, kindvars):
                    rejects = True       # ==-chain with final else
        if fn_handles:
            handles.extend(fn_handles)
            dispatchers.append(Dispatcher(
                m.rel, fd.qualname,
                min(h.line for h in fn_handles), rejects))
    return handles, dispatchers


@dataclass
class ChannelExtract:
    spec: Dict[str, Any]
    sends: Optional[List[SendSite]]        # None: sender not in tree
    handles: Optional[List[HandleSite]]    # None: receiver not in tree
    dispatchers: Optional[List[Dispatcher]]


def extract_channels(tm: TreeModel) -> List[ChannelExtract]:
    """The observed wire protocol, one entry per declared channel.
    Channels whose modules are absent from the tree (synthetic test
    fixtures) extract as None and are skipped by the rules — the
    checks are spec-path-bound."""
    out: List[ChannelExtract] = []
    for chan in specs.WIRE_CHANNELS:
        smod = tm.modules.get(chan["sender"])
        rmod = tm.modules.get(chan["receiver"])
        sends = _find_sends(smod) if smod is not None else None
        handles, disp = (_find_handles(rmod) if rmod is not None
                         else (None, None))
        out.append(ChannelExtract(chan, sends, handles, disp))
    return out


# ---------------------------------------------------------------- rules

def check_wire_vocabulary(tm: TreeModel,
                          reports: List[ModelReport]) -> List[Finding]:
    findings: List[Finding] = []
    for ce in extract_channels(tm):
        chan = ce.spec
        name, kinds = chan["name"], chan["kinds"]
        if ce.sends is not None and ce.handles is not None:
            handled = {h.kind for h in ce.handles}
            sent = {s.kind for s in ce.sends}
            flagged: set = set()
            for s in ce.sends:
                if s.kind in handled or s.kind in flagged:
                    continue
                flagged.add(s.kind)
                findings.append(Finding(
                    "wire-vocabulary", chan["sender"],
                    f"kind '{s.kind}' is sent on {name} (in "
                    f"{s.func}) but {chan['receiver']} has no "
                    f"branch for it — the receiver would drop it "
                    f"as noise or misread it entirely",
                    line=s.line,
                    key=f"sent-unhandled|{name}|{s.kind}"))
            for kind in sorted(handled - sent):
                spec = kinds.get(kind)
                if spec is not None and spec.get("sent") is False:
                    continue        # sanctioned (spec carries a note)
                h = next(x for x in ce.handles if x.kind == kind)
                findings.append(Finding(
                    "wire-vocabulary", chan["receiver"],
                    f"kind '{kind}' is handled on {name} (in "
                    f"{h.func}) but {chan['sender']} never sends "
                    f"it — dead vocabulary (declare it sent: False "
                    f"in protocol_specs with a note, or delete the "
                    f"branch)",
                    line=h.line,
                    key=f"handled-unsent|{name}|{kind}"))
        if ce.dispatchers is not None:
            for d in ce.dispatchers:
                if d.rejects:
                    continue
                findings.append(Finding(
                    "wire-vocabulary", chan["receiver"],
                    f"{d.func} dispatches on msg kinds from {name} "
                    f"with no explicit unknown-kind rejection: a "
                    f"typo'd or future kind silently falls through "
                    f"— add a != guard or a final else that "
                    f"rejects/logs it",
                    line=d.line,
                    key=f"no-unknown-rejection|{name}|{d.func}"))
    return findings


def check_wire_field_contract(tm: TreeModel,
                              reports: List[ModelReport]
                              ) -> List[Finding]:
    findings: List[Finding] = []
    for ce in extract_channels(tm):
        if ce.sends is None:
            continue
        chan = ce.spec
        name = chan["name"]
        for s in ce.sends:
            spec = chan["kinds"].get(s.kind)
            if spec is None or s.fields is None:
                continue    # undeclared kind → drift rule's job
            allowed = set(spec["required"]) | set(spec.get("optional",
                                                           ()))
            for fld in spec["required"]:
                if fld not in s.fields:
                    findings.append(Finding(
                        "wire-field-contract", s.module,
                        f"send of kind '{s.kind}' in {s.func} omits "
                        f"required field '{fld}' ({name} contract)",
                        line=s.line,
                        key=f"missing|{name}|{s.kind}|{fld}"))
            for fld in s.fields:
                if fld not in allowed:
                    findings.append(Finding(
                        "wire-field-contract", s.module,
                        f"send of kind '{s.kind}' in {s.func} "
                        f"carries undeclared field '{fld}' — extend "
                        f"the {name} spec row first",
                        line=s.line,
                        key=f"undeclared|{name}|{s.kind}|{fld}"))
    return findings


def check_spec_drift(tm: TreeModel,
                     reports: List[ModelReport]) -> List[Finding]:
    findings: List[Finding] = []
    for ce in extract_channels(tm):
        chan = ce.spec
        name, kinds = chan["name"], chan["kinds"]
        if ce.sends is not None:
            sent = {s.kind for s in ce.sends}
            for kind, spec in sorted(kinds.items()):
                if spec.get("sent", True) and kind not in sent:
                    findings.append(Finding(
                        "protocol-spec-drift", chan["sender"],
                        f"spec declares kind '{kind}' sent on "
                        f"{name} but no send site exists — the "
                        f"spec row is stale (or the sender "
                        f"regressed)",
                        key=f"unsent|{name}|{kind}"))
                if spec.get("sent") is False and kind in sent:
                    s = next(x for x in ce.sends if x.kind == kind)
                    findings.append(Finding(
                        "protocol-spec-drift", chan["sender"],
                        f"spec declares kind '{kind}' as never-sent "
                        f"on {name} ({spec.get('note', 'no note')}) "
                        f"but {s.func} sends it",
                        line=s.line,
                        key=f"sent-despite-spec|{name}|{kind}"))
            for s in ce.sends:
                if s.kind not in kinds:
                    findings.append(Finding(
                        "protocol-spec-drift", chan["sender"],
                        f"kind '{s.kind}' (sent in {s.func}) is not "
                        f"declared in the {name} spec — add its row "
                        f"to protocol_specs.WIRE_CHANNELS first",
                        line=s.line,
                        key=f"undeclared-kind|{name}|{s.kind}"))
        if ce.handles is not None:
            handled = {h.kind for h in ce.handles}
            for kind in sorted(kinds):
                if kind not in handled:
                    findings.append(Finding(
                        "protocol-spec-drift", chan["receiver"],
                        f"spec declares kind '{kind}' on {name} but "
                        f"{chan['receiver']} has no handler branch "
                        f"for it",
                        key=f"unhandled|{name}|{kind}"))
            for kind in sorted(handled - set(kinds)):
                h = next(x for x in ce.handles if x.kind == kind)
                findings.append(Finding(
                    "protocol-spec-drift", chan["receiver"],
                    f"kind '{kind}' (handled in {h.func}) is not "
                    f"declared in the {name} spec",
                    line=h.line,
                    key=f"undeclared-kind|{name}|{kind}"))
    # declared transition sites must still exist
    for sites_table in (specs.LIFECYCLE_SITES, specs.COMMIT_SITES):
        for rel, quals in sites_table.items():
            m = tm.modules.get(rel)
            if m is None:
                continue
            for qual in quals:
                if qual not in m.funcs:
                    findings.append(Finding(
                        "protocol-spec-drift", rel,
                        f"declared protocol transition site {qual} "
                        f"no longer exists in {rel} — a rename/"
                        f"removal must edit the spec table too",
                        key=f"missing-site|{rel}|{qual}"))
    # the model checker's invariant sets must match the declared table
    actual = {r.name: tuple(r.invariants) for r in reports}
    for model in sorted(set(specs.MODEL_INVARIANTS) | set(actual)):
        want = specs.MODEL_INVARIANTS.get(model)
        got = actual.get(model)
        if want != got:
            findings.append(Finding(
                "protocol-spec-drift", f"model:{model}",
                f"invariant drift for model '{model}': spec "
                f"declares {list(want) if want else None}, checker "
                f"implements {list(got) if got else None}",
                key=f"invariant-drift|{model}"))
    return findings


def check_modelcheck(tm: TreeModel,
                     reports: List[ModelReport]) -> List[Finding]:
    findings: List[Finding] = []
    for r in reports:
        if not r.complete:
            findings.append(Finding(
                "modelcheck-invariant", f"model:{r.name}",
                f"model '{r.name}' exhausted its state budget "
                f"({r.states} states explored) — an unexplorable "
                f"model proves nothing; shrink the model or raise "
                f"STATE_BUDGET deliberately",
                key=f"{r.name}|budget"))
        for v in r.violations:
            sched = " -> ".join(v["trace"]) or "<initial state>"
            findings.append(Finding(
                "modelcheck-invariant", f"model:{r.name}",
                f"invariant '{v['invariant']}' violated in model "
                f"'{r.name}': {v['msg']} [schedule: {sched}]",
                key=f"{r.name}|{v['invariant']}",
                detail={"trace": v["trace"]}))
    return findings


def check_commit_order(tm: TreeModel,
                       reports: List[ModelReport]) -> List[Finding]:
    """The v3 two-phase-commit ORDER: within any function that both renames artifact files
    into place (``os.replace``) and publishes a checkpoint manifest,
    every publish must come AFTER the last rename — a manifest
    published before a shard rename points at files that may never
    land, exactly the torn read the commit protocol rules out."""
    findings: List[Finding] = []
    for rel in sorted(tm.modules):
        m = tm.modules[rel]
        for fd in sorted(set(m.funcs.values()),
                         key=lambda f: f.qualname):
            commits: List[int] = []
            replaces: List[int] = []
            for node in _walk_own(fd.node):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if name in specs.MANIFEST_COMMITTERS:
                    commits.append(node.lineno)
                elif name == "replace" and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == "os":
                    replaces.append(node.lineno)
            if not commits or not replaces:
                continue
            first_commit = min(commits)
            late = [ln for ln in replaces if ln > first_commit]
            if late:
                findings.append(Finding(
                    "ckpt-commit-order", m.rel,
                    f"{fd.qualname} publishes the checkpoint "
                    f"manifest (line {first_commit}) BEFORE a shard "
                    f"rename (line {late[0]}): the commit record "
                    f"would point at files that may never land — "
                    f"publish the manifest only after every shard's "
                    f"os.replace",
                    line=first_commit,
                    key=f"commit-order|{fd.qualname}"))
    return findings


_CHECKS = {
    "wire-vocabulary": check_wire_vocabulary,
    "wire-field-contract": check_wire_field_contract,
    "protocol-spec-drift": check_spec_drift,
    "modelcheck-invariant": check_modelcheck,
    "ckpt-commit-order": check_commit_order,
}


# -------------------------------------------------- surface + entrypoint

def protocol_surface(tm: TreeModel,
                     reports: List[ModelReport]) -> Dict[str, Any]:
    """The extracted protocol, machine-readable: per-channel kind
    tables (spec contract + observed send/handle sites), the
    lifecycle/commit transition-site index, the checkpoint artifact
    inventory, and each model's
    exploration verdict — the payload behind ``--json``'s
    ``protocol_surface`` and ``python -m roc_tpu_torch.report
    --protocol``."""
    channels: List[Dict[str, Any]] = []
    for ce in extract_channels(tm):
        chan = ce.spec
        sends = ce.sends or []
        handles = ce.handles or []
        kinds: Dict[str, Any] = {}
        for kind in sorted(set(chan["kinds"])
                           | {s.kind for s in sends}
                           | {h.kind for h in handles}):
            spec = chan["kinds"].get(kind)
            sent_at = sorted(s.line for s in sends if s.kind == kind)
            handled_at = sorted(h.line for h in handles
                                if h.kind == kind)
            if spec is None:
                status = "undeclared"
            elif (sent_at or spec.get("sent") is False) \
                    and handled_at:
                status = "ok"
            else:
                status = "drift"
            kinds[kind] = {
                "required": list(spec["required"]) if spec else None,
                "optional": list(spec.get("optional", ()))
                if spec else None,
                "sent": spec.get("sent", True) if spec else None,
                "note": spec.get("note") if spec else None,
                "sent_at": sent_at, "handled_at": handled_at,
                "status": status}
        channels.append({
            "name": chan["name"], "sender": chan["sender"],
            "receiver": chan["receiver"], "kinds": kinds,
            "dispatchers": [{"func": d.func, "line": d.line,
                             "rejects_unknown": d.rejects}
                            for d in (ce.dispatchers or [])]})
    sites: List[Dict[str, Any]] = []
    for machine, table in (("lifecycle", specs.LIFECYCLE_SITES),
                           ("commit", specs.COMMIT_SITES)):
        for rel in sorted(table):
            m = tm.modules.get(rel)
            if m is None:
                continue
            for qual in table[rel]:
                fd = m.funcs.get(qual)
                sites.append({
                    "machine": machine, "module": rel, "site": qual,
                    "line": fd.node.lineno if fd else None,
                    "present": fd is not None})
    artifacts: List[Dict[str, Any]] = []
    for rel in sorted(tm.modules):
        arts = specs.ckpt_artifact_entries(tm.modules[rel].tree)
        if arts:
            artifacts.append({"module": rel, "artifacts": arts})
    models = [r.to_json() for r in reports]
    return {
        "channels": channels,
        "sites": sites,
        "artifacts": artifacts,
        "models": models,
        "state_budget": STATE_BUDGET,
        "totals": {
            "channels": len(channels),
            "kinds": sum(len(c["kinds"]) for c in channels),
            "send_sites": sum(len(k["sent_at"])
                              for c in channels
                              for k in c["kinds"].values()),
            "sites": len(sites),
            "artifacts": sum(len(a["artifacts"]) for a in artifacts),
            "models": len(models),
            "states": sum(m["states"] for m in models),
            "transitions": sum(m["transitions"] for m in models),
            "violations": sum(len(m["violations"]) for m in models),
        }}


def run_protocol_lint(root: str,
                      select: Optional[List[str]] = None,
                      tree_model: Optional[TreeModel] = None,
                      model_reports: Optional[List[ModelReport]] = None
                      ) -> List[Finding]:
    """Run the selected (default: all) protocol rules over ``root``.
    Pure AST + bounded BFS — no torch, milliseconds.  Per-line pragma
    suppression applies to module-located findings; model-located
    findings (``model:*`` units) have no source line to waive."""
    tm = tree_model if tree_model is not None else TreeModel(root)
    need_models = select is None or any(
        s in ("modelcheck-invariant", "protocol-spec-drift")
        for s in select)
    reports = (model_reports if model_reports is not None
               else (check_all() if need_models else []))
    findings: List[Finding] = []
    for name, check in _CHECKS.items():
        if select is not None and name not in select:
            continue
        for f in check(tm, reports):
            m = tm.modules.get(f.unit)
            if m is not None and pragma_ok(m.lines, f.line, f.rule):
                continue
            findings.append(f)
    return findings


def audit_protocol(root: str,
                   select: Optional[List[str]] = None,
                   extras: Optional[Dict[str, Any]] = None,
                   tree_model: Optional[TreeModel] = None
                   ) -> List[Finding]:
    """Level-eight entry point for the driver: run the rules (one
    shared model-checking pass), stash the surface under
    ``extras['protocol']``, and emit it as a ``protocol`` event
    (kind=``protocol_surface``) so a run artifact documents its own
    wire vocabulary and ``python -m roc_tpu_torch.report --protocol`` can
    render the tables from the event stream alone."""
    from ..obs.events import emit
    tm = tree_model if tree_model is not None else TreeModel(root)
    reports = check_all()
    findings = run_protocol_lint(root, select=select, tree_model=tm,
                                 model_reports=reports)
    surface = protocol_surface(tm, reports)
    if extras is not None:
        extras["protocol"] = surface
    t = surface["totals"]
    emit("protocol",
         f"protocol surface: {t['kinds']} wire kind(s) on "
         f"{t['channels']} channel(s), {t['sites']} transition "
         f"site(s), {t['models']} model(s) / {t['states']} state(s) "
         f"explored, {t['violations']} violation(s)",
         console=False, kind="protocol_surface",
         channels=surface["channels"], models=surface["models"],
         totals=t)
    return findings
