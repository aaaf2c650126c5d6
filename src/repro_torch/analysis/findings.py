"""Findings, fingerprints and the checked-in baseline (counterpart of
``repro.analysis.findings``; plain Python, so a finding's fingerprint is
the reference's).

Every analysis pass (the reference's jaxpr audit, ring checker and AST
lint; the port's ring checker) reports :class:`Finding`s.  A finding's **fingerprint** is content-addressed —
``sha1(pass | rule | where | detail)`` — deliberately excluding line
numbers, so unrelated edits that shift code never churn the baseline.

The baseline (``analysis/baseline.json`` at the repo root) is the list of
*accepted* findings: pre-existing hazards that are understood and justified
(each entry keeps the human-readable context next to its fingerprint).  CI
fails only on findings whose fingerprint is NOT baselined, so the tool can
be landed with teeth without first burning down every historical wart —
exactly the new-findings-only discipline of `ruff --add-noqa` baselines or
clang-tidy's line filters, but stable against drift.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class Finding:
    """One violation reported by an analysis pass.

    ``where`` is a stable location id (``path:qualname`` for lint,
    ``entrypoint`` for audits, discipline id for the ring checker) —
    NOT a line number.  ``line`` is carried for display only and excluded
    from the fingerprint.
    """

    pass_name: str          # "lint" | "audit" | "rings"
    rule: str               # e.g. "host-sync-in-step", "donation-missing"
    where: str              # stable location (file:qualname or entrypoint)
    detail: str             # what exactly tripped (stable phrasing)
    line: int = 0           # display only

    @property
    def fingerprint(self) -> str:
        key = "|".join((self.pass_name, self.rule, self.where, self.detail))
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def __str__(self) -> str:
        loc = f"{self.where}:{self.line}" if self.line else self.where
        return (f"[{self.pass_name}/{self.rule}] {loc}: {self.detail} "
                f"(fp {self.fingerprint})")


@dataclass
class Report:
    """Aggregated result of one or more passes."""

    findings: list = field(default_factory=list)
    info: dict = field(default_factory=dict)   # pass -> free-form summary

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.info.update(other.info)

    def new_findings(self, baseline: set) -> list:
        return [f for f in self.findings if f.fingerprint not in baseline]

    def to_json(self, baseline: set) -> dict:
        return {
            "findings": [f.to_json() for f in self.findings],
            "new": [f.to_json() for f in self.new_findings(baseline)],
            "baselined": sorted(
                f.fingerprint for f in self.findings
                if f.fingerprint in baseline),
            "info": self.info,
        }


def load_baseline(path: str) -> set:
    """Accepted-finding fingerprints; a missing file is an empty baseline."""
    if not path or not os.path.exists(path):
        return set()
    with open(path) as fh:
        data = json.load(fh)
    return {e["fingerprint"] for e in data.get("accepted", [])}


def _is_real_justification(text) -> bool:
    t = str(text or "").strip()
    return bool(t) and not t.upper().startswith("TODO")


def unjustified_entries(path: str) -> list:
    """Baselined entries whose justification is empty or a TODO
    placeholder.  CI fails on any: an accepted hazard nobody justified is
    a suppression, not a baseline."""
    if not path or not os.path.exists(path):
        return []
    with open(path) as fh:
        data = json.load(fh)
    return [e for e in data.get("accepted", [])
            if not _is_real_justification(e.get("justification"))]


def write_baseline(path: str, findings, justifications=None) -> None:
    """(Re)write the baseline to accept exactly ``findings`` — the
    ``--update-baseline`` flow.  Context rides along for the reader;
    ``justification`` strings hand-written into the checked-in file are
    preserved across rewrites (entries are keyed by fingerprint).

    Every entry must carry a real justification: for findings not already
    justified in the checked-in file, supply ``justifications`` —
    fingerprint -> text, with ``"*"`` as a catch-all — or the write is
    refused (no more ``TODO: justify or fix`` placeholders landing in CI).
    """
    justifications = dict(justifications or {})
    old = {}
    if os.path.exists(path):
        with open(path) as fh:
            old = {e["fingerprint"]: e
                   for e in json.load(fh).get("accepted", [])}
    entries = {}
    missing = []
    for f in sorted(findings, key=lambda f: (f.pass_name, f.rule, f.where)):
        if f.fingerprint in entries:
            continue
        just = old.get(f.fingerprint, {}).get("justification", "")
        if not _is_real_justification(just):
            just = justifications.get(f.fingerprint,
                                      justifications.get("*", ""))
        if not _is_real_justification(just):
            missing.append(f)
            continue
        entries[f.fingerprint] = {
            "fingerprint": f.fingerprint,
            "rule": f"{f.pass_name}/{f.rule}",
            "where": f.where,
            "detail": f.detail,
            "justification": str(just).strip(),
        }
    if missing:
        locs = ", ".join(f"{f.where} (fp {f.fingerprint})"
                         for f in missing[:5])
        raise ValueError(
            f"refusing to baseline {len(missing)} finding(s) without a "
            f"real justification: {locs}" + ("..." if len(missing) > 5
                                             else "")
            + " — pass --justify (or per-fingerprint justifications)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"accepted": list(entries.values())}, fh, indent=1,
                  sort_keys=True)
        fh.write("\n")
