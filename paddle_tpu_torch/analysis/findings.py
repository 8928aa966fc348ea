"""Findings of the port's analyzers (port of ``paddle_tpu/analysis/findings.py``).

Every check reports through a common :class:`Finding` record so its
consumers (the kernel registry's CLI and admission, ``chip_smoke.py``,
the tests) can rank, count and diff results without caring which check
produced them.  The port has one analyzer so far, the kernel verifier
(:mod:`.kernel_lint`); its codes:

===========================  ==========================================
``krn-write-race``           two CTAs (grid points differing along a
                             ``parallel`` axis) write the same output
                             block: store order undefined; on the card,
                             two launches on one input that differ
``krn-coverage-hole``        output block footprints miss elements over
                             the grid: the holes keep garbage; on the
                             card, an output sentinel left unwritten
``krn-oob-read``             a block index outside the array's block
                             range (high), or an unmasked ragged last
                             block (medium); on the card, a NaN guard
                             band that reached the output
``krn-parallel-carry``       state read before written, carried across
                             a grid axis declared ``parallel`` (CTAs are
                             unordered)
``krn-alias-mismatch``       an in-place pair of operands with differing
                             shape or dtype
``krn-alias-raw``            an in-place input read through other blocks
                             than it is overwritten through
``krn-smem-over-budget``     a CTA's shared memory (static + dynamic)
                             exceeds the card's per-block limit (the
                             counterpart of ``krn-vmem-over-budget``);
                             on the card, the compiled kernel's shared
                             memory differs from the declared spec's
``krn-dynamic-index``        an index map that cannot be evaluated:
                             footprint checks skipped (advisory)
``krn-plain-mismatch``       on the card, the kernel's result is outside
                             its tolerance of the plain version (no TPU
                             counterpart: the JAX verifier never runs a
                             kernel)
===========================  ==========================================

Severity is ``high`` / ``medium`` / ``low``; ranking is by severity first,
then by the number of bytes at stake.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

__all__ = ["Finding", "Report", "SEVERITY_RANK"]

SEVERITY_RANK = {"high": 0, "medium": 1, "low": 2}


@dataclass
class Finding:
    code: str                 # taxonomy code, see module docstring
    severity: str             # "high" | "medium" | "low"
    message: str              # one-line human description
    where: str = ""           # arg path / HLO instruction name
    bytes: int = 0            # HBM bytes at stake (0 when unknown)
    suggestion: str = ""      # concrete next action

    def line(self) -> str:
        b = f" [{self.bytes / 1e6:.3f} MB]" if self.bytes else ""
        loc = f" @ {self.where}" if self.where else ""
        s = f"  -> {self.suggestion}" if self.suggestion else ""
        return f"{self.severity.upper():<7}{self.code:<28}{self.message}{loc}{b}{s}"


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def __bool__(self) -> bool:  # truthy iff something was found
        return bool(self.findings)

    def add(self, *args, **kwargs) -> Finding:
        f = Finding(*args, **kwargs)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        for k, v in other.meta.items():
            self.meta.setdefault(k, v)

    def ranked(self) -> List[Finding]:
        return sorted(
            self.findings,
            key=lambda f: (SEVERITY_RANK.get(f.severity, 3), -f.bytes, f.code))

    def counts(self) -> Dict[str, int]:
        """Findings per taxonomy code (what the lint gate diffs)."""
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return dict(sorted(out.items()))

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def report(self, top: int = 20) -> str:
        head = (f"lint: {len(self.findings)} finding(s)"
                + (f" — {self._counts_str()}" if self.findings else ""))
        lines = [head]
        lines.extend(f.line() for f in self.ranked()[:top])
        if len(self.findings) > top:
            lines.append(f"... {len(self.findings) - top} more")
        return "\n".join(lines)

    def _counts_str(self) -> str:
        return ", ".join(f"{c}:{n}" for c, n in self.counts().items())

    def to_json(self) -> str:
        return json.dumps({
            "counts": self.counts(),
            "meta": {k: v for k, v in self.meta.items()
                     if isinstance(v, (str, int, float, bool))},
            "findings": [vars(f) for f in self.ranked()],
        }, indent=2, sort_keys=True)
