"""R13 — raw-byte serialization of a possibly non-contiguous array.

The audit plane compares digests of the "same" payload
across ranks; the columnar/framed planes serialize arrays by raw
buffer. Both are only correct when the bytes are a CANONICAL function
of the values: ``x.tobytes()`` / ``memoryview(x)`` on a strided view
walks (or refuses) the underlying buffer differently than on a
contiguous copy, and a non-native-endian array byte-serializes
differently than an equal native one. Two ranks holding equal VALUES
in different layouts then digest differently — a **false divergence**
that fires the audit alarm on a healthy job (or frames corrupt bytes
on the wire). ``np.ascontiguousarray`` + a dtype/byte-order pin before
the byte read is the discipline (see ``obs.audit.canon_array``).

Heuristic: in ``comm/``, ``obs/``, ``transport/`` a ``memoryview(x)``
call on a bare name, or any ``x.tobytes()`` call, fires unless the
name was PINNED in its scope — assigned from a contiguity-guaranteeing
constructor (``ascontiguousarray``, ``astype``, ``empty``, ``zeros``,
``ones``, ``frombuffer``, ``bytearray``, ``bytes``, ``copy``,
``mmap``, ``canon_array``), from an already-pinned name, or from a
subscript of one (slices of freshly constructed 1-D buffers).
``memoryview(f(...))`` with a call argument stays quiet — the callee
owns that contract (e.g. ``_raw_view``, whose own internal
``memoryview`` is the baselined sanctioned site: its callers pin).
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name
from ytk_mp4j_tpu_torch.analysis.report import Finding, Severity

_PIN_FNS = frozenset({
    "ascontiguousarray", "astype", "empty", "zeros", "ones",
    "frombuffer", "bytearray", "bytes", "copy", "mmap", "canon_array",
})


class R13DigestContiguity(Rule):
    rule_id = "R13"
    severity = Severity.ERROR
    title = "raw-byte read of a possibly non-contiguous array"
    description = (".tobytes()/memoryview on an array that may be "
                   "non-contiguous or non-native-endian makes digests "
                   "and wire bytes a function of memory LAYOUT, not "
                   "values — a false-divergence hazard; pin with "
                   "np.ascontiguousarray (+ dtype/byte order) first")
    example = """\
def digest(arr):
    return crc32(arr.tobytes())     # strided/BE layout changes bytes
"""

    _MSG = ("{what} on {name!r} without a contiguity/dtype pin: a "
            "strided or non-native-endian array serializes different "
            "bytes for equal values (audit false divergence / corrupt "
            "frame); pass it through np.ascontiguousarray (or "
            "obs.audit.canon_array) first")

    def run(self, ctx):
        # collected during the walk, resolved afterwards (the pinning
        # assignment may appear after the use in source order)
        self._pinned: dict[str, set[str]] = {}
        self._uses: list[tuple[str, str, str, ast.AST]] = []
        return super().run(ctx)

    def visit_Module(self, node):               # noqa: N802
        if not self.ctx.in_dirs("comm", "obs", "transport"):
            return
        self.generic_visit(node)
        for what, name, qual, call in self._uses:
            if name and name in self._pinned.get(qual, ()):
                continue
            self.findings.append(Finding(
                rule=self.rule_id, severity=self.severity,
                path=self.ctx.path,
                line=getattr(call, "lineno", 0),
                col=getattr(call, "col_offset", 0) + 1,
                message=self._MSG.format(what=what,
                                         name=name or "<expr>"),
                context=qual))

    def visit_Assign(self, node):               # noqa: N802
        pin = self._pins(node.value)
        if pin:
            names = self._pinned.setdefault(self.qualname(), set())
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
        self.generic_visit(node)

    def _pins(self, value: ast.AST) -> bool:
        """Whether an assignment RHS guarantees a canonical buffer."""
        if isinstance(value, ast.Call):
            return call_name(value) in _PIN_FNS
        if isinstance(value, ast.Name):
            return value.id in self._pinned.get(self.qualname(), ())
        if isinstance(value, ast.Subscript):
            base = value.value
            return (isinstance(base, ast.Name)
                    and base.id in self._pinned.get(self.qualname(), ()))
        return False

    def visit_Call(self, node):                 # noqa: N802
        qual = self.qualname()
        f = node.func
        if (isinstance(f, ast.Name) and f.id == "memoryview"
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Name)):
            self._uses.append(("memoryview()", node.args[0].id, qual,
                               node))
        elif isinstance(f, ast.Attribute) and f.attr == "tobytes":
            name = f.value.id if isinstance(f.value, ast.Name) else ""
            self._uses.append((".tobytes()", name, qual, node))
        self.generic_visit(node)
