"""``python -m canal_torch.search`` — search-driven DSE CLI (counterpart
of :mod:`canal.search`).

Thin entry point; the implementation lives in
:mod:`repro_torch.core.search.cli`. See that module (or ``--help``) for
the axes/selector/constraint flags and the exit-code contract. Note the
function ``canal_torch.search(...)`` (the library API) is defined on
the ``canal_torch`` package itself, not in this module.
"""
from repro_torch.core.search.cli import build_parser, run  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(run())
