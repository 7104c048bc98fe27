"""``python -m canal_torch.lint`` — static analysis CLI over design
points (counterpart of :mod:`canal.lint`).

Thin entry point; the implementation lives in
:mod:`repro_torch.core.analysis.lint`. See that module (or ``--help``)
for targets, output formats and the CI exit-code contract;
``--lowered`` runs the post-lowering verification on ``--device``
(default: the CUDA card).
"""
from repro_torch.core.analysis.lint import build_parser, run  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(run())
