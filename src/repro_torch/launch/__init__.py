"""Launchers of the port (counterpart of repro/launch): ``serve`` and
``train``. The reference's ``dryrun`` and ``mesh`` lower XLA programs on
a forced host mesh and are not ported."""
