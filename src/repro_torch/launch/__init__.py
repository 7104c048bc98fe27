"""Launchers of the port (counterpart of repro/launch): ``serve``,
``train``, the production ``mesh`` and the ``dryrun`` that traces every
cell on it."""
