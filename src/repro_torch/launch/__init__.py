"""Launchers of the port (counterpart of repro/launch): ``serve`` so far;
``train`` and the dry-run come with later slices."""
