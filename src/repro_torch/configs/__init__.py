"""Design-point configs of the port (counterpart of repro/configs).

Only the paper's own artifact, :mod:`cgra_amber`, is ported; the
reference's LM configs belong to the LM substrate, which comes later.
"""
