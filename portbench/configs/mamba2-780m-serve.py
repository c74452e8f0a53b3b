"""Counts of mamba2-780m-serve: its shapes (``mamba2-780m-serve.json``) bound to the Mamba-2
formulas of :mod:`portbench.counts`."""

from portbench.counts import Mamba2


def counts(config: dict) -> Mamba2:
    return Mamba2.from_config(config)
