"""Counts of nemotron3-nano-30b-a3b-serve: its shapes
(``nemotron3-nano-30b-a3b-serve.json``) bound to the formulas of
:mod:`portbench.counts_nemotron_h`."""

from portbench.counts_nemotron_h import NemotronH


def counts(config: dict) -> NemotronH:
    return NemotronH.from_config(config)
