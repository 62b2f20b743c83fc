"""Roofline terms of the dry run's counted cells (the reference's
``repro.roofline``): :mod:`analysis` (hardware and the three terms) and
:mod:`report` (the table of every cell).  The reference's
``roofline/hlo_parse.py`` shim has no counterpart: it re-exports the HLO
parser for callers the port never had."""
from repro_torch.analysis.cost import StepCost  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    HW_H100, HW_V5E, Hardware, roofline_terms,
)

__all__ = ["StepCost", "roofline_terms", "Hardware", "HW_H100", "HW_V5E"]
