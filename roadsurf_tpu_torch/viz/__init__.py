"""Charts of the evaluation stages: a copy of the reference package's
``viz/`` (standalone HTML with inline SVG, numpy only, no torch)."""

from .charts import Figure

__all__ = ["Figure"]
