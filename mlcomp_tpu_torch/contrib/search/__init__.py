"""Grid search (``mlcomp_tpu/contrib/search``): cell expansion only; the
ASHA sweep scheduler comes with the supervisor (ROADMAP.md, A0)."""

from mlcomp_tpu_torch.contrib.search.grid import grid_cells

__all__ = ['grid_cells']
