"""Grid search and ASHA sweeps (``mlcomp_tpu/contrib/search``): cell
expansion and the rung arithmetic the sweep scheduler
(server/sweep.py) and the trainer share."""

from mlcomp_tpu_torch.contrib.search.grid import grid_cells

__all__ = ['grid_cells']
