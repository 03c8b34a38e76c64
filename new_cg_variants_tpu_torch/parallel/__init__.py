"""Distributed execution on ``torch.distributed``: the row and column
partitions."""

from .contexts import ColShardContext, RowShardContext
from .dist import dist_run, dist_solve, initialize_multihost, make_mesh
