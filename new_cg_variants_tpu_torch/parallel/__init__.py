"""Distributed execution on ``torch.distributed``: the row partition."""

from .contexts import RowShardContext
from .dist import dist_run, dist_solve, initialize_multihost, make_mesh
