from .bincount import METHODS, bincount2d, bincount2d_scatter  # noqa: F401
from .digitize import digitize_edges, joint_bin_index  # noqa: F401
