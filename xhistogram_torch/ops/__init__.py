from .bincount import (  # noqa: F401
    METHODS, bincount2d, bincount2d_onehot, bincount2d_scatter, bincount2d_sort,
)
from .digitize import digitize_edges, joint_bin_index  # noqa: F401
