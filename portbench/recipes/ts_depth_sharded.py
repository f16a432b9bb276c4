"""One rank's slab of a T-S record sharded on time over the cards of a
cell: the ``ts_depth`` recipe's levels, laws, land, sea floor and edges,
for the ``times // world`` time steps that rank ``rank`` holds, its T and
S drawn from the seed and the rank. Land and floor are the same on every
rank, as in every run.

``ts_depth`` fills each field in place, one (time, depth, cell) tensor at a
time, so a card's peak during set-up is its slab and a level-by-cell mask
(51.4 GB and 0.5 GB for a quarter of the 0.1-degree record).
"""

from __future__ import annotations

from portbench.recipes import ts_depth


def make(config, seed, device, fields, rank=0, world=1):
    times = config["times"]
    if times % world:
        raise ValueError(f"{times} time steps do not divide over {world} ranks")
    share = {**config, "times": times // world}
    # the generator's key is the seed, the rank, then the field's name
    return ts_depth.make(share, f"{seed}:rank{rank}", device, fields)
