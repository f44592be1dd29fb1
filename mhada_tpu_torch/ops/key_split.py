"""The split over the keys that K1's cross form (csrc/attention_combine.cuh)
and the MHAda tile of K3 and K4 at bfloat16 (csrc/mhada_combine.cuh) share:
the count's cost model and the float32 partials' layout.

A kernel whose grid is one block a (batch, head, query block) runs in waves
of the card's block slots, and a wave takes as long as its longest block,
so a grid that leaves slots idle (B = 1, 8 heads) costs a whole key walk in
one partial wave.  Splitting each query block's keys over several blocks,
each walking one contiguous range of whole 64-key tiles and writing float32
partials (row max, row sum, unnormalised sums) that a second kernel
combines in a fixed order, fills the waves at the price of the partials.
"""

import functools

import torch

KEY_TILE = 64
MAX_SPLITS = 8
# What the combine costs, in key tiles of one block's walk.
COMBINE_TILES = 1.0
# The bytes of float32 partials the combine reads, at the card's memory
# rate, in the time of one key tile of the bf16 tiles' walk (~1 us on an
# H100).
TILE_BYTES = 3.35e6


def pick_splits(blocks: int, tiles: int, slots: int, overhead: float,
                split_overhead: float = 0.0,
                combine_per_split: float = 0.0) -> int:
    """The count s of 1 .. min(tiles, MAX_SPLITS) minimising

        waves(s) x (ceil(tiles / s) + overhead + split_overhead (s > 1))
        + COMBINE_TILES + combine_per_split x s        (s > 1)

    in key tiles of one block's walk, where waves(s) = ceil(blocks s /
    slots): the one whose blocks come closest to whole waves of ``slots``
    block slots, weighed by what a block costs besides its key walk
    (``overhead``: set-up, pipeline fill; ``split_overhead``: a split
    block's partials store) and by the combine (a launch, and reading
    each split's partials); ties go to the fewer splits.  So every split
    holds at least one key tile, and a grid of whole waves keeps 1."""
    def cost(s):
        if s == 1:
            return -(-blocks // slots) * (tiles + overhead)
        waves = -(-blocks * s // slots)
        return (waves * (-(-tiles // s) + overhead + split_overhead)
                + COMBINE_TILES + combine_per_split * s)

    return min(range(1, min(tiles, MAX_SPLITS) + 1),
               key=lambda s: (cost(s), s))


def check_splits(name: str, splits: int | None, keys: int) -> None:
    """Raise unless a forced count leaves every split a key tile."""
    if splits is not None and not 1 <= splits <= -(-keys // KEY_TILE):
        raise ValueError(f"{name}: {splits} splits of {keys} keys leave a "
                         f"split without a {KEY_TILE}-key tile")


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_partials(part: torch.Tensor, splits: int, batch: int, n: int,
                   channels: int, heads: int):
    """Views of a float32 partials buffer -> (O (splits, B, N, channels)
    unnormalised, m (splits, B, heads, N) the row max in log2 units, l
    (splits, B, heads, N) the row sum), the layout of
    csrc/attention_combine.cuh::Partials (the MHAda tile: channels = 2 C,
    [O1 | O2] a row)."""
    no = splits * batch * n * channels
    ns = splits * batch * heads * n
    return (part[:no].view(splits, batch, n, channels),
            part[no:no + ns].view(splits, batch, heads, n),
            part[no + ns:no + 2 * ns].view(splits, batch, heads, n))
