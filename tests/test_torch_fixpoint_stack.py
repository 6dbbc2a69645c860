"""How the stacked fixpoint launches, from the packed shapes alone.

``kernels.zns_fixpoint.stack_launch`` picks the instance of a stacked
solve (thread-block clusters, a cluster a shard, or one cooperative grid),
the cluster size, the clusters and the rounds before the launch; the card
tests hold both instances against the plain version.  Here it runs on
hand-built ``PackedShards`` on the CPU, with the clusters that fit on the
card given by hand.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import zns_fixpoint as pfix

TILE = 2048
#: Clusters of 8 and of 16 blocks that fit on a card at once (an H100's
#: 132 SMs at two blocks an SM hold about 32 and 16).
FITS = {8: 32, 16: 16}


def _packed(groups):
    """PackedShards of shards whose blocks have the shapes of ``groups``
    (one list of (rows, length) a shard), each block over its own lanes."""
    shards = []
    for shapes in groups:
        blocks, n = [], 0
        for rows, length in shapes:
            g = (n + np.arange(rows * length)).reshape(rows, length)
            n += rows * length
            blocks.append((g.astype(np.int32), np.zeros((rows, length),
                                                         dtype=bool)))
        shards.append((blocks, n, None))
    return pfix.pack_shards(shards, torch.device("cpu"))


@pytest.mark.parametrize("groups,want", [
    # the runner's 16-shard plan: its widest pass 16 tiles, two a block of 8
    ([[(32, 750), (30, 858)]] + [[(5020, 1), (1, 5000)]] * 15,
     dict(instance="cluster", cluster=8, clusters=16, rounds=1, widest=16)),
    # every pass within 8 tiles
    ([[(4, 1500), (8, 750)]] * 3,
     dict(instance="cluster", cluster=8, clusters=3, rounds=1, widest=4)),
    ([[(8, 2048)]] * 2,
     dict(instance="cluster", cluster=8, clusters=2, rounds=1, widest=8)),
    ([[(9, 2048)], [(1, 10)]],
     dict(instance="cluster", cluster=8, clusters=2, rounds=1, widest=9)),
    # a pass of 17 to 32 tiles takes clusters of 16
    ([[(17, 2048)], [(1, 10)]],
     dict(instance="cluster", cluster=16, clusters=2, rounds=1, widest=17)),
    ([[(32, 2048)], [(1, 10)]],
     dict(instance="cluster", cluster=16, clusters=2, rounds=1, widest=32)),
    # a pass of 33 tiles takes three a block of 16: the grid instance
    ([[(33, 2048)], [(1, 10)]],
     dict(instance="grid", cluster=16, clusters=2, rounds=1, widest=33)),
    # the contended fleet's 2-shard plan: 64 tiles in its widest pass
    ([[(2, 200), (64, 1250), (2, 200), (60, 1336), (4, 20107)],
      [(1, 200), (32, 1250), (30, 1362), (2, 20049)]],
     dict(instance="grid", cluster=16, clusters=2, rounds=1, widest=64)),
    # more shards than clusters fit: clusters take shard after shard
    ([[(2, 300)]] * 70,
     dict(instance="cluster", cluster=8, clusters=32, rounds=3, widest=1)),
    ([[(3, 4097)]] * 40,
     dict(instance="cluster", cluster=8, clusters=32, rounds=2, widest=9)),
    ([[(20, 2048)]] * 40,
     dict(instance="cluster", cluster=16, clusters=16, rounds=3, widest=20)),
    # a stack of one shard, and shards with empty blocks
    ([[(1, 1)]],
     dict(instance="cluster", cluster=8, clusters=1, rounds=1, widest=1)),
    ([[(0, 5), (2, 10)], [(0, 0)]],
     dict(instance="cluster", cluster=8, clusters=2, rounds=1, widest=1)),
])
def test_stack_launch_from_packed_shapes(groups, want):
    """Cluster size (8 where the widest pass of any shard takes at most two
    tiles a block of 8, else 16), clusters (S, or as many as fit), rounds,
    and the instance (clusters where the widest pass takes at most two
    tiles a block)."""
    assert pfix.stack_launch(_packed(groups), FITS, TILE) == want


def test_stack_launch_widest_is_a_shards_own_pass():
    """The widest pass is one shard's block, not a slot summed over the
    shards as the grid instance's scratch is (packed.tiles)."""
    packed = _packed([[(16, 2048)]] * 4)
    assert packed.tiles(TILE) == 64
    shape = pfix.stack_launch(packed, FITS, TILE)
    assert (shape["widest"], shape["cluster"], shape["instance"]) == (
        16, 8, "cluster")


@pytest.mark.parametrize("fits,clusters,rounds", [({8: 1, 16: 1}, 1, 5),
                                                  ({8: 2, 16: 1}, 2, 3),
                                                  ({8: 5, 16: 1}, 5, 1),
                                                  ({8: 64, 16: 1}, 5, 1)])
def test_stack_launch_clusters_follow_the_card(fits, clusters, rounds):
    """The clusters are the fewer of S and those that fit; rounds the
    shards a cluster takes in turn."""
    shape = pfix.stack_launch(_packed([[(2, 300)]] * 5), fits, TILE)
    assert (shape["clusters"], shape["rounds"]) == (clusters, rounds)


def test_stack_launch_ignores_the_order_of_the_shards():
    """The launch follows the shards' shapes, not where a shard stands in
    the stack: a wide shard first, last or in the middle launches alike."""
    wide, narrow = [(20, 2048)], [(2, 300)]
    shapes = [pfix.stack_launch(_packed(g), FITS, TILE)
              for g in ([wide, narrow, narrow], [narrow, wide, narrow],
                        [narrow, narrow, wide])]
    assert shapes[0] == shapes[1] == shapes[2]
    assert (shapes[0]["instance"], shapes[0]["cluster"]) == ("cluster", 16)
