"""The attention backward's launch plan and tiles, held on the CPU.

``attention_bwd_plan`` picks G, the query-head groups a KV head's dK/dV
blocks are split into, so that the grid fills one wave of the card's SMs;
``bwd_tiles`` mirrors the CUDA source's tiles and shared memory (the card
test ``test_attention_bwd_smem_matches_the_source_on_card`` holds the
mirror against the source's own numbers).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as pfa

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shape,dtype,groups,blocks", [
    # recurrentgemma-9b's training shape: MQA 16/1 at batch 1, D 256
    ((1, 16, 1, 4096, 4096, 256), BF16, 2, 64),
    ((1, 16, 1, 4096, 4096, 256), F32, 1, 128),
    # tinyllama-1.1b's (4, 32/4, 2,048, D 64) and qwen3-4b's (1, 32/8,
    # 2,048, D 128)
    ((4, 32, 4, 2048, 2048, 64), BF16, 1, 256),
    ((4, 32, 4, 2048, 2048, 64), F32, 1, 1024),
    ((1, 32, 8, 2048, 2048, 128), BF16, 1, 128),
    ((1, 32, 8, 2048, 2048, 128), F32, 1, 512),
])
def test_plan_at_the_main_path_shapes(shape, dtype, groups, blocks):
    plan = pfa.attention_bwd_plan(*shape, dtype)
    assert (plan.groups, plan.blocks) == (groups, blocks)
    assert plan.blocks * plan.groups <= plan.wave or plan.groups == 1


def _divisors(n):
    return [g for g in range(1, n + 1) if n % g == 0]


@pytest.mark.parametrize("d", pfa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_groups_divide_the_group_and_keep_one_wave(d, dtype):
    """G divides Hq / Hkv, blocks x G never passes one wave where G > 1,
    and G is the largest such divisor; bfloat16 at D <= 128 takes 1."""
    for b in (1, 2, 4):
        for hq, hkv in ((1, 1), (4, 1), (16, 1), (8, 2), (32, 4), (12, 3),
                        (48, 8)):
            for tk in (1, 33, 100, 1000, 4096):
                plan = pfa.attention_bwd_plan(b, hq, hkv, tk, tk, d, dtype)
                rep = hq // hkv
                assert rep % plan.groups == 0
                if plan.groups > 1:
                    assert plan.blocks * plan.groups <= plan.wave
                if dtype == BF16 and d <= 128:
                    assert plan.groups == 1
                    continue
                fits = [g for g in _divisors(rep)
                        if plan.blocks * g <= plan.wave]
                assert plan.groups == max(fits, default=1)


def test_plan_takes_the_card_sm_count():
    shape = (1, 16, 1, 4096, 4096, 256)
    assert pfa.attention_bwd_plan(*shape, BF16, sms=132).groups == 2
    assert pfa.attention_bwd_plan(*shape, BF16, sms=264).groups == 4
    assert pfa.attention_bwd_plan(*shape, BF16, sms=100).groups == 1


@pytest.mark.parametrize("d", pfa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_every_instance_fits_a_block_of_shared_memory(d, dtype):
    tiles = pfa.bwd_tiles(d, dtype)
    assert 0 < tiles.kv_smem <= pfa.SMEM_LIMIT
    assert 0 < tiles.dq_smem <= pfa.SMEM_LIMIT
    # the blocks an SM holds fit its 228 KB (1 KB a block reserved)
    assert tiles.per_sm * (max(tiles.kv_smem, tiles.dq_smem) + 1024) \
        <= 228 * 1024


@pytest.mark.parametrize("d,kv_smem,dq_smem", [
    (16, 101440, 99392), (32, 101440, 99392), (64, 101440, 99392),
    (128, 199744, 197696)])
def test_bf16_instances_up_to_d128_keep_their_tiles(d, kv_smem, dq_smem):
    """The bfloat16 instances at D <= 128 are the ones before the D 256
    redesign: 128 keys and 64 query rows a dK/dV block, 128 rows and 64
    keys a dQ block, no groups."""
    tiles = pfa.bwd_tiles(d, BF16)
    assert (tiles.kv_keys, tiles.kv_rows, tiles.dq_rows, tiles.dq_keys) == \
        (128, 64, 128, 64)
    assert (tiles.kv_smem, tiles.dq_smem) == (kv_smem, dq_smem)
    assert not tiles.takes_groups


def test_d256_bf16_tiles_pair_the_warpgroups():
    """D 256 in bfloat16: 64 keys shared by both warpgroups, Q and dO
    tiles of 32 rows in 4 stages, and the 32 KB fragment exchange."""
    tiles = pfa.bwd_tiles(256, BF16)
    assert (tiles.kv_keys, tiles.kv_rows) == (64, 32)
    assert tiles.kv_smem == 2 * 64 * 256 * 2 + 4 * 2 * 32 * 256 * 2 \
        + 4 * 2 * 32 * 4 + 32768 + 4 * 2 * 8 + 1024
    assert tiles.takes_groups
