"""The port's runtime (``repro_torch.runtime``, ``repro_torch.utils``)
held against ``repro.runtime`` and ``repro.utils.tree`` on the CPU.

The checkpoint store's placement, modeled timing (the max-plus scans,
run here by their plain versions with ``device="cpu"``), manifests and
``.npz`` bytes against the reference's on the same trees, a bfloat16
leaf included; restores bit for bit; the control-plane policies on the
scenarios of ``tests/test_checkpoint.py``,
``tests/test_data_optim_runtime.py`` and
``tests/test_runtime_policies.py``, run through both packages.
"""
import collections
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import ZNSDeviceSpec as RSpec
from repro.runtime import elastic as relastic
from repro.runtime import failures as rfail
from repro.runtime import zns_store as rstore
from repro.utils import tree as rtree

from repro_torch.core import MiB, ZNSDeviceSpec
from repro_torch.runtime import elastic as pelastic
from repro_torch.runtime import failures as pfail
from repro_torch.runtime import zns_store as pstore
from repro_torch.utils import tree as ptree

#: Modeled seconds: both packages run the same float64 max-plus scan.
RTOL = 1e-12

SMALL = dict(zone_size_bytes=8 * MiB, zone_cap_bytes=4 * MiB, num_zones=64,
             max_open_zones=6, max_active_zones=8)

#: The write policies of examples/zns_checkpointing.py.
POLICIES = {
    "R2-1MiB-QD4": dict(stripe_bytes=1 * MiB, append_qd=4),
    "naive-4KiB-QD1": dict(stripe_bytes=4 * 1024, append_qd=1),
    "64KiB-QD4": dict(stripe_bytes=64 * 1024, append_qd=4),
    "tuned-4MiB-QD4": dict(stripe_bytes=4 * MiB, append_qd=4),
}


def _trees(seed=0):
    """The same tree for both packages: the reference's as numpy (its
    bfloat16 leaf an ``ml_dtypes`` array, as ``np.asarray`` of a jax array
    gives), the port's as torch tensors; dict keys deliberately
    unsorted."""
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((8, 16)).astype(np.float32)
    w2 = rng.standard_normal((4, 4, 4)).astype(np.float32)
    bf = rng.standard_normal((12, 5)).astype(np.float32)
    ids = rng.integers(0, 1000, (6,)).astype(np.int32)
    ref = {"w1": w1, "nested": {"zeta": w2, "alpha": ids},
           "bf16": np.asarray(jnp.asarray(bf, jnp.bfloat16)),
           "scalar": np.float32(3.5), "odd": w1[:3]}
    port = {"w1": torch.as_tensor(w1), "odd": torch.as_tensor(w1[:3]),
            "nested": {"zeta": torch.as_tensor(w2),
                       "alpha": torch.as_tensor(ids)},
            "scalar": np.float32(3.5),
            "bf16": torch.as_tensor(bf).to(torch.bfloat16)}
    return ref, port


def _files(root):
    out = {}
    for step in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, step))):
            with open(os.path.join(root, step, name), "rb") as f:
                out[(step, name)] = f.read()
    return out


# -- pytree helpers ------------------------------------------------------------
Pair = collections.namedtuple("Pair", "b a")


@pytest.mark.parametrize("case", ["unsorted-dict", "nested", "ordered"])
def test_tree_flatten_order_matches_jax(case):
    tree = {
        "unsorted-dict": {"z": 1, "b": 2, "a": 3, "m": 4},
        "nested": {"w": [5, (6, None, {"y": 7, "x": 8})], "c": Pair(9, 10),
                   "a": None},
        "ordered": collections.OrderedDict([("z", 1), ("a", 2)]),
    }[case]
    leaves, treedef = ptree.tree_flatten(tree)
    want, _ = jax.tree.flatten(tree)
    assert leaves == want
    back = ptree.tree_unflatten(treedef, [x * 10 for x in leaves])
    assert back == jax.tree.map(lambda x: x * 10, tree)
    assert type(back) is type(tree)
    with pytest.raises(ValueError, match="leaves"):
        ptree.tree_unflatten(treedef, leaves[:-1])


def test_tree_bytes_and_count_match_reference():
    ref, port = _trees()
    assert ptree.tree_bytes(port) == rtree.tree_bytes(ref)
    assert ptree.tree_count(port) == rtree.tree_count(ref)
    assert ptree.tree_bytes(ref) == rtree.tree_bytes(ref)


# -- one host's device -----------------------------------------------------------
@pytest.mark.parametrize("nbytes", [1, 5 * 1024 * 1024 + 17, 512 * MiB,
                                    4 * 1024 * MiB])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_host_device_matches_reference(policy, nbytes):
    kw = POLICIES[policy]
    ref = rstore.ZnsHostDevice(0, **kw)
    dev = pstore.ZnsHostDevice(0, device="cpu", **kw)
    assert [dataclasses.asdict(e) for e in dev.plan(nbytes)] == \
        [dataclasses.asdict(e) for e in ref.plan(nbytes)]
    for got, want in zip(dev.payload_scan_args(nbytes),
                         ref.payload_scan_args(nbytes)):
        np.testing.assert_array_equal(got, want)
    t, n = dev.simulate_payload_write(nbytes)
    t_ref, n_ref = ref.simulate_payload_write(nbytes)
    assert n == n_ref
    np.testing.assert_allclose(t, t_ref, rtol=RTOL, atol=0)
    assert dev.manifest_write_us() == ref.manifest_write_us()


def test_reset_under_io_matches_reference():
    """examples/zns_checkpointing.py's R5 row: fill 4 GiB, reset the full
    zones under I/O."""
    shard = 4 * 1024 * MiB
    out = []
    for mod, kw in ((rstore, {}), (pstore, dict(device="cpu"))):
        dev = mod.ZnsHostDevice(0, **kw)
        entries = dev.plan(shard)
        dev.apply_writes(entries)
        full = [e.zone for e in entries if dev.zm.state(e.zone).name == "FULL"]
        dev.schedule_reset(full)
        assert dev.reset_backlog == full
        out.append((full, dev.run_gc(concurrent_io=True)))
    assert out[0][0] == out[1][0] and len(out[0][0]) > 0
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=RTOL)


def test_planner_bin_packs_and_avoids_finish():
    dev = pstore.ZnsHostDevice(0, ZNSDeviceSpec(**SMALL),
                               stripe_bytes=256 * 1024, device="cpu")
    cap = SMALL["zone_cap_bytes"]
    entries = dev.plan(int(2.5 * cap))
    assert [e.nbytes for e in entries] == [cap, cap, int(2.5 * cap) - 2 * cap]
    dev.apply_writes(entries)
    states = [dev.zm.state(e.zone).name for e in entries]
    assert states[:2] == ["FULL", "FULL"]
    assert dev.plan(cap)[0].zone == entries[2].zone     # R3: reuse partial


# -- the store ----------------------------------------------------------------
@pytest.mark.parametrize("n_hosts,stripe", [(4, 64 * 1024), (3, 1 * MiB),
                                            (1, 4 * 1024)])
def test_store_matches_reference(tmp_path, n_hosts, stripe):
    """Two saves, a restore of each, gc(keep_last=1) and latest_step:
    manifests, reports, files (so their sha256) and modeled seconds
    equal the reference's; restores are bit-exact, a bfloat16 leaf
    handed back as 2-byte words (``V2``) as the reference does."""
    rroot, proot = tmp_path / "ref", tmp_path / "port"
    ref = rstore.ZonedCheckpointStore(str(rroot), n_hosts,
                                      RSpec(**SMALL), stripe_bytes=stripe)
    port = pstore.ZonedCheckpointStore(str(proot), n_hosts,
                                       ZNSDeviceSpec(**SMALL),
                                       stripe_bytes=stripe, device="cpu")
    for step in (3, 7):
        rtree_, ptree_ = _trees(step)
        want = ref.save(step, rtree_, extra_meta={"step": step})
        got = port.save(step, ptree_, extra_meta={"step": step})
        assert json.loads(json.dumps(got["manifest"])) == \
            json.loads(json.dumps(want["manifest"]))
        np.testing.assert_allclose(got["wall_seconds"], want["wall_seconds"],
                                   rtol=RTOL)
        assert [dataclasses.asdict(r) for r in got["reports"]] == \
            [dataclasses.asdict(r) for r in want["reports"]]
        restored, manifest = port.restore(step, ptree_)
        want_r, _ = ref.restore(step, rtree_)
        assert manifest["step"] == step
        r_leaves = jax.tree.leaves(want_r)
        p_leaves = jax.tree.leaves(restored)
        assert len(r_leaves) == len(p_leaves) == 6
        for a, b in zip(p_leaves, r_leaves):
            assert a.dtype.str == np.asarray(b).dtype.str
            assert a.shape == b.shape and a.tobytes() == b.tobytes()
        bf = restored["bf16"]
        assert bf.dtype.kind == "V" and bf.dtype.itemsize == 2
        assert bf.tobytes() == ptree_["bf16"].view(torch.int16).numpy() \
            .tobytes()
    assert _files(proot) == _files(rroot)
    assert port.latest_step() == ref.latest_step() == 7
    np.testing.assert_allclose(port.gc(keep_last=1), ref.gc(keep_last=1),
                               rtol=RTOL)
    assert sorted(os.listdir(proot)) == sorted(os.listdir(rroot)) == \
        ["step_00000007"]


def test_store_takes_numpy_trees(tmp_path):
    """A tree of numpy arrays (the reference's form, ml_dtypes bfloat16
    included) writes the same files as the same tree of tensors."""
    ref_tree, port_tree = _trees(1)
    files = []
    for name, tree in (("np", ref_tree), ("torch", port_tree)):
        store = pstore.ZonedCheckpointStore(str(tmp_path / name), 2,
                                            ZNSDeviceSpec(**SMALL),
                                            device="cpu")
        store.save(1, tree)
        files.append(_files(tmp_path / name))
    assert files[0] == files[1]


@pytest.mark.parametrize("fault", ["checksum", "failed-host"])
def test_store_errors_match_reference(tmp_path, fault):
    msgs = []
    for name, mod, spec, tree, kw in (
            ("ref", rstore, RSpec(**SMALL), _trees()[0], {}),
            ("port", pstore, ZNSDeviceSpec(**SMALL), _trees()[1],
             dict(device="cpu"))):
        store = mod.ZonedCheckpointStore(str(tmp_path / name), 3, spec, **kw)
        store.save(5, tree)
        failed = ()
        if fault == "checksum":
            victim = tmp_path / name / "step_00000005" / "host_00001.npz"
            with open(victim, "r+b") as f:
                f.seek(100)
                f.write(b"\xde\xad")
        else:
            failed = (1,)
        with pytest.raises(IOError) as err:
            store.restore(5, tree, failed_hosts=failed)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ("checksum" if fault == "checksum" else "host 1") in msgs[1]


def test_atomic_commit_and_paper_policy(tmp_path):
    store = pstore.ZonedCheckpointStore(str(tmp_path), 2,
                                        ZNSDeviceSpec(**SMALL), device="cpu")
    store.save(1, _trees()[1])
    names = os.listdir(tmp_path)
    assert names == ["step_00000001"] and store.latest_step() == 1
    fast = pstore.ZnsHostDevice(0, device="cpu", **POLICIES["R2-1MiB-QD4"])
    slow = pstore.ZnsHostDevice(1, device="cpu",
                                **POLICIES["naive-4KiB-QD1"])
    assert fast.simulate_payload_write(512 * MiB)[0] < \
        slow.simulate_payload_write(512 * MiB)[0] / 3     # R2


def test_store_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = pstore.ZonedCheckpointStore(str(tmp_path), 1,
                                        ZNSDeviceSpec(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        store.save(1, _trees()[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pstore.ZnsHostDevice(0).simulate_payload_write(MiB)


# -- control-plane policies -------------------------------------------------------
def _detector(m):
    det = m.FailureDetector(3, lease_s=10.0)
    for h in range(3):
        det.heartbeat(h, now=0.0)
    out = [det.tick(5.0), det.tick(15.0)]
    det.heartbeat(1, now=16.0)
    out.append(det.tick(25.0))
    out.append(det.healthy_hosts())
    det.heartbeat(0, now=26.0)
    out.append((det.hosts[0].state, det.hosts[0].incarnation))
    return out


def _rejoin(m):
    det = m.FailureDetector(2, lease_s=1.0)
    det.heartbeat(0, now=0.0)
    det.heartbeat(1, now=0.0)
    out = [det.tick(10.0)]
    for t in (11.0, 12.0):
        det.heartbeat(0, now=t)
        out.append((det.hosts[0].state, det.hosts[0].incarnation))
    return out


def _suspect(m):
    det = m.FailureDetector(2, lease_s=5.0)
    det.heartbeat(0, now=0.0)
    det.heartbeat(1, now=0.0)
    return [det.tick(7.0), det.healthy_hosts()]


def _straggler(m):
    out = []
    pol = m.StragglerPolicy(factor=1.5, window=8)
    for d in (10.0, 11.0, 9.0):
        pol.observe(d)
    out += [pol.deadline(), pol.mitigate({0: 100.0})]
    for d in (10.0,) * 5:
        pol.observe(d)
    out += [pol.deadline(), pol.mitigate({0: 9.0, 1: 40.0, 2: 11.0,
                                          3: 16.0})]
    slide = m.StragglerPolicy(factor=2.0, window=4)
    for d in (100.0,) * 4 + (10.0,) * 4:
        slide.observe(d)
    sp = m.StragglerPolicy(factor=1.5)
    for d in (1.0, 1.1, 0.9, 1.0, 1.05):
        sp.observe(d)
    return out + [slide.deadline(), sp.mitigate({0: 1.0, 1: 5.0, 2: 1.1})]


def _restarts(m):
    a = m.RestartBudget(max_restarts=3, window_s=100.0)
    b = m.RestartBudget(max_restarts=1, window_s=10.0)
    c = m.RestartBudget(max_restarts=2, window_s=100)
    return ([a.allow(t) for t in (0.0, 1.0, 2.0, 3.0, 99.0, 101.5)],
            [b.allow(t) for t in (0.0, 1.0, 2.0, 3.0, 10.5)],
            [c.allow(t) for t in (0.0, 1.0, 2.0, 200.0)])


def _reshard(m):
    plans = [m.make_reshard_plan(range(8), (0, 1, 2, 5, 6, 7),
                                 model_parallel=4, chips_per_host=4),
             m.make_reshard_plan((3, 1, 0, 2), (0, 2, 3), model_parallel=4),
             m.make_reshard_plan((0, 1, 2, 3), (3, 2, 0), model_parallel=4),
             m.make_reshard_plan(list(range(8)), [0, 1, 2, 4, 5, 6, 7],
                                 model_parallel=4, chips_per_host=4)]
    for p in plans:
        m.validate_plan(p)
    return [dataclasses.asdict(p) for p in plans] + [
        m.largest_mesh(64, model_parallel=16),
        m.largest_mesh(66, model_parallel=16)]


def _reshard_errors(m):
    out = []
    plan = m.make_reshard_plan(range(4), range(4), model_parallel=4)
    bad = dict(plan.shard_ownership)
    bad[0] = bad[0] + [0]
    for call in (lambda: m.largest_mesh(15, model_parallel=16),
                 lambda: m.make_reshard_plan((0, 1), (), model_parallel=4),
                 lambda: m.make_reshard_plan([0, 1], [0], model_parallel=16,
                                             chips_per_host=4),
                 lambda: m.validate_plan(dataclasses.replace(
                     plan, shard_ownership=bad))):
        try:
            call()
            out.append(None)
        except (ValueError, AssertionError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def _plain(x):
    """Enums of either package as their values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return getattr(x, "value", x)


@pytest.mark.parametrize("scenario", [_detector, _rejoin, _suspect,
                                      _straggler, _restarts, _reshard,
                                      _reshard_errors],
                         ids=lambda f: f.__name__.strip("_"))
def test_policies_match_reference(scenario):
    ref = types.SimpleNamespace(**{**vars(rfail), **vars(relastic)})
    port = types.SimpleNamespace(**{**vars(pfail), **vars(pelastic)})
    assert _plain(scenario(port)) == _plain(scenario(ref))
