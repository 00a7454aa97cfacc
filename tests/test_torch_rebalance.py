"""Elastic rebalancing of the port's sharded service (DESIGN §4.4) against
the JAX package's, with tolerance 0:

* the router table, its slot views, the LPT re-pack and the ring permute
  (``distributed.sharding.rebalance_collect`` on a hand-made permutation at
  4 ranks);
* elastic routing at one rank is a tenant fleet: ``ShardedDedup`` with nb
  buckets equals ``FleetDedup`` over range buckets — the oracle the card
  holds its elastic cell against;
* at 4 gloo ranks the monitor fires on a range-skewed stream, lowers the
  load ratio, and rebalance-on == rebalance-off == one rank == the
  reference's verdicts;
* checkpoints: a JAX elastic checkpoint saved after a rebalance fired (the
  reference's ``CheckpointManager`` with ``router_meta``) resumes in the
  port at 4 ranks with the reference's continued verdicts, and again at 2
  ranks through ``migrate_sharded_state``; the router leaf survives the
  port's own checkpoint round trip;
* the pinned sharded digests of ``chip_smoke.py`` recomputed from the
  reference (and reproduced by the port at one rank), so the constants the
  card is held to cannot drift.

The reference runs once for the file, in a subprocess at 4 forced host
devices under JAX's partitionable threefry layout (``Auto``-axes meshes,
``tests/test_torch_sharded.py``).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import migrate_sharded_state as jmigrate
from repro.core import DedupConfig as JConfig
from repro.data.streams import zipf_range_stream
from repro.dedup import ShardedDedup as JSharded
from repro.dedup import ShardedDedupConfig as JShardedConfig
from repro_torch.checkpoint import (CheckpointManager, layout_meta,
                                    migrate_sharded_state, router_meta)
from repro_torch.convert import state_to_numpy
from repro_torch.core import DedupConfig, init_router
from repro_torch.core.fleet import FleetDedup
from repro_torch.core.hashing import range_bucket
from repro_torch.dedup import DedupPipeline, ShardedDedup, ShardedDedupConfig
from repro_torch.distributed import ring_schedule

from test_torch_sharded import (auto_mesh, digest, jax_leaves, run_ranks,
                                run_reference)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the pinned digests and their inputs)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A gloo process group of world size 1 for this module."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def assert_same_leaves(a: dict, b: dict):
    assert set(a) == set(b)
    for leaf in a:
        np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=leaf)


# ----------------------------------------------------------- unit pieces //
def test_router_block_init_and_slot_tables():
    router = init_router(8, 4, "cpu")
    assert router.assign.tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert router.assign.dtype == torch.int32
    assert int(router.n_rebalances) == 0
    slot_of, slots = ShardedDedup._slot_tables(router.assign, 4, 2)
    assert slot_of.tolist() == [0, 1, 0, 1, 0, 1, 0, 1]
    assert slots.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="divide"):
        init_router(6, 4, "cpu")
    assert ring_schedule(3) == [(0, 1), (1, 2), (2, 0)]


@pytest.mark.parametrize("seed", range(4))
def test_slot_tables_and_lpt_equal_reference(seed):
    """The LPT re-pack (stable descending order, lowest-index ties — the
    loads here hold many ties) and the slot views of its table equal the
    reference's, and keep exactly b_r buckets per shard."""
    n_shards, b_r = 4, 4
    rng = np.random.default_rng(seed)
    loads = rng.zipf(1.3, n_shards * b_r).clip(max=50).astype(np.int32)
    want = np.asarray(JSharded._lpt_assign(jnp.asarray(loads), n_shards,
                                           b_r))
    got = ShardedDedup._lpt_assign(torch.from_numpy(loads), n_shards, b_r)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.bincount(want, minlength=n_shards).tolist() == [b_r] * 4
    for a, b in zip(ShardedDedup._slot_tables(got, n_shards, b_r),
                    JSharded._slot_tables(jnp.asarray(want), n_shards, b_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("variant,kw", [
    ("rlbsbf", {}), ("rlbsbf", {"packed": True}), ("bsbf", {"packed": True}),
    ("sbf", {"layout": "planes"})])
def test_elastic_one_rank_is_a_range_bucket_fleet(group, variant, kw):
    """nb buckets at one rank step exactly as a fleet of nb tenants of
    memory / nb each with capacity ``bucket_capacity`` over tenant =
    ``range_bucket(key, nb)``: verdicts, overflow, bits, load, position
    and rng. The elastic card cell's oracle; its monitor runs and never
    fires (one shard)."""
    nb, b = 16, 256
    cfg = DedupConfig.for_variant(variant, memory_bits=1 << 16, batch_size=b,
                                  rebalance_buckets=nb,
                                  rebalance_threshold=1.25, **kw)
    keys, _ = zipf_range_stream(1 << 13, universe=1 << 12, a=1.2, seed=5)
    sd = ShardedDedup(ShardedDedupConfig(base=cfg), device="cpu",
                      partitionable=_layout())
    st, dup, ovf = sd.run_stream(sd.init(), keys)
    fcfg = dataclasses.replace(cfg, memory_bits=cfg.memory_bits // nb,
                               n_tenants=nb, rebalance_buckets=0,
                               rebalance_threshold=0.0)
    fleet = FleetDedup(fcfg, capacity=sd.scfg.bucket_capacity(b, 1),
                       device="cpu", partitionable=_layout())
    tenant = range_bucket(torch.from_numpy(keys.view(np.int32)), nb)
    fst, fdup, fovf = fleet.run_stream(fleet.init(), keys, tenant)
    assert int(ovf.sum()) > 0              # the skew overflows some buckets
    assert torch.equal(dup, fdup)
    assert torch.equal(ovf[:, 0], fovf)
    assert int(st.router.n_rebalances) == 0
    got = state_to_numpy(sd.gather_state(st))
    want = state_to_numpy(fst)
    for leaf in want:
        np.testing.assert_array_equal(got[leaf][0], want[leaf],
                                      err_msg=leaf)


def test_router_leaf_survives_state_dict_roundtrip(tmp_path):
    """The port of tests/test_pipeline_serving.py's test: the router table
    rides ``state_dict`` and the checkpoint round trip as
    ``.router/.assign`` and ``.router/.n_rebalances``, bit for bit — a
    restored router reproduces the exact table and count, not the
    canonical one."""
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 16,
                                  batch_size=1024)
    pipe = DedupPipeline(cfg, mode="flag", device="cpu")
    pipe.process({"key": np.arange(1024, dtype=np.uint32)})
    router = init_router(16, 4, "cpu")
    assign = router.assign.clone()
    assign[3] = 2
    router = router._replace(assign=assign,
                             n_rebalances=torch.tensor(5, dtype=torch.int32))
    pipe.state = pipe.state._replace(router=router)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, pipe.state_dict())
    assert {"filter_state/.router/.assign",
            "filter_state/.router/.n_rebalances"} <= set(
                mgr.load_meta(1)["keys"])

    pipe_b = DedupPipeline(cfg, mode="flag", device="cpu")
    pipe_b.state = pipe_b.state._replace(router=init_router(16, 4, "cpu"))
    pipe_b.load_state_dict(mgr.restore(1, pipe_b.state_dict()))
    r = pipe_b.state.router
    assert torch.equal(r.assign, router.assign)
    assert int(r.n_rebalances) == 5
    assert torch.equal(pipe_b.state.bits, pipe.state.bits)


def _elastic_swbf(pipe=True):
    cfg = DedupConfig.for_variant(
        "swbf", window=3, memory_bits=1 << 13, batch_size=256,
        rebalance_buckets=8, rebalance_threshold=1.5)
    return ShardedDedup(ShardedDedupConfig(base=cfg, capacity_factor=8.0,
                                           pipeline=pipe), device="cpu")


def test_migrate_sharded_state_across_shard_counts(group):
    """1 shard -> 4 -> 1 round-trips every bucket leaf bit for bit, the
    re-meshed layout is the canonical block assignment, and the migration
    equals the reference's on the same state; refusals as the
    reference's."""
    sd = _elastic_swbf()
    keys = (np.random.default_rng(5).integers(0, 1 << 32, 1024,
                                              dtype=np.uint64)
            .astype(np.uint32))
    state = sd.gather_state(sd.run_stream(sd.init(), keys)[0])
    wide = migrate_sharded_state(state, 4)
    assert wide.position.shape == (4, 2)
    assert wide.router.assign.tolist() == (np.arange(8) // 2).tolist()
    back = migrate_sharded_state(wide, 1)
    assert_same_leaves(state_to_numpy(state), state_to_numpy(back))
    with pytest.raises(ValueError, match="divisible"):
        migrate_sharded_state(state, 3)
    with pytest.raises(ValueError, match="elastic"):
        migrate_sharded_state(state._replace(router=None), 2)
    # the reference's migration of the same leaves (a permuted table too)
    perm = state._replace(router=state.router._replace(
        assign=torch.zeros(8, dtype=torch.int32)))
    jcfg = JConfig.for_variant("swbf", window=3, memory_bits=1 << 13,
                               batch_size=256, rebalance_buckets=8,
                               rebalance_threshold=1.5)
    jsd = JSharded(JShardedConfig(base=jcfg, capacity_factor=8.0),
                   auto_mesh())
    jstate = jsd.run_stream(jsd.init(), jnp.asarray(keys))[0]
    assert_same_leaves(jax_leaves(jstate), state_to_numpy(perm))
    assert_same_leaves(jax_leaves(jmigrate(jstate, 4)),
                       state_to_numpy(migrate_sharded_state(perm, 4)))


def test_router_meta_is_json_stampable(group, tmp_path):
    cfg = DedupConfig.for_variant(
        "rlbsbf", memory_bits=1 << 13, batch_size=256, rebalance_buckets=4,
        rebalance_threshold=1.5)
    sd = ShardedDedup(ShardedDedupConfig(base=cfg, capacity_factor=4.0),
                      device="cpu")
    state, _, _ = sd.run_stream(
        sd.init(), np.arange(512, dtype=np.uint32) * 0x01000193)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"filter": state},
             extra_meta={**layout_meta(cfg), **router_meta(state)})
    meta = mgr.load_meta(7)
    assert meta["router_buckets"] == 4
    assert meta["router_assign"] == state.router.assign.tolist()
    assert isinstance(meta["router_n_rebalances"], int)
    assert router_meta(state._replace(router=None)) == {}


# ------------------------------------------------- the reference, 4 devs //
# rebalance parity: tests/test_rebalance.py's worker at 4 devices
REBALANCE = dict(variant="rlbsbf", memory_bits=1 << 17, batch_size=1024,
                 rebalance_buckets=16)
REBALANCE_FACTOR = 16.0
# checkpoint resume: tests/test_rebalance.py's mid-stream worker
CKPT = dict(variant="swbf", window=3, memory_bits=1 << 14, batch_size=512,
            rebalance_buckets=8, rebalance_threshold=1.3)
CKPT_FACTOR, CKPT_AT = 8.0, 4096

_INPUTS = """
import hashlib, json, os, sys
import numpy as np
sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import chip_smoke
from test_torch_rebalance import (REBALANCE, REBALANCE_FACTOR, CKPT,
                                  CKPT_FACTOR, CKPT_AT)
tmp = sys.argv[1]
rkeys = np.load(os.path.join(tmp, "rkeys.npy"))
ckeys = np.load(os.path.join(tmp, "ckeys.npy"))

def digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()

def load_ratio(load):
    per = np.asarray(load).reshape(load.shape[0], -1).sum(axis=1)
    return float(per.max() / max(per.mean(), 1e-9))
"""

REFERENCE_WORKER = _INPUTS + """
import jax, jax.numpy as jnp
from repro.checkpoint import CheckpointManager, layout_meta, router_meta
from repro.core import DedupConfig
from repro.dedup import ShardedDedup, ShardedDedupConfig
from test_torch_sharded import auto_mesh

out = {}
for tag, thr, n in (("on", 1.25, 4), ("off", 0.0, 4), ("one", 1.25, 1)):
    kw = dict(REBALANCE)
    cfg = DedupConfig.for_variant(kw.pop("variant"), rebalance_threshold=thr,
                                  **kw)
    sd = ShardedDedup(ShardedDedupConfig(
        base=cfg, capacity_factor=REBALANCE_FACTOR), auto_mesh(n))
    st, dup, ovf = sd.run_stream(sd.init(), jnp.asarray(rkeys))
    out[tag] = {"dup": digest(np.asarray(dup)),
                "overflow": int(np.asarray(ovf).sum()),
                "n_rebalances": int(np.asarray(st.router.n_rebalances)),
                "ratio": load_ratio(st.load)}

kw = dict(CKPT)
cfg = DedupConfig.for_variant(kw.pop("variant"), **kw)
sd = ShardedDedup(ShardedDedupConfig(base=cfg, capacity_factor=CKPT_FACTOR),
                  auto_mesh(4))
mid, dup_a, _ = sd.run_stream(sd.init(), jnp.asarray(ckeys[:CKPT_AT]))
mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
mgr.save(1, {"filter": mid}, extra_meta={**layout_meta(cfg),
                                         **router_meta(mid)})
out["ckpt"] = {"n_rebalances": int(np.asarray(mid.router.n_rebalances)),
               "assign": np.asarray(mid.router.assign).tolist()}
_, dup_b, _ = sd.run_stream(mid, jnp.asarray(ckeys[CKPT_AT:]))   # donates
out["ckpt"]["resumed"] = digest(np.asarray(dup_b))

out["digests"] = {}
for name, case in chip_smoke.SHARD_DIGEST_CASES.items():
    cfg = DedupConfig.for_variant(case["variant"], **case["kw"])
    sd = ShardedDedup(ShardedDedupConfig(base=cfg,
                                         capacity_factor=case["factor"]),
                      auto_mesh(case["devices"]))
    keys, tens = chip_smoke.shard_digest_inputs(case)
    st = sd.init(cfg.seed)
    if tens is None:
        st, dup, ovf = sd.run_stream(st, jnp.asarray(keys))
    else:
        st, dup, ovf = sd.run_tenant_stream(st, jnp.asarray(keys),
                                            jnp.asarray(tens))
    out["digests"][name] = [digest(np.asarray(dup)),
                            int(np.asarray(ovf).sum())]
print(json.dumps(out))
"""

PORT_WORKER = _INPUTS + """
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.checkpoint import CheckpointManager, migrate_sharded_state
from repro_torch.core import DedupConfig
from repro_torch.dedup import ShardedDedup, ShardedDedupConfig
from repro_torch.distributed import rebalance_collect

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world)
out = {}
if world == 4:
    # the ring permute on a hand-made permutation: 8 buckets, 2 per rank,
    # each slot's payload its bucket id times 10
    ids = torch.tensor([2 * rank, 2 * rank + 1], dtype=torch.int32)
    perm = [5, 0, 7, 2, 1, 6, 3, 4]              # slot i of rank j <- perm
    want = torch.tensor(perm[2 * rank:2 * rank + 2], dtype=torch.int32)
    got = rebalance_collect((ids * 10, ids[:, None].repeat(1, 3)), ids,
                            want, None, world)
    ok = (got[0].tolist() == (want * 10).tolist()
          and got[1].tolist() == want[:, None].repeat(1, 3).tolist())
    flags = torch.tensor([int(ok)], dtype=torch.int32)
    dist.all_reduce(flags)
    out["collect_ok"] = int(flags) == world

    for tag, thr in (("on", 1.25), ("off", 0.0)):
        kw = dict(REBALANCE)
        cfg = DedupConfig.for_variant(kw.pop("variant"),
                                      rebalance_threshold=thr, **kw)
        sd = ShardedDedup(ShardedDedupConfig(
            base=cfg, capacity_factor=REBALANCE_FACTOR), device="cpu")
        st, dup, ovf = sd.run_stream(sd.init(), rkeys)
        g = sd.gather_state(st)
        out[tag] = {"dup": digest(dup.numpy()),
                    "overflow": int(ovf.sum()),
                    "n_rebalances": int(g.router.n_rebalances),
                    "ratio": load_ratio(g.load.numpy()),
                    "assign_counts": np.bincount(
                        g.router.assign.numpy(), minlength=world).tolist()}

kw = dict(CKPT)
cfg = DedupConfig.for_variant(kw.pop("variant"), **kw)
sd = ShardedDedup(ShardedDedupConfig(base=cfg, capacity_factor=CKPT_FACTOR),
                  device="cpu")
mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
out["meta_assign"] = mgr.load_meta(1)["router_assign"]
# the restore takes the file's shapes: the 4-shard global state, which a
# 2-rank group re-meshes before each rank takes its slab
restored = mgr.restore(1, {"filter": sd.gather_state(sd.init())})["filter"]
out["restored_assign"] = restored.router.assign.tolist()
if world != 4:
    restored = migrate_sharded_state(restored, world)
st, dup, _ = sd.run_stream(sd.local_state(restored), ckeys[CKPT_AT:])
out["resumed"] = digest(dup.numpy())
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference once (4 forced devices), then the port at 4 and at 2
    gloo ranks, over the same files."""
    tmp = tmp_path_factory.mktemp("rebalance")
    rkeys, _ = zipf_range_stream(1 << 14, universe=1 << 13, a=1.2, seed=7)
    ckeys, _ = zipf_range_stream(6144, universe=1 << 12, a=1.2, seed=3)
    np.save(tmp / "rkeys.npy", rkeys.astype(np.uint32))
    np.save(tmp / "ckeys.npy", ckeys.astype(np.uint32))
    ref = run_reference(REFERENCE_WORKER, tmp)
    return tmp, ref, run_ranks(PORT_WORKER, tmp, 4), run_ranks(PORT_WORKER,
                                                                tmp, 2)


def test_rebalance_fires_lowers_skew_and_keeps_verdicts(runs):
    """4 ranks, range-skewed zipf stream: the monitor fires, the max/mean
    per-shard load ratio ends below rebalance-off's, every rank still
    holds b_r buckets, and the verdicts are bit-identical — on == off ==
    the reference's on, off and one-device runs (placement, not math)."""
    _, ref, port, _ = runs
    on, off = port["on"], port["off"]
    assert on["overflow"] == off["overflow"] == 0
    assert on["n_rebalances"] >= 1 and off["n_rebalances"] == 0
    assert on["ratio"] < off["ratio"]
    assert on["assign_counts"] == [4] * 4
    assert on["dup"] == off["dup"] == ref["one"]["dup"]
    for tag in ("on", "off"):
        assert {k: port[tag][k] for k in ref[tag]} == ref[tag]


def test_one_rank_equals_the_reference_rebalance_runs(group, runs):
    """The same stream at one rank (its monitor on, never firing) gives the
    same verdicts."""
    tmp, ref, _, _ = runs
    kw = dict(REBALANCE)
    cfg = DedupConfig.for_variant(kw.pop("variant"), rebalance_threshold=1.25,
                                  **kw)
    sd = ShardedDedup(ShardedDedupConfig(base=cfg,
                                         capacity_factor=REBALANCE_FACTOR),
                      device="cpu", partitionable=True)
    st, dup, ovf = sd.run_stream(sd.init(), np.load(tmp / "rkeys.npy"))
    assert int(ovf.sum()) == 0 and int(st.router.n_rebalances) == 0
    assert digest(dup.numpy()) == ref["one"]["dup"] == ref["on"]["dup"]


def test_rebalance_collect_on_a_hand_made_permutation(runs):
    assert runs[2]["collect_ok"]


@pytest.mark.parametrize("world", (4, 2))
def test_jax_checkpoint_after_a_rebalance_resumes_in_the_port(runs, world):
    """A reference checkpoint saved after a rebalance fired (``router_meta``
    stamped) restores into the port's gathered ``init()`` template with its
    permuted table, and every rank's slab continues with the reference's
    verdicts — at 4 ranks as saved, and at 2 through
    ``migrate_sharded_state``."""
    _, ref, port4, port2 = runs
    port = port4 if world == 4 else port2
    assert ref["ckpt"]["n_rebalances"] >= 1
    assert port["meta_assign"] == port["restored_assign"] == \
        ref["ckpt"]["assign"]
    assert port["resumed"] == ref["ckpt"]["resumed"]


@pytest.mark.parametrize("name", sorted(chip_smoke.SHARD_DIGEST_CASES))
def test_pinned_shard_digests_recomputed_from_the_reference(runs, name):
    """chip_smoke.py's constants are the reference's verdicts."""
    assert runs[1]["digests"][name] == [chip_smoke.SHARD_DIGESTS[name], 0]


@pytest.mark.parametrize("name", sorted(chip_smoke.SHARD_DIGEST_CASES))
def test_port_reproduces_pinned_shard_digests_at_one_rank(group, name):
    """What the card's shard phase checks, here on the CPU: one rank
    reproduces every pinned digest, the 2- and 4-device ones included
    (elastic verdicts do not depend on the device count)."""
    case = chip_smoke.SHARD_DIGEST_CASES[name]
    assert chip_smoke.shard_digest(case, "cpu") == (
        chip_smoke.SHARD_DIGESTS[name], 0)
