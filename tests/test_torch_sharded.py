"""The port's sharded dedup service against the JAX package's (DESIGN §4,
§4.5, §4.6): ``repro_torch.dedup.ShardedDedup`` over ``torch.distributed``
(gloo on the CPU) equals ``repro.dedup.ShardedDedup`` bit for bit —
verdicts, overflow and the gathered state — with tolerance 0.

* One rank, in this process: a gloo group of world size 1 over a
  ``FileStore`` in a temporary directory (no TCP port, so xdist workers
  cannot collide), against the reference on a 1x1 mesh. jax >= 0.5's
  ``jax.make_mesh`` defaults to ``Explicit`` axes, under which the
  reference's sharded reshapes refuse to trace; the mesh here asks for
  ``Auto`` axes when ``jax.sharding.AxisType`` exists.
* 2 and 4 ranks: gloo ranks spawned as processes of their own, against the
  reference in one subprocess at 4 forced host devices (meshes of 2 and 4
  of them), both under JAX's partitionable threefry layout.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import DedupConfig as JConfig
from repro.data.streams import zipf_range_stream
from repro.dedup import ShardedDedup as JSharded
from repro.dedup import ShardedDedupConfig as JShardedConfig
from repro_torch.convert import state_to_numpy
from repro_torch.core import DedupConfig
from repro_torch.dedup import ShardedDedup, ShardedDedupConfig, StreamMetrics
from repro_torch.dedup.metrics import truth_from_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def auto_mesh(n=1, devices=None):
    """An (n, 1) ("data", "model") mesh with Auto axes where jax has them."""
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    devs = np.array((devices or jax.devices())[:n]).reshape(n, 1)
    return jax.sharding.Mesh(devs, ("data", "model"), **kw)


def jax_leaves(state) -> dict:
    """The reference state's leaves under ``convert.state_to_numpy``'s
    names."""
    try:
        rng = np.asarray(jax.random.key_data(state.rng))
    except TypeError:
        rng = np.asarray(state.rng)
    out = {"bits": np.asarray(state.bits),
           "position": np.asarray(state.position),
           "load": np.asarray(state.load), "rng": rng}
    if state.ring is not None:
        out["ring_events"] = np.asarray(state.ring.events)
        out["ring_slot"] = np.asarray(state.ring.slot)
    if state.router is not None:
        out["router_assign"] = np.asarray(state.router.assign)
        out["router_n_rebalances"] = np.asarray(state.router.n_rebalances)
    return out


def digest(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


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


# --------------------------------------------------- one rank, in process //
SIZES = dict(memory_bits=1 << 15, batch_size=512)
ONE_RANK = {
    "rlbsbf-dense8": ("rlbsbf", {}),
    "rlbsbf-planes": ("rlbsbf", {"packed": True}),
    "sbf-dense8": ("sbf", {}),
    "sbf-planes": ("sbf", {"layout": "planes"}),
    "swbf": ("swbf", {"window": 3, "packed": True}),
    "cms": ("cms", {"count_threshold": 2, "packed": True}),
    "rsbf-elastic8": ("rsbf", {"rebalance_buckets": 8,
                               "rebalance_threshold": 1.5}),
}
ONE_RANK_KEYS = (np.random.default_rng(0).integers(0, 3000, 5000)
                 .astype(np.uint32))            # 5000 % 512: a ragged tail


def _factor(kw):
    return 8.0 if kw.get("rebalance_buckets") else 2.0


@pytest.fixture(scope="module")
def ref_one_rank():
    """The reference on a 1x1 Auto mesh, every one-rank case in both
    pipeline modes, run once for the module."""
    out = {}
    for name, (variant, kw) in ONE_RANK.items():
        cfg = JConfig.for_variant(variant, **SIZES, **kw)
        for pipe in (True, False):
            sd = JSharded(JShardedConfig(base=cfg, pipeline=pipe,
                                         capacity_factor=_factor(kw)),
                          auto_mesh())
            st, dup, ovf = sd.run_stream(sd.init(),
                                         jnp.asarray(ONE_RANK_KEYS))
            out[name, pipe] = (np.asarray(dup), np.asarray(ovf),
                               jax_leaves(st))
    return out


def _port(variant, kw, pipe=True, factor=None, **cfg_kw):
    cfg = DedupConfig.for_variant(variant, **{**SIZES, **cfg_kw}, **kw)
    return ShardedDedup(
        ShardedDedupConfig(base=cfg, pipeline=pipe,
                           capacity_factor=factor or _factor(kw)),
        device="cpu", partitionable=_layout())


@pytest.mark.parametrize("pipe", (True, False), ids=("pipelined", "serial"))
@pytest.mark.parametrize("name", sorted(ONE_RANK))
def test_one_rank_equals_reference(group, ref_one_rank, name, pipe):
    variant, kw = ONE_RANK[name]
    sd = _port(variant, kw, pipe)
    st, dup, ovf = sd.run_stream(sd.init(), ONE_RANK_KEYS)
    jdup, jovf, jl = ref_one_rank[name, pipe]
    np.testing.assert_array_equal(dup.numpy(), jdup)
    np.testing.assert_array_equal(ovf.numpy(), jovf)
    tl = state_to_numpy(sd.gather_state(st))
    assert set(tl) == set(jl)
    for leaf in jl:
        np.testing.assert_array_equal(tl[leaf], jl[leaf], err_msg=leaf)


@pytest.mark.parametrize("name", ("rlbsbf-planes", "swbf", "rsbf-elastic8"))
@pytest.mark.parametrize("pipe", (True, False), ids=("pipelined", "serial"))
def test_make_step_equals_run_stream(group, name, pipe):
    """Per-batch ``make_step`` on the whole batches equals ``run_stream``
    bit for bit, and leaves the caller's state as it was."""
    variant, kw = ONE_RANK[name]
    sd = _port(variant, kw, pipe)
    n_whole = (len(ONE_RANK_KEYS) // 512) * 512
    _, dup, _ = sd.run_stream(sd.init(), ONE_RANK_KEYS[:n_whole])
    step = sd.make_step(512)
    st = sd.init()
    before = st.bits.clone()
    nxt, d0, o0 = step(st, ONE_RANK_KEYS[:512])
    assert torch.equal(st.bits, before)
    per = [d0]
    for i in range(1, n_whole // 512):
        nxt, d, o = step(nxt, ONE_RANK_KEYS[i * 512:(i + 1) * 512])
        assert o.shape == (1,)
        per.append(d)
    assert torch.equal(torch.cat(per), dup)


def test_ragged_tail_masked_and_cached_once(group):
    """5000 keys at B = 512: the invalid tail lanes are never routed, never
    inserted and never counted; a second stream of the same length adds no
    stream shape."""
    sd = _port("rlbsbf", {"packed": True})
    st, dup, ovf = sd.run_stream(sd.init(), ONE_RANK_KEYS)
    assert dup.shape == (5000,)
    assert ovf.shape == (10, 1) and int(ovf.sum()) == 0
    assert int(st.position.sum()) - 1 == 5000
    sd.run_stream(sd.init(), ONE_RANK_KEYS)
    assert sd.stream_cache_size() == 1


def test_overflow_accumulates_into_metrics(group):
    """capacity_factor 0.5 keeps max(8, 256 · 0.5) = 128 of each 256-key
    batch: exactly 2048 - 8 · 128 overflow, read through StreamMetrics;
    overflowed keys are reported distinct."""
    keys = (np.random.default_rng(2).integers(0, 10_000, 2048)
            .astype(np.uint32))
    sd = _port("rlbsbf", {}, factor=0.5, memory_bits=1 << 14,
               batch_size=256)
    st, dup, ovf = sd.run_stream(sd.init(), keys)
    m = StreamMetrics()
    m.update(dup, truth_from_stream(keys), overflow=ovf)
    assert m.summary()["overflow"] == int(ovf.sum()) == 2048 - 8 * 128
    assert int(st.position.sum()) - 1 == 8 * 128


def test_run_tenant_stream_refuses_without_bucket_per_tenant(group):
    cfg = DedupConfig(variant="bsbf", memory_bits=8192, k=4, batch_size=64,
                      n_tenants=4, rebalance_buckets=8)
    sd = ShardedDedup(ShardedDedupConfig(base=cfg), device="cpu")
    with pytest.raises(ValueError, match="one bucket per tenant"):
        sd.run_tenant_stream(sd.init(0), np.zeros(64, np.uint32),
                             np.zeros(64, np.int32))


def test_gather_and_local_state_round_trip(group):
    sd = _port("swbf", {"window": 3, "packed": True, "rebalance_buckets": 8,
                        "rebalance_threshold": 1.5})
    st, _, _ = sd.run_stream(sd.init(), ONE_RANK_KEYS)
    back = sd.local_state(sd.gather_state(st))
    a, b = state_to_numpy(st), state_to_numpy(back)
    assert set(a) == set(b)
    for leaf in a:
        np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=leaf)


def test_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="process group"):
        ShardedDedup(ShardedDedupConfig(base=DedupConfig()), device="cpu")


# ------------------------------------------------------ 2 and 4 ranks //
# (name, world, variant, DedupConfig kwargs, capacity_factor, pipeline,
#  tenants): the reference runs each on a mesh of ``world`` devices
MULTI = [
    ("rlbsbf-static-dense8-2", 2, "rlbsbf", {}, 2.0, True, False),
    ("rlbsbf-static-dense8-4", 4, "rlbsbf", {}, 2.0, True, False),
    ("rlbsbf-static-flat-4-pipelined", 4, "rlbsbf", {"packed": True}, 2.0,
     True, False),
    ("rlbsbf-static-flat-4-serial", 4, "rlbsbf", {"packed": True}, 2.0,
     False, False),
    ("swbf-static-compacted-4-pipelined", 4, "swbf",
     {"window": 3, "packed": True}, 2.0, True, False),
    ("swbf-static-compacted-4-serial", 4, "swbf",
     {"window": 3, "packed": True}, 2.0, False, False),
    ("swbf-elastic-4-pipelined", 4, "swbf",
     {"window": 3, "packed": True, "rebalance_buckets": 8,
      "rebalance_threshold": 1.3}, 8.0, True, False),
    ("swbf-elastic-4-serial", 4, "swbf",
     {"window": 3, "packed": True, "rebalance_buckets": 8,
      "rebalance_threshold": 1.3}, 8.0, False, False),
    ("sbf-tenants-planes-2", 2, "sbf",
     {"layout": "planes", "k": 4, "batch_size": 64, "n_tenants": 8,
      "rebalance_buckets": 8, "seed": 11}, 64.0, True, True),
]
MULTI_SIZES = dict(memory_bits=1 << 15, batch_size=512)


def multi_inputs(tmp):
    """The zipf stream of tests/test_distributed.py's pipelined test and
    the tenant stream of tests/test_tenants.py's sharded fleet, in files."""
    keys, _ = zipf_range_stream(4096, universe=1 << 11, a=1.2, seed=7)
    rng = np.random.default_rng(11)
    tkeys = rng.integers(0, 1 << 20, 512).astype(np.uint32)
    tens = rng.integers(0, 8, 512).astype(np.int32)
    tkeys[256:], tens[256:] = tkeys[:256], tens[:256]
    np.save(tmp / "keys.npy", keys.astype(np.uint32))
    np.save(tmp / "tkeys.npy", tkeys)
    np.save(tmp / "tens.npy", tens)
    cases = [dict(name=n, world=w, variant=v, kw={**MULTI_SIZES, **kw},
                  factor=f, pipeline=p, tenants=t)
             for n, w, v, kw, f, p, t in MULTI]
    (tmp / "cases.json").write_text(json.dumps(cases))
    return tmp


_COMMON = """
import hashlib, json, os, sys
import numpy as np

def leaves_digest(leaves):
    h = hashlib.sha256()
    for k in sorted(leaves):
        a = np.ascontiguousarray(leaves[k])
        h.update(f"{k}{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()

def digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()

tmp = sys.argv[1]
cases = json.load(open(os.path.join(tmp, "cases.json")))
keys = np.load(os.path.join(tmp, "keys.npy"))
tkeys = np.load(os.path.join(tmp, "tkeys.npy"))
tens = np.load(os.path.join(tmp, "tens.npy"))
"""

REFERENCE_WORKER = _COMMON + """
import jax, jax.numpy as jnp
from repro.core import DedupConfig
from repro.dedup import ShardedDedup, ShardedDedupConfig
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_sharded import auto_mesh, jax_leaves

out = {}
for c in cases:
    cfg = DedupConfig.for_variant(c["variant"], **c["kw"])
    sd = ShardedDedup(ShardedDedupConfig(base=cfg, pipeline=c["pipeline"],
                                         capacity_factor=c["factor"]),
                      auto_mesh(c["world"]))
    st = sd.init(cfg.seed)
    if c["tenants"]:
        st, dup, ovf = sd.run_tenant_stream(st, jnp.asarray(tkeys),
                                            jnp.asarray(tens))
    else:
        st, dup, ovf = sd.run_stream(st, jnp.asarray(keys))
    out[c["name"]] = {"dup": digest(np.asarray(dup)),
                      "n_dup": int(np.asarray(dup).sum()),
                      "ovf": np.asarray(ovf).tolist(),
                      "state": leaves_digest(jax_leaves(st))}
print(json.dumps(out))
"""

PORT_WORKER = _COMMON + """
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.convert import state_to_numpy
from repro_torch.core import DedupConfig
from repro_torch.dedup import ShardedDedup, ShardedDedupConfig

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world)
out = {}
for c in cases:
    if c["world"] != world:
        continue
    cfg = DedupConfig.for_variant(c["variant"], **c["kw"])
    sd = ShardedDedup(ShardedDedupConfig(base=cfg, pipeline=c["pipeline"],
                                         capacity_factor=c["factor"]),
                      device="cpu")
    st = sd.init(cfg.seed)
    if c["tenants"]:
        st, dup, ovf = sd.run_tenant_stream(st, tkeys, tens)
    else:
        st, dup, ovf = sd.run_stream(st, keys)
    leaves = state_to_numpy(sd.gather_state(st))
    out[c["name"]] = {"dup": digest(dup.numpy()),
                      "n_dup": int(dup.sum()), "ovf": ovf.tolist(),
                      "state": leaves_digest(leaves)}
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def start_reference(code: str, tmp, devices: int = 4):
    """``code`` started in a subprocess with ``devices`` forced host devices
    and JAX's partitionable threefry layout; ``finish`` reads it."""
    env = {**os.environ, "PYTHONPATH": "src",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "JAX_PLATFORMS": "cpu", "JAX_THREEFRY_PARTITIONABLE": "1"}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)


def finish(proc) -> dict:
    """A started subprocess's last output line as JSON, once it ended
    well."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def run_reference(code: str, tmp, devices: int = 4) -> dict:
    return finish(start_reference(code, tmp, devices))


def run_ranks(code: str, tmp, world: int) -> dict:
    """``code`` as ``world`` gloo ranks, each a process of its own meeting
    at a FileStore in ``tmp``; rank 0's last output line as JSON."""
    store = tmp / f"store-{world}-{os.urandom(4).hex()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "RANK": str(r),
             "WORLD": str(world), "STORE": str(store),
             "OMP_NUM_THREADS": "1"})
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """The reference's results (once for the module, in a subprocess that
    runs beside the port's) and the port's at 2 and 4 ranks."""
    tmp = multi_inputs(tmp_path_factory.mktemp("sharded"))
    ref = start_reference(REFERENCE_WORKER, tmp)    # beside the port's runs
    try:
        port = {**run_ranks(PORT_WORKER, tmp, 2),
                **run_ranks(PORT_WORKER, tmp, 4)}
    finally:
        ref = finish(ref)
    return ref, port


@pytest.mark.parametrize("name", [c[0] for c in MULTI])
def test_multi_rank_equals_reference(multi, name):
    ref, port = multi
    assert port[name] == ref[name]
    assert sum(ref[name]["ovf"], []) == [0] * len(sum(ref[name]["ovf"], []))


@pytest.mark.parametrize("stem", ("rlbsbf-static-flat-4",
                                  "swbf-static-compacted-4",
                                  "swbf-elastic-4"))
def test_pipelined_equals_serial(multi, stem):
    """DESIGN §4.5: pipelining changes the schedule, not the math — in the
    port at 4 ranks, for the flat, the compacted and the elastic path."""
    _, port = multi
    pipelined, serial = port[f"{stem}-pipelined"], port[f"{stem}-serial"]
    # the compacted path's swbf ring is as wide as its step, so the states
    # differ in shape there; the verdicts and overflow may not
    for what in ("dup", "n_dup", "ovf"):
        assert pipelined[what] == serial[what], what
