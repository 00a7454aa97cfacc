"""The sharded service's three card paths at a reduced depth, on one NCCL
rank (the card's ``chip_smoke.py`` phase "shard" runs them at 256 MB).
These tests import neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sharded_gpu.py

Without a CUDA device they skip; the sharded service itself is held
against the JAX package on the CPU by ``tests/test_torch_sharded.py`` and
``tests/test_torch_rebalance.py``."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import DedupConfig, u32
from repro_torch.core.fleet import FleetDedup
from repro_torch.core.hashing import range_bucket
from repro_torch.dedup import ShardedDedup, ShardedDedupConfig
from repro_torch.kernels.fused_template import bitset_step, counter_step
from repro_torch.kernels.hashmix import hashmix

COUNTERS = (hashmix, bitset_step, counter_step)
BATCH, N, BUCKETS = 1024, 1 << 14, 32


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """One NCCL rank on the card for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield torch.device("cuda")
    dist.destroy_process_group()


def keys_on(device):
    rng = np.random.default_rng(3)
    universe = rng.integers(0, 1 << 32, N // 2, dtype=np.uint64)
    return u32.as_words(universe[rng.integers(0, N // 2, N)]
                        .astype(np.uint32), device)


def run(sd, keys):
    """run_stream from init(), with the launches it made."""
    for c in COUNTERS:
        c.launches = 0
    st, dup, ovf = sd.run_stream(sd.init(), keys)
    torch.cuda.synchronize()
    return st, dup, ovf, {c.__name__: c.launches for c in COUNTERS}


def states_equal(a, b) -> bool:
    from repro_torch.distributed.sharding import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _cfg(variant, **kw):
    extra = {"layout": "planes"} if variant == "sbf" else {"packed": True}
    return DedupConfig.for_variant(variant, memory_bits=1 << 24,
                                   batch_size=BATCH, **extra, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,elastic", [("rlbsbf", False),
                                             ("sbf", True)])
def test_pipelined_equals_serial_on_card(nccl, variant, elastic):
    """Static rlbsbf (one bitset step per batch at the flat width) and
    elastic sbf over 32 buckets (one hashmix and one counter step per
    batch): pipelined equals serial in verdicts, overflow and state."""
    kw = ({"rebalance_buckets": BUCKETS, "rebalance_threshold": 1.25}
          if elastic else {})
    cfg = _cfg(variant, **kw)
    keys = keys_on(nccl)
    out = {}
    for pipe in (True, False):
        sd = ShardedDedup(ShardedDedupConfig(base=cfg, pipeline=pipe))
        st, dup, ovf, launches = run(sd, keys)
        out[pipe] = (sd.gather_state(st), dup, ovf, launches)
    (gp, dp, op, lp), (gs, ds, os_, ls) = out[True], out[False]
    assert torch.equal(dp, ds) and torch.equal(op, os_)
    assert states_equal(gp, gs)
    assert int(op.sum()) == 0
    n_steps = N // BATCH
    want = ({"hashmix": n_steps, "bitset_step": 0, "counter_step": n_steps}
            if variant == "sbf" else
            {"hashmix": 0, "bitset_step": n_steps, "counter_step": 0})
    assert lp == want and ls == want


@pytest.mark.gpu
def test_elastic_rlbsbf_equals_fleet_on_card(nccl):
    """32 buckets at one rank equal FleetDedup over range buckets, one
    bitset step per batch over the bucket axis."""
    cfg = _cfg("rlbsbf")
    ecfg = dataclasses.replace(cfg, rebalance_buckets=BUCKETS,
                               rebalance_threshold=1.25)
    keys = keys_on(nccl)
    sd = ShardedDedup(ShardedDedupConfig(base=ecfg))
    st, dup, ovf, launches = run(sd, keys)
    g = sd.gather_state(st)
    fleet = FleetDedup(dataclasses.replace(
        cfg, memory_bits=cfg.memory_bits // BUCKETS, n_tenants=BUCKETS),
        capacity=sd.scfg.bucket_capacity(BATCH, 1))
    fst, fdup, fovf = fleet.run_stream(fleet.init(), keys,
                                       range_bucket(keys, BUCKETS))
    assert torch.equal(dup, fdup) and torch.equal(ovf[:, 0], fovf)
    for f in ("bits", "load", "position", "rng"):
        assert torch.equal(getattr(g, f)[0], getattr(fst, f)), f
    assert int(g.router.n_rebalances) == 0
    assert launches == {"hashmix": 0, "bitset_step": N // BATCH,
                        "counter_step": 0}
