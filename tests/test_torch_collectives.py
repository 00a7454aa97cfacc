"""``repro_torch.distributed.collectives`` against
``repro.distributed.collectives``, bit for bit, at 2 and 4 gloo ranks.

The port runs as gloo ranks, each a process of its own; the reference runs
in this process under ``jax.vmap`` over a stacked rank axis, where its
``psum`` / ``pmax`` reduce over that axis on one CPU device. The same
numpy-seeded gradients (and error states) go to both. ``compressed_psum``
sums int32 and takes a max, so the order of the reduction cannot change a
bit; ``hierarchical_psum`` adds two values per level, and a sum of two is
the same in either order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.distributed import collectives as ref_coll
from test_torch_sharded import run_ranks

WORLDS = (2, 4)
SHAPES = {"a": (5, 7), "b/c": (11,), "b/d": (3, 2, 2)}


def _tree(flat: dict) -> dict:
    return {"a": flat["a"], "b": {"c": flat["b/c"], "d": flat["b/d"]}}


def _flat(tree: dict) -> dict:
    return {"a": tree["a"], "b/c": tree["b"]["c"], "b/d": tree["b"]["d"]}


def _inputs(world: int) -> dict:
    """Per rank (leading axis): gradients of mixed magnitudes, one leaf
    all zero on rank 0, the error states, and a tensor for the two-level
    sum."""
    rng = np.random.default_rng(world)
    out = {}
    for k, shp in SHAPES.items():
        scale = rng.uniform(1e-3, 10, (world,) + (1,) * len(shp))
        out[f"g/{k}"] = (rng.standard_normal((world,) + shp) * scale
                         ).astype(np.float32)
        out[f"e/{k}"] = (rng.standard_normal((world,) + shp) * 1e-3
                         ).astype(np.float32)
    out["g/b/d"][0] = 0.0
    out["x"] = rng.standard_normal((world, 6, 5)).astype(np.float32)
    return out


PORT_WORKER = """
import os, sys
import numpy as np
import torch, torch.distributed as dist
from repro_torch.distributed.collectives import (compressed_psum,
                                                 hierarchical_psum)

tmp = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world)
inp = np.load(os.path.join(tmp, f"in-{world}.npz"))
keys = ("a", "b/c", "b/d")

def tree(prefix):
    t = {k: torch.from_numpy(inp[f"{prefix}/{k}"][rank]) for k in keys}
    return {"a": t["a"], "b": {"c": t["b/c"], "d": t["b/d"]}}

def flat(t):
    return {"a": t["a"], "b/c": t["b"]["c"], "b/d": t["b"]["d"]}

out = {}
for tag, err in (("none", None), ("err", tree("e"))):
    synced, new_err = compressed_psum(tree("g"), None, err)
    for k, v in flat(synced).items():
        out[f"{tag}/sync/{k}"] = v.numpy()
    for k, v in flat(new_err).items():
        out[f"{tag}/err/{k}"] = v.numpy()
# two levels: inner groups of 2 consecutive ranks, outer across them
inner = [dist.new_group([2 * i, 2 * i + 1]) for i in range(world // 2)]
outer = ([dist.new_group([j, j + 2]) for j in range(2)] if world == 4
         else None)
x = torch.from_numpy(inp["x"][rank])
out["hier"] = hierarchical_psum(
    x, inner[rank // 2], None if outer is None else outer[rank % 2]).numpy()
assert torch.equal(x, torch.from_numpy(inp["x"][rank]))
np.savez(os.path.join(tmp, f"out-{world}-{rank}.npz"), **out)
dist.destroy_process_group()
print("{}")
"""


def _reference(world: int, inp: dict) -> dict:
    g = _tree({k: jnp.asarray(inp[f"g/{k}"]) for k in SHAPES})
    e = _tree({k: jnp.asarray(inp[f"e/{k}"]) for k in SHAPES})
    out = {}
    s, ne = jax.vmap(lambda g: ref_coll.compressed_psum(g, "r"),
                     axis_name="r")(g)
    out["none/sync"], out["none/err"] = _flat(s), _flat(ne)
    s, ne = jax.vmap(lambda g, e: ref_coll.compressed_psum(g, "r", e),
                     axis_name="r")(g, e)
    out["err/sync"], out["err/err"] = _flat(s), _flat(ne)
    x = jnp.asarray(inp["x"])
    if world == 2:
        h = jax.vmap(lambda v: ref_coll.hierarchical_psum(v, "in", None),
                     axis_name="in")(x)
    else:
        h = jax.vmap(jax.vmap(
            lambda v: ref_coll.hierarchical_psum(v, "in", "out"),
            axis_name="in"), axis_name="out")(x.reshape(2, 2, 6, 5))
        h = h.reshape(4, 6, 5)
    out["hier"] = h
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    res = {}
    for world in WORLDS:
        inp = _inputs(world)
        np.savez(tmp / f"in-{world}.npz", **inp)
        run_ranks(PORT_WORKER, tmp, world)
        port = [dict(np.load(tmp / f"out-{world}-{r}.npz"))
                for r in range(world)]
        res[world] = (_reference(world, inp), port)
    return res


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["none", "err"])
def test_compressed_psum_bit_for_bit(runs, world, tag):
    ref, port = runs[world]
    for r in range(world):
        for k in SHAPES:
            assert _same_bits(port[r][f"{tag}/sync/{k}"],
                              ref[f"{tag}/sync"][k][r]), (r, k)
            assert _same_bits(port[r][f"{tag}/err/{k}"],
                              ref[f"{tag}/err"][k][r]), (r, k)
    # every rank holds the same mean; the all-zero leaf's residual is 0
    for k in SHAPES:
        assert all(_same_bits(port[r][f"{tag}/sync/{k}"],
                              port[0][f"{tag}/sync/{k}"])
                   for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_hierarchical_psum_bit_for_bit(runs, world):
    ref, port = runs[world]
    for r in range(world):
        assert _same_bits(port[r]["hier"], ref["hier"][r]), r


def test_quantize_roundtrip_matches_reference():
    """One rank's form: quantize then dequantize, against the
    reference's, on values that round half to even."""
    import torch
    from repro_torch.distributed.collectives import (dequantize_int8,
                                                     quantize_int8)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4096).astype(np.float32) * 3
    x[:5] = [127.0, -127.0, 0.5, 2.5, -1.5]   # scale 1: exact halves
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref_coll.quantize_int8(jnp.asarray(x))
    assert _same_bits(q.numpy(), rq) and _same_bits(s.numpy(), rs)
    assert _same_bits(dequantize_int8(q, s).numpy(),
                      ref_coll.dequantize_int8(rq, rs))
