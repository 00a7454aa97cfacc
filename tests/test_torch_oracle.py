"""The paper-order sequential oracle in the port (``core.variants``,
``Dedup.run_stream_oracle``), on the CPU: all five variants against the
reference's ``run_stream_oracle`` bit for bit — rsbf through its three
phases and with ``delete_set_bits_only`` — and the batch-size-1 pin the
reference makes for sbf (``tests/test_counter_planes.py``): the oracle
equals the batched engine at B = 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Dedup as JDedup
from repro.core import DedupConfig as JConfig
from repro_torch.convert import state_to_numpy
from repro_torch.core import Dedup, DedupConfig
from repro_torch.core.variants import make_scan_step

VARIANTS = ("sbf", "rsbf", "bsbf", "bsbfsd", "rlbsbf")


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _keys(n, hi, seed):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.uint32)


def _same(js, ts, ctx):
    a = {"bits": np.asarray(js.bits), "position": np.asarray(js.position),
         "load": np.asarray(js.load),
         "rng": np.asarray(jax.random.key_data(js.rng))}
    b = state_to_numpy(ts)
    for key in a:
        assert a[key].dtype == b[key].dtype, (key, ctx)
        assert np.array_equal(a[key], b[key]), (key, ctx)


@pytest.mark.parametrize("variant, extra", [
    ("sbf", {}), ("rsbf", {"p_star": 0.5}),
    ("rsbf", {"p_star": 0.5, "delete_set_bits_only": True}),
    ("bsbf", {}), ("bsbfsd", {}), ("rlbsbf", {}),
    ("rlbsbf", {"block_bits": 5})])
def test_oracle_matches_reference(variant, extra):
    """Reports and final state equal the reference oracle's; the caller's
    state is left as it was. rsbf at p* = 0.5 (s = 1365) crosses from
    phase 1 into phase 2 at element 1366 and into phase 3 at 2731."""
    kw = dict(memory_bits=1 << 12, **extra)
    jd = JDedup(JConfig.for_variant(variant, **kw))
    td = Dedup(DedupConfig.for_variant(variant, **kw), "cpu",
               partitionable=_layout())
    # rsbf runs long enough for its phase 3, the others a shorter stream
    keys = _keys(3000, 2500, 11) if variant == "rsbf" else _keys(1500,
                                                                 1200, 11)
    if variant == "rsbf":
        assert td.cfg.s < 3000 and td.cfg.rsbf_phase3_start < 3000
    sj, dj = jd.run_stream_oracle(jd.init(), jnp.asarray(keys))
    start = td.init()
    st, dt = td.run_stream_oracle(start, keys)
    assert dt.dtype == torch.bool and dt.shape == keys.shape
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    _same(sj, st, (variant, extra))
    assert int(start.bits.sum()) == 0 and int(start.position) == 1


def test_sbf_oracle_equals_engine_at_batch_one():
    """At B = 1 the batched sbf step draws and applies what the oracle
    does: the same reports, cells, load, position and key, both in the
    port and against the reference's oracle."""
    kw = dict(memory_bits=1 << 12, batch_size=1)
    td = Dedup(DedupConfig.for_variant("sbf", **kw), "cpu",
               partitionable=_layout())
    jd = JDedup(JConfig.for_variant("sbf", **kw))
    keys = _keys(600, 200, 12)
    so, do = td.run_stream_oracle(td.init(), keys)
    sb, db = td.run_stream(td.init(), keys)
    assert np.array_equal(do.numpy(), db.numpy())
    a, b = state_to_numpy(so), state_to_numpy(sb)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    sj, dj = jd.run_stream_oracle(jd.init(), jnp.asarray(keys))
    assert np.array_equal(do.numpy(), np.asarray(dj))
    _same(sj, so, "sbf B=1")


def test_scan_step_refuses_planes():
    """The scan step exists on dense8 only, with the reference's words."""
    from repro.core.variants import make_scan_step as jstep
    cfg = dict(memory_bits=1 << 12, packed=True)
    with pytest.raises(ValueError) as want:
        jstep(JConfig.for_variant("bsbf", **cfg))
    with pytest.raises(ValueError) as got:
        make_scan_step(DedupConfig.for_variant("bsbf", **cfg))
    assert str(got.value) == str(want.value)
