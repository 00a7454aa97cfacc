"""The counter half of the port's packed algebra (DESIGN §3.6) against
``repro.core.packed``, exactly, on the same random inputs: d in
{1, 2, 4, 8} planes and caps {1, 3, 15, 255}, so that both branches of
``clamped_run_counts`` and of ``count_planes_from_sorted`` run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as jp
from repro_torch.core import packed, u32

PLANES = (1, 2, 4, 8)
CAPS = (1, 3, 15, 255)


def _w(a):
    return u32.from_numpy_u32(a, "cpu")


def _same_words(got, want):
    assert np.array_equal(u32.to_numpy_u32(got), np.asarray(want))


def _random_planes(r, d, w):
    return r.integers(0, 2 ** 32, (d, w), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("d", PLANES)
def test_cell_probe_pack_and_nonzero(d):
    r = np.random.default_rng(d)
    s, w = 1000, 32
    cells = r.integers(0, 1 << d, s)
    planes = np.asarray(jp.pack_cells(jnp.asarray(cells), d))
    _same_words(packed.pack_cells(torch.from_numpy(cells), d), planes)
    assert np.array_equal(packed.unpack_cells(_w(planes), s).numpy(),
                          np.asarray(jp.unpack_cells(jnp.asarray(planes), s)))
    assert np.array_equal(packed.unpack_cells(_w(planes), s).numpy(), cells)
    pos = r.integers(0, s, (300, 3)).astype(np.int32)
    assert np.array_equal(
        packed.probe_cell_values(_w(planes), torch.from_numpy(pos)).numpy(),
        np.asarray(jp.probe_cell_values(jnp.asarray(planes),
                                        jnp.asarray(pos))))
    full = _random_planes(r, d, w)
    _same_words(packed.planes_nonzero(_w(full)),
                jp.planes_nonzero(jnp.asarray(full)))


@pytest.mark.parametrize("d", PLANES + (3, 5, 16))
def test_count_fields_to_planes(d):
    r = np.random.default_rng(10 + d)
    w = 24
    nc = packed.count_field_chunks(d)
    assert nc == jp.count_field_chunks(d)
    acc = r.integers(0, 2 ** 32, w * nc, dtype=np.uint64).astype(np.uint32)
    _same_words(packed.counts_to_planes(_w(acc), d, w),
                jp.counts_to_planes(jnp.asarray(acc), d, w))


def _sorted_events(r, n, s, sentinel, dup_heavy):
    hi = max(2, s // 40) if dup_heavy else s
    ev = r.integers(0, hi, n)
    ev[r.random(n) < 0.15] = sentinel
    return np.sort(ev).astype(np.int32)


@pytest.mark.parametrize("cmax", CAPS)
def test_clamped_run_counts_both_branches(cmax):
    r = np.random.default_rng(cmax)
    for dup_heavy in (True, False):
        sp = _sorted_events(r, 900, 4096, 4096, dup_heavy)
        head, cnt = packed.clamped_run_counts(torch.from_numpy(sp), cmax)
        jh, jc = jp.clamped_run_counts(jnp.asarray(sp), cmax)
        assert np.array_equal(head.numpy(), np.asarray(jh))
        assert np.array_equal(cnt.numpy(), np.asarray(jc))
        assert np.array_equal(head.numpy(), np.asarray(
            jp.run_heads_1d(jnp.asarray(sp))))
        assert np.array_equal(packed.run_heads_1d(torch.from_numpy(sp))
                              .numpy(), np.asarray(jh))


@pytest.mark.parametrize("d", PLANES)
def test_count_planes_from_sorted(d):
    """Both forms (chunked fields for d <= 2, the (W, d) accumulator above)
    on duplicate-heavy and spread events, sentinels dropped."""
    r = np.random.default_rng(20 + d)
    w = 64
    for dup_heavy in (True, False):
        sp = _sorted_events(r, 700, 32 * w - 5, 32 * w, dup_heavy)
        cmax = (1 << d) - 1
        jh, jc = jp.clamped_run_counts(jnp.asarray(sp), cmax)
        head, cnt = packed.clamped_run_counts(torch.from_numpy(sp), cmax)
        _same_words(packed.count_planes_from_sorted(
            torch.from_numpy(sp), head, cnt, d, w),
            jp.count_planes_from_sorted(jnp.asarray(sp), jh, jc, d, w))


@pytest.mark.parametrize("d", PLANES)
def test_saturating_chains(d):
    r = np.random.default_rng(30 + d)
    a, c = _random_planes(r, d, 40), _random_planes(r, d, 40)
    _same_words(packed.planes_saturating_sub(_w(a), _w(c)),
                jp.planes_saturating_sub(jnp.asarray(a), jnp.asarray(c)))
    _same_words(packed.planes_saturating_add(_w(a), _w(c)),
                jp.planes_saturating_add(jnp.asarray(a), jnp.asarray(c)))
    with pytest.raises(ValueError, match="differ in d"):
        packed.planes_saturating_sub(_w(a), _w(c)[:0])


@pytest.mark.parametrize("d,value", ((1, 1), (1, 0), (2, 2), (2, 3),
                                     (4, 5), (4, 10), (8, 0xA5)))
def test_set_value_with_mixed_bits(d, value):
    r = np.random.default_rng(d * 100 + value)
    a = _random_planes(r, d, 40)
    delta = r.integers(0, 2 ** 32, 40, dtype=np.uint64).astype(np.uint32)
    got = packed.planes_set_value(_w(a), _w(delta), value)
    _same_words(got, jp.planes_set_value(jnp.asarray(a), jnp.asarray(delta),
                                         value))
    # every selected cell now holds exactly ``value``
    cells = packed.unpack_cells(got, 32 * 40).numpy().reshape(40, 32)
    sel = (delta[:, None] >> np.arange(32)) & 1
    assert (cells[sel == 1] == value).all()
