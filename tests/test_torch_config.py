"""The port's ``DedupConfig`` equals the JAX package's, field for field and
property for property, and refuses the same configurations."""

import dataclasses

import pytest

from repro.core import config as jcfg
from repro_torch.core import config as tcfg
from repro_torch.convert import config_from_dict

MB = 8 * 1024 * 1024
PROPS = ("is_counter", "bits_per_cell", "effective_layout", "is_planes",
         "n_planes", "s", "n_rows", "s_words", "sbf_p_effective",
         "rsbf_phase3_start")


def test_module_constants_equal():
    for name in ("VARIANTS", "WINDOWED_VARIANTS", "COUNTING_VARIANTS",
                 "ALL_VARIANTS"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert [f.name for f in dataclasses.fields(tcfg.DedupConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.DedupConfig)]
    assert dataclasses.asdict(tcfg.DedupConfig()) == \
        dataclasses.asdict(jcfg.DedupConfig())


@pytest.mark.parametrize("fpr_t", (0.5, 0.1, 0.01, 1e-4))
def test_k_helpers_equal(fpr_t):
    assert tcfg.k_from_fpr_t(fpr_t) == jcfg.k_from_fpr_t(fpr_t)
    assert tcfg.rsbf_k(fpr_t) == jcfg.rsbf_k(fpr_t)
    for k, m, cmax in ((3, 1 << 12, 3), (2, 1 << 20, 1), (4, 12345, 7)):
        assert tcfg.sbf_optimal_p(fpr_t, k, m, cmax) == \
            jcfg.sbf_optimal_p(fpr_t, k, m, cmax)


@pytest.mark.parametrize("memory_bits", (1 << 12, 1 << 16, 64 * MB, 256 * MB,
                                         512 * MB))
@pytest.mark.parametrize("variant", jcfg.ALL_VARIANTS)
def test_fields_and_properties_equal(variant, memory_bits):
    kws = ({}, dict(packed=True), dict(layout="planes", shards=4),
           dict(fpr_t=0.01, p_star=0.05, block_bits=9))
    for kw in kws:
        a = jcfg.DedupConfig.for_variant(variant, memory_bits=memory_bits,
                                         **kw)
        b = tcfg.DedupConfig.for_variant(variant, memory_bits=memory_bits,
                                         **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), kw
        for prop in PROPS:
            assert getattr(a, prop) == getattr(b, prop), (prop, kw)
        assert config_from_dict(dataclasses.asdict(a)) == b


BAD = [
    dict(variant="nope"),
    dict(k=0),
    dict(variant="swbf", window=0),
    dict(variant="swbf", window=2, cbf_bits=9),
    dict(variant="swbf", window=2, layout="dense8"),
    dict(variant="cms", count_bits=0),
    dict(variant="cms", count_threshold=0),
    dict(variant="hh", count_bits=2, count_threshold=9),
    dict(variant="cms", layout="dense8"),
    dict(p_star=1.5),
    dict(layout="weird"),
    dict(layout="dense8", packed=True),
    dict(backend="cuda"),
    dict(backend="pallas"),
    dict(rebalance_buckets=-1),
    dict(rebalance_threshold=0.5),
    dict(rebalance_threshold=2.0),
    dict(n_tenants=0),
    dict(n_tenants=3),
]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_validation_errors_mirror_reference(kw):
    with pytest.raises(ValueError) as want:
        jcfg.DedupConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        tcfg.DedupConfig(**kw).validate()
    assert str(got.value) == str(want.value)


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown DedupConfig fields"):
        config_from_dict({"variant": "rlbsbf", "bogus": 1})
