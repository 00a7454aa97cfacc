"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import neither jax nor the JAX package, so they run on a
GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device they skip; the plain versions themselves are held
against the JAX package by the other ``tests/test_torch_*.py`` files."""

import numpy as np
import pytest
import torch

from repro_torch.core import DedupConfig, packed, u32
from repro_torch.core import batched as tb
from repro_torch.kernels.fused_template import (bitset_step,
                                                bitset_step_plain)

BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", BITSET)
def test_kernel_matches_plain_on_card(cuda, variant):
    """The CUDA bitset step equals its plain version bit for bit on a
    half-full filter, over colliding, ragged and fresh batches."""
    from repro_torch.core import hashing, prng
    tc = DedupConfig.for_variant(variant, memory_bits=1 << 22, packed=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    words = torch.randint(-2 ** 31, 2 ** 31, (tc.k, tc.s_words),
                          dtype=torch.int32, device=cuda, generator=gen)
    load = packed.popcount(words)
    rng = prng.PRNGKey(3, cuda)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(tc.seed, tc.k), cuda)
    r = np.random.default_rng(5)
    position = tc.s - 3000
    for n_valid, hi in ((8192, 200), (5000, 2 ** 32), (8192, 2 ** 32)):
        keys = u32.from_numpy_u32(r.integers(0, hi, 8192, dtype=np.uint64),
                                  cuda)
        v = torch.arange(8192, device=cuda) < n_valid
        pos = hashing.hash_positions(keys, seeds, tc.s)
        seen = tb.intra_batch_seen(keys, v)
        i_t = position + torch.arange(8192, dtype=torch.int32, device=cuda)
        rng, rnd = tb.draw_randomness(tc, rng, 8192)
        got = words.clone()
        dup, ins, new_load = bitset_step(tc, got, pos, rnd, v, seen, i_t,
                                         load)
        new, dup_p, ins_p, load_p = bitset_step_plain(tc, words, pos, rnd, v,
                                                      seen, i_t, load)
        torch.cuda.synchronize()
        assert torch.equal(got, new) and torch.equal(new_load, load_p)
        assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
        words, load, position = got, new_load, position + n_valid


@pytest.mark.gpu
@pytest.mark.parametrize("s", (1 << 30, 715827882, 1 << 12, 1365))
def test_hashmix_kernel_matches_plain_on_card(cuda, s):
    from repro_torch.core import hashing
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    keys = u32.from_numpy_u32(np.random.default_rng(s % 1000).integers(
        0, 2 ** 32, 8192, dtype=np.uint64), cuda)
    for k in (1, 2, 3):
        seeds = u32.from_numpy_u32(hashing.derive_seeds(7, k), cuda)
        assert torch.equal(hashmix(keys, seeds, s=s),
                           hashmix_plain(keys, seeds, s))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", BITSET)
def test_engine_on_card_matches_engine_on_cpu(cuda, variant):
    """The whole engine through the kernels equals the whole engine
    through the plain versions: reports and every state leaf."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Dedup
    from repro_torch.kernels.hashmix import hashmix
    cfg = DedupConfig.for_variant(variant, memory_bits=1 << 16,
                                  batch_size=1024, packed=True)
    keys = np.random.default_rng(2).integers(0, 5000, 10_000) \
        .astype(np.uint32)
    on_card, on_cpu = Dedup(cfg, cuda), Dedup(cfg, "cpu")
    launches = (hashmix.launches, bitset_step.launches)
    sg, dg = on_card.run_stream(on_card.init(), keys)
    sc, dc = on_cpu.run_stream(on_cpu.init(), keys)
    assert hashmix.launches - launches[0] == 10
    assert bitset_step.launches - launches[1] == 10
    assert torch.equal(dg.cpu(), dc)
    a, b = state_to_numpy(sg), state_to_numpy(sc)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
