"""The hot-path linter on the card. These tests import neither jax nor the
JAX package, so they run on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_analysis_gpu.py

The whole sweep on ``cuda`` against the checked-in baseline (each step
traced and run again under ``torch.cuda.set_sync_debug_mode("error")``,
every kernel's ``ptxas -v`` report held to the budget model); the plane
and dense8 steps pass the sync check at a larger table; a deliberate
``.item()`` inside a step is caught. Without a CUDA device they skip; the
rules themselves are held on the CPU by ``tests/test_torch_analysis.py``."""

import pytest
import torch

from repro_torch.analysis import (adopt_entry, lint_entry, load_baseline,
                                  parse_ptxas, render, run_lint)
from repro_torch.analysis.__main__ import DEFAULT_BASELINE
from repro_torch.analysis.entrypoints import demo_keys, leaf_list
from repro_torch.core import Dedup, DedupConfig
from repro_torch.dedup import DedupPipeline
from repro_torch.kernels import build
from repro_torch.kernels.common import KERNELS, block_shared_bytes

BATCH = 4096
MEMORY_BITS = 1 << 26


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync check and the kernels' "
                    "reports exist only on the card")
    return "cuda"


@pytest.mark.gpu
def test_sweep_on_card_passes_against_baseline(cuda):
    report = run_lint(device=cuda, baseline=load_baseline(DEFAULT_BASELINE))
    assert report.ok, render(report)
    assert not report.stale_baseline


@pytest.mark.gpu
@pytest.mark.parametrize("source", list(KERNELS))
def test_kernel_reports_match_the_model(cuda, source):
    kernels = parse_ptxas(build.build_log(source))
    assert {k.name.split("<")[0] for k in kernels} == set(KERNELS[source])
    for k in kernels:
        assert k.spill_stores == k.spill_loads == 0, k
        assert k.shared == block_shared_bytes(k.name), k


def _step_entries(device):
    """One stream step of rlbsbf and sbf on planes and one dense8
    ``DedupPipeline`` step, each donated."""
    out = []
    keys = demo_keys(BATCH, device, seed=3)
    for name, cfg in (
            ("rlbsbf-planes", DedupConfig.for_variant(
                "rlbsbf", memory_bits=MEMORY_BITS, batch_size=BATCH,
                packed=True)),
            ("sbf-planes", DedupConfig.for_variant(
                "sbf", memory_bits=MEMORY_BITS, batch_size=BATCH,
                layout="planes"))):
        eng = Dedup(cfg, device)
        box = [eng.init()]

        def run(eng=eng, box=box):
            box[0], _ = eng.run_stream(box[0], keys)
        out.append(adopt_entry(f"gpu/{name}/cuda", cfg, device, run,
                               lambda box=box: leaf_list(box[0]),
                               tags=("stream",)))
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=MEMORY_BITS,
                                  batch_size=BATCH)
    pipe = DedupPipeline(cfg, mode="flag", device=device)
    truth = torch.zeros((BATCH,), dtype=torch.bool, device=device)
    out.append(adopt_entry(
        "gpu/dense8-pipeline/cuda", cfg, device,
        lambda: pipe.process({"key": keys}, truth),
        lambda: leaf_list(pipe.state), tags=("stream",)))
    return out


@pytest.mark.gpu
def test_sync_check_lets_plane_and_dense8_steps_through(cuda):
    for ep in _step_entries(cuda):
        found = lint_entry(ep, rules=["no-host-sync-in-step",
                                      "no-filter-sized-reduce",
                                      "no-state-sized-copy",
                                      "no-f64-upcast"])
        assert found == [], (ep.name, found)


@pytest.mark.gpu
def test_item_inside_a_step_is_caught(cuda):
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 20,
                                  batch_size=256, packed=True)
    eng = Dedup(cfg, cuda)
    st = eng.init()
    keys = demo_keys(256, cuda)

    def run():
        _, res = eng.process(st, keys)
        res.dup.sum().item()
    found = lint_entry(adopt_entry("gpu/item/cuda", cfg, cuda, run),
                       rules=["no-host-sync-in-step"])
    assert [f.rule for f in found] == ["no-host-sync-in-step"]
    assert "synchronizing" in found[0].detail
    assert "_local_scalar_dense" in found[0].detail
