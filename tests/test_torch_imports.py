"""The PyTorch port stands alone: no module of ``src/repro_torch`` (the
hot-path linter ``repro_torch.analysis`` included), not ``chip_smoke.py``,
not the examples of the port (``examples/*_torch.py``) and not the card
tests import jax, jaxlib or the JAX package ``repro`` —
the port has to install and run on a GPU machine that has none of them."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the card tests run on a GPU machine that has no jax either
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_gpu.py",
    ROOT / "tests" / "test_torch_sharded_gpu.py",
    ROOT / "tests" / "test_torch_analysis_gpu.py",
    ROOT / "tests" / "test_torch_models_gpu.py",
    ROOT / "tests" / "test_torch_train_gpu.py",
    ROOT / "tests" / "torch_lm_scorer.py"] + sorted(
    (ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_files_found():
    names = {p.name for p in FILES}
    assert {"engine.py", "hashmix.py", "fused_template.py", "sketch.py",
            "state.py", "packed.py", "convert.py", "metrics.py",
            "bloom_probe.py", "scatter_delta.py", "ops.py", "fleet.py",
            "batched.py", "prng.py", "chip_smoke.py", "variants.py",
            "theory.py", "pipeline.py", "paper_dedup.py",
            "streams.py", "cache.py", "frontend.py", "manager.py",
            "migrate.py", "sharded.py", "sharding.py",
            "test_torch_sharded_gpu.py", "source_lint.py", "trace_lint.py",
            "entrypoints.py", "runner.py", "common.py", "scope.py",
            "fused_step.py", "fused_counter_step.py", "ref.py",
            "test_torch_analysis_gpu.py", "layers.py", "transformer.py",
            "registry.py", "lm_archs.py", "test_torch_models_gpu.py",
            "torch_lm_scorer.py", "optimizers.py", "steps.py", "trainer.py",
            "lm.py", "train.py", "test_torch_train_gpu.py", "gnn.py",
            "recsys.py", "graphs.py", "recsys_data.py", "gnn_archs.py",
            "recsys_archs.py", "hw.py", "mesh.py", "analysis.py",
            "dryrun.py", "collectives.py", "hillclimb.py",
            "quickstart_torch.py", "click_fraud_stream_torch.py",
            "sbf_vs_rlbsbf_torch.py", "sliding_window_dedup_torch.py",
            "count_min_heavy_hitters_torch.py", "serving_frontend_torch.py",
            "dedup_training_torch.py",
            "sharded_dedup_multidevice_torch.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_names_the_reference_exports():
    """Names the reference exports, present in the port (their parity is
    held in the engine, packed, hashing, optimizer and train tests)."""
    import importlib
    want = {
        "repro_torch.core": ("make_templated_step", "make_scan_step",
                             "theory", "make_batched_step", "Dedup"),
        "repro_torch.core.packed": ("scatter_or", "scatter_andnot"),
        "repro_torch.core.hashing": ("uniform_positions",),
        "repro_torch.optim": ("OptimizerConfig", "OptState",
                              "apply_updates", "clip_by_global_norm",
                              "global_norm", "init_opt_state", "schedule"),
        "repro_torch.train": ("make_train_step", "StragglerWatchdog",
                              "Trainer", "TrainerConfig", "remesh",
                              "jit_sharded"),
        "repro_torch.distributed": ("collectives", "sharding"),
        "repro_torch.data": ("graphs", "lm", "recsys_data", "streams"),
        "repro_torch.data.graphs": ("random_graph", "molecule_batch",
                                    "CSRGraph", "NeighborSampler"),
        "repro_torch.data.recsys_data": ("CTRStream", "candidates_matrix"),
        "repro_torch.models": ("gnn", "layers", "moe", "recsys",
                               "transformer"),
        "repro_torch.models.gnn": ("GNNConfig", "init", "forward",
                                   "loss_fn"),
        "repro_torch.models.recsys": ("RecSysConfig", "default_vocab_sizes",
                                      "embedding_init", "embedding_bag",
                                      "init", "forward", "loss_fn",
                                      "retrieval_scores"),
        "repro_torch.configs": ("GNNArch", "RecsysArch", "all_cells",
                                "all_arch_ids", "get_arch"),
        "repro_torch.convert": ("gnn_params_from_numpy",
                                "gnn_params_to_numpy",
                                "recsys_params_from_numpy",
                                "recsys_params_to_numpy"),
        "repro_torch.data.lm": ("BigramCorpus", "seq_keys", "lm_batches"),
        "repro_torch.launch": ("train", "make_local_mesh",
                               "make_production_mesh", "analysis", "hw"),
        "repro_torch.models.transformer": ("forward",),
        "repro_torch.models.layers": ("weighted_xent", "layernorm",
                                      "mlp_init", "mlp_apply", "zeros_init",
                                      "ones_init"),
    }
    for module, names in want.items():
        mod = importlib.import_module(module)
        exported = getattr(mod, "__all__", None)
        for name in names:
            assert hasattr(mod, name) or name in (exported or ()), \
                (module, name)
            if exported is not None:
                assert name in exported, (module, name)


def test_launch_imports_without_touching_the_process_group():
    """``repro_torch.launch`` (and its dry run) import with no process
    group brought up and no fake world left behind: the dry run builds
    its own 256- or 512-rank world when it runs, never at import."""
    import os
    import subprocess
    import sys
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.mesh, repro_torch.launch.analysis\n"
            "assert not dist.is_initialized()\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
