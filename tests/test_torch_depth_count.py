"""The dry run's per-layer count (``repro_torch.launch.dryrun.depth_count``)
and the attention's regroup under a "model" split that the KV heads do
not divide (``repro_torch.models.transformer._gqa_factor``).

The per-layer count traces an LM cell at d1 = dense + 1 and d2 = dense +
2 layers and reports each additive term at the full depth L as c(d1) +
(L - d1)(c(d2) - c(d1)), with a train step's optimizer update traced
alone at full depth: on ``meshcheck.DEPTH_CELLS`` (qwen3-8b's and
deepseek-v2-236b's smoke train steps, deepseek with its dense first
layer, and a prefill in 8 x 8 attention tiles, each at 4 layers on a
fake (2, 2) mesh) every additive term equals the full-depth trace's, and
temp is within 5%. The GQA analog's attention sublayer (8 query heads,
2 KV heads) splits 4x on a fake (1, 4) mesh, gathering K and V's
head_dim and nothing of the queries. Fake process groups are global to
their process, so each trace runs in a subprocess of its own, all
started together when the module's first test needs them."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import meshcheck
from repro_torch.models.transformer import gqa_factor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEPTH = """
import json, sys
from repro_torch.launch import meshcheck
rec = meshcheck.depth_trace(sys.argv[1], sys.argv[2] == "full")
print(json.dumps(rec, default=float))
"""

ATTENTION = """
import json
from repro_torch.launch import dryrun, meshcheck
from repro_torch.launch.mesh import make_local_mesh
out = {"plain": meshcheck.attention_trace("mixtral-8x7b")}
with dryrun.fake_world(4):
    out["1x4"] = meshcheck.attention_trace(
        "mixtral-8x7b", make_local_mesh(model=4, device="cpu"))
print(json.dumps(out, default=float))
"""


def _start(code, *argv):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *argv], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def traces():
    procs = {(name, form): _start(DEPTH, name, form)
             for name in meshcheck.DEPTH_CELLS for form in ("count", "full")}
    procs["attention"] = _start(ATTENTION)
    return {k: _finish(p) for k, p in procs.items()}


@pytest.mark.parametrize("name", list(meshcheck.DEPTH_CELLS))
def test_per_layer_count_equals_full_depth(traces, name):
    """Flops and bytes by op, collective bytes and counts by kind and by
    op, argument, output and alias bytes: the per-layer count equals the
    full-depth trace exactly; temp within 5%."""
    count, full = traces[(name, "count")], traces[(name, "full")]
    assert count["counted_at_depths"] == (
        [2, 3] if name.startswith("deepseek") else [1, 2])
    assert "counted_at_depths" not in full
    diff = meshcheck.depth_differences(count, full)
    assert meshcheck.depth_ok(diff), diff


def test_gqa_attention_splits_four_ways(traces):
    """mixtral-8x7b's smoke GQA analog (8 query heads over 2 KV heads,
    head_dim 16): on a fake (1, 4) mesh its attention sublayer, forward
    and backward, does a quarter of the unplaced flops, and all it
    gathers is K and V's head_dim — no all-gather of the queries."""
    plain, split = traces["attention"]["plain"], traces["attention"]["1x4"]
    assert split["norm_bytes"] == 0          # mixtral has no q / k norm
    assert meshcheck.attention_sublayer_ok(plain, split), (plain, split)


@pytest.mark.parametrize("heads,kv,m,f", [(32, 8, 16, 2), (32, 32, 16, 1),
                                          (8, 2, 4, 2), (8, 1, 2, 2),
                                          (12, 4, 8, 1), (32, 8, 1, 1),
                                          (16, 2, 8, 4)])
def test_gqa_factor(heads, kv, m, f):
    """The least f that cuts each KV head's query group so that the KV
    heads times f divide the split: 2 for mixtral-8x7b's and qwen3-8b's
    32 over 8 at "model" 16; 1 where the KV heads divide the split, where
    the query heads do not, or on one rank."""
    assert gqa_factor(heads, kv, m) == f


def test_a_config_whose_layers_differ_is_refused():
    """A config whose specs change with its depth (here its lm_head's
    below 4 layers) is not counted per layer: its layers are not alike,
    and the count refuses it with the reason rather than count it
    wrong."""
    from repro_torch.configs.registry import LMArch
    from repro_torch.distributed.sharding import P
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    class Uneven(LMArch):
        def param_specs(self, mesh, fsdp=None):
            specs = super().param_specs(mesh, fsdp)
            if self.cfg.n_layers < meshcheck.DEPTH_LAYERS:
                specs = {**specs, "lm_head": P(None, None)}
            return specs

    arch, shape = meshcheck.depth_arch("qwen3-8b/train_4k")
    uneven = Uneven(arch.arch_id, arch.cfg, arch.accum)
    uneven.shapes = arch.shapes
    with dryrun.fake_world(4):
        with pytest.raises(ValueError, match="not alike"):
            dryrun.trace_cell(uneven, shape,
                              make_local_mesh(model=2, device="cpu"))
