"""The port's linter lints itself (DESIGN.md §6), as the reference's does
(``tests/test_analysis.py``): every rule of ``repro_torch.analysis`` FIRES
on a deliberately broken case and stays quiet on the good step; the sweep
plumbing (baseline split, stale keys, device scope, the CLI) behaves; the
entry matrix covers the reference's; and the whole CPU sweep passes
against the checked-in baseline. The ``ptxas -v`` parser and the
kernel-resource rule run over a report recorded on an H100 (the card's own
sweep is ``tests/test_torch_analysis_gpu.py``)."""

import dataclasses
import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from repro.analysis import iter_entry_points as ref_entry_points
from repro_torch.analysis import (
    SOURCE_RULES, TRACE_RULES, EntryPoint, Finding, StepTrace, Target,
    adopt_entry, demangle, get_entry, iter_entry_points,
    lint_entry, lint_sources, load_baseline, parse_ptxas, render, run_lint,
)
from repro_torch.analysis.__main__ import DEFAULT_BASELINE, main
from repro_torch.analysis.entrypoints import (CANON_BATCH, canon_cfg,
                                              demo_keys, leaf_list,
                                              stream_entry)
from repro_torch.analysis.runner import LintReport, in_scope
from repro_torch.core import Dedup
from repro_torch.kernels import scope
from repro_torch.kernels.common import KERNELS, block_shared_bytes
from repro_torch.kernels.fused_template import bitset_step_plain

# an H100 build's ``nvcc -Xptxas -v`` report (sm_90a), eight of its 30
# kernels: both hashmix forms, one bitset probe, the counter step at D =
# 32, fused_probe, bloom_probe and scatter_delta
PTXAS_LOG = textwrap.dedent("""\
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__0afce718_10_hashmix_cu_b21d926814hashmix_kernelILb0EEEvPKjPii8HashSpec' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__0afce718_10_hashmix_cu_b21d926814hashmix_kernelILb0EEEvPKjPii8HashSpec
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 15 registers, used 1 barriers, 256 bytes smem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__0afce718_10_hashmix_cu_b21d926814hashmix_kernelILb1EEEvPKjPii8HashSpec' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__0afce718_10_hashmix_cu_b21d926814hashmix_kernelILb1EEEvPKjPii8HashSpec
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__876a57fa_14_bitset_step_cu_88d3e94e12probe_decideILb0ELb0EEEvNS_8StepArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__876a57fa_14_bitset_step_cu_88d3e94e12probe_decideILb0ELb0EEEvNS_8StepArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__31cc7905_15_counter_step_cu_a588994b19counter_merge_applyILi32EEEvNS_11CounterArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__31cc7905_15_counter_step_cu_a588994b19counter_merge_applyILi32EEEvNS_11CounterArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 528 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__31cc7905_15_counter_step_cu_a588994b23counter_probe_partitionILi32EEEvNS_11CounterArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__31cc7905_15_counter_step_cu_a588994b23counter_probe_partitionILi32EEEvNS_11CounterArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6a875536_14_bloom_probe_cu_82a77ffa18fused_probe_kernelILb0EEEvPKjS2_PhS3_Piix8HashSpec' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__6a875536_14_bloom_probe_cu_82a77ffa18fused_probe_kernelILb0EEEvPKjS2_PhS3_Piix8HashSpec
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 34 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6a875536_14_bloom_probe_cu_82a77ffa18bloom_probe_kernelEPKjPKiS1_Phiix' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__6a875536_14_bloom_probe_cu_82a77ffa18bloom_probe_kernelEPKjPKiS1_Phiix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__12570d56_16_scatter_delta_cu_8abe43ba20scatter_delta_kernelEPKiPKjPjiix' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__12570d56_16_scatter_delta_cu_8abe43ba20scatter_delta_kernelEPKiPKjPjiix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, used 0 barriers
""")


def _fake_entry(name="fake", tags=(), cfg=None, extra=None, probe=None):
    return EntryPoint(name=name, tags=frozenset(tags), cfg=cfg, device="cpu",
                      build=lambda: (_ for _ in ()).throw(
                          AssertionError("synthetic target must not build")),
                      retrace_probe=probe, extra=dict(extra or {}))


def _stepper(cfg, n_batches=1):
    """(engine, state box, keys) for hand-made entries on the CPU."""
    eng = Dedup(cfg, "cpu")
    return eng, [eng.init()], demo_keys(n_batches * cfg.batch_size, "cpu")


# ------------------------------------------------- each rule fires on its trap


def test_no_filter_sized_reduce_fires_on_debug_exact_load():
    """The canonical broken case is real: debug_exact_load recounts the
    whole filter, and the rule reports it under the key the baseline
    suppresses; the steady-state step reduces over nothing that large."""
    ep = get_entry("step/rlbsbf/planes/cpu/debug-exact-load")
    found = lint_entry(ep, rules=["no-filter-sized-reduce"])
    assert [f.key for f in found] == [
        "no-filter-sized-reduce::step/rlbsbf/planes/cpu/debug-exact-load"]
    assert "aten.sum" in found[0].detail
    assert lint_entry(get_entry("step/rlbsbf/planes/cpu"),
                      rules=["no-filter-sized-reduce"]) == []


def test_in_place_rule_fires_on_undonated_step():
    """``Dedup.process`` clones the filter (the interactive contract):
    driven as if it were donated, the rule names the planes leaf."""
    cfg = canon_cfg("rlbsbf", "planes")
    eng, box, keys = _stepper(cfg)

    def run():
        box[0], _ = eng.process(box[0], keys)
    ep = adopt_entry("mini/undonated/cpu", cfg, "cpu", run,
                     lambda: leaf_list(box[0]))
    found = lint_entry(ep, rules=["state-updated-in-place"])
    assert [f.rule for f in found] == ["state-updated-in-place"]
    assert ".bits" in found[0].detail
    # the donated stream keeps its planes in place (its small leaves are
    # rebound: the baselined finding, ROADMAP 4b)
    ok = lint_entry(get_entry("stream/rlbsbf/planes/cpu"),
                    rules=["state-updated-in-place"])
    assert len(ok) == 1 and ".bits" not in ok[0].detail


def test_in_place_rule_on_synthetic_traces():
    ep = _fake_entry("mini/leaves", tags=("donated",))
    same = StepTrace([], [(".bits", 7), (".load", 8)],
                     [(".bits", 7), (".load", 8)])
    assert lint_entry(ep, rules=["state-updated-in-place"],
                      target=Target(ep, trace=same)) == []
    moved = StepTrace([], [(".bits", 7)], [(".bits", 9)])
    assert len(lint_entry(ep, rules=["state-updated-in-place"],
                          target=Target(ep, trace=moved))) == 1


def test_state_sized_copy_fires_on_inflated_copy():
    """A stream step that clones its filter every batch moves O(s) bytes
    per batch; the good stream creates nothing that large."""
    cfg = canon_cfg("rlbsbf", "planes")
    eng, box, keys = _stepper(cfg, 2)

    def run():
        box[0] = box[0]._replace(bits=box[0].bits.clone())
        box[0], _ = eng.run_stream(box[0], keys)
    ep = adopt_entry("mini/copy/cpu", cfg, "cpu", run,
                     lambda: leaf_list(box[0]), tags=("stream",))
    found = lint_entry(ep, rules=["no-state-sized-copy"])
    assert [f.rule for f in found] == ["no-state-sized-copy"]
    assert "aten.clone" in found[0].detail
    assert lint_entry(get_entry("stream/rlbsbf/planes/cpu"),
                      rules=["no-state-sized-copy"]) == []


def test_plain_version_outside_its_region_is_filter_sized_work():
    """Why every wrapper runs its plain version inside a plain region: the
    plain bitset step builds (k, W) deltas, which the trace would count as
    the step's own copies; inside the region they are one kernel event."""
    cfg = canon_cfg("rlbsbf", "planes")
    eng, box, keys = _stepper(cfg)
    from repro_torch.core import batched
    from repro_torch.kernels.hashmix import positions_plain
    seeds, _ = batched._seeds(cfg)
    st = batched._lift(box[0])
    k1 = keys[None]
    v1 = torch.ones_like(k1, dtype=torch.bool)
    _, rnd = batched.draw_randomness(cfg, st.rng, cfg.batch_size)
    pos = positions_plain(keys, seeds, cfg.s)[None]
    seen = batched.intra_batch_seen(k1, v1)
    i_t = st.position[:, None] + torch.arange(cfg.batch_size,
                                              dtype=torch.int32)

    def plain():
        bitset_step_plain(cfg, st.bits, pos, rnd, v1, seen, i_t, st.load)

    def wrapped():
        with scope.plain_region("bitset_step"):
            plain()
    bare = adopt_entry("mini/bare/cpu", cfg, "cpu", plain, tags=("stream",))
    assert [f.rule for f in lint_entry(bare, rules=["no-state-sized-copy"])
            ] == ["no-state-sized-copy"]
    inside = adopt_entry("mini/inside/cpu", cfg, "cpu", wrapped,
                         tags=("stream",))
    assert lint_entry(inside, rules=["no-state-sized-copy"]) == []
    events = Target(inside).trace().events
    assert [e.op for e in events if e.kernel] == ["bitset_step"]
    assert not [e for e in events if not e.kernel]


def test_host_sync_rule_fires_on_item_in_step():
    cfg = canon_cfg("rlbsbf", "planes")
    eng, box, keys = _stepper(cfg)

    def run():
        _, res = eng.process(box[0], keys)
        res.dup.sum().item()
    ep = adopt_entry("mini/item/cpu", cfg, "cpu", run)
    found = lint_entry(ep, rules=["no-host-sync-in-step"])
    assert [f.rule for f in found] == ["no-host-sync-in-step"]
    assert "_local_scalar_dense" in found[0].detail
    assert lint_entry(get_entry("step/rlbsbf/planes/cpu"),
                      rules=["no-host-sync-in-step"]) == []


def test_host_sync_rule_fires_on_masked_select_and_card_refusals():
    cfg = canon_cfg("rlbsbf", "planes")
    eng, box, keys = _stepper(cfg)

    def run():
        _, res = eng.process(box[0], keys)
        keys[res.dup]                     # a data-dependent shape
    ep = adopt_entry("mini/mask/cpu", cfg, "cpu", run)
    found = lint_entry(ep, rules=["no-host-sync-in-step"])
    assert found and "aten.index.Tensor" in found[0].detail
    # the card's check, as a recorded trace: what set_sync_debug_mode
    # ("error") refused
    card = StepTrace([], sync_errors=["called a synchronizing CUDA "
                                      "operation at x.py:1 (f)"])
    fake = _fake_entry("mini/card")
    found = lint_entry(fake, rules=["no-host-sync-in-step"],
                       target=Target(fake, trace=card))
    assert found and "synchronizing" in found[0].detail


def test_f64_rule_fires_on_double():
    cfg = canon_cfg("rlbsbf", "planes")
    eng, box, keys = _stepper(cfg)

    def run():
        _, res = eng.process(box[0], keys)
        res.dup.to(torch.float64).mean()
    ep = adopt_entry("mini/f64/cpu", cfg, "cpu", run)
    found = lint_entry(ep, rules=["no-f64-upcast"])
    assert [f.rule for f in found] == ["no-f64-upcast"]
    assert lint_entry(get_entry("step/sbf/planes/cpu"),
                      rules=["no-f64-upcast"]) == []


def test_retrace_rule_reports_probe_problems():
    ep = _fake_entry("mini/retrace", probe=lambda: ["counted 3 widths"])
    found = lint_entry(ep, rules=["single-dispatch-no-retrace"],
                       target=Target(ep, trace=StepTrace([])))
    assert [f.rule for f in found] == ["single-dispatch-no-retrace"]
    assert "3 widths" in found[0].detail


def test_retrace_probe_sees_a_new_stream_shape():
    """The real probe passes on the engine, and a probe over streams of
    two lengths reports the second one (the counter the probe reads)."""
    cfg = canon_cfg("rlbsbf", "planes")
    good = stream_entry(cfg, "cpu", probe=True)
    assert good.retrace_probe() == []
    eng = Dedup(cfg, "cpu")
    eng.run_stream(eng.init(), demo_keys(CANON_BATCH, "cpu"))
    first = eng.stream_cache_size()
    eng.run_stream(eng.init(), demo_keys(2 * CANON_BATCH, "cpu"))
    assert eng.stream_cache_size() == first + 1


def test_rule_exception_becomes_lint_error_finding():
    ep = _fake_entry("mini/crash")
    found = lint_entry(ep, rules=["no-f64-upcast"])   # build() raises
    assert [f.rule for f in found] == ["lint-error"]
    assert "mini/crash::no-f64-upcast" == found[0].where


# ------------------------------------------------ ptxas and the kernel budget


def test_ptxas_parser_reads_a_recorded_report():
    got = {r.name: r for r in parse_ptxas(PTXAS_LOG)}
    assert list(got) == [
        "hashmix_kernel<false>", "hashmix_kernel<true>",
        "probe_decide<false, false>", "counter_merge_apply<32>",
        "counter_probe_partition<32>", "fused_probe_kernel<false>",
        "bloom_probe_kernel", "scatter_delta_kernel"]
    assert got["counter_merge_apply<32>"].registers == 96
    assert got["counter_merge_apply<32>"].shared == 528
    assert got["hashmix_kernel<false>"].shared == 256
    assert got["hashmix_kernel<true>"].shared == 0
    assert all(r.spill_stores == r.spill_loads == r.stack == 0
               for r in got.values())
    # the Hopper model says what each of them declares
    for r in got.values():
        assert block_shared_bytes(r.name) == r.shared, r.name
    bases = {name.split("<")[0] for name in got}
    assert bases <= {n for names in KERNELS.values() for n in names}


@pytest.mark.parametrize("mangled,want", [
    ("_ZN12_GLOBAL__N_119counter_merge_applyILi8EEEvNS_11CounterArgsE",
     "counter_merge_apply<8>"),
    ("_Z12empty_kernelv", "empty_kernel"),
    ("_Z5chaseILb1ELi3EEvPKj", "chase<true, 3>"),
    ("not_mangled", "not_mangled"),
])
def test_demangle(mangled, want):
    assert demangle(mangled) == want


def _kernel_target(log):
    ep = EntryPoint(name="kernel/mini/cuda", tags=frozenset({"kernel"}),
                    cfg=None, device="cuda",
                    build=lambda: (_ for _ in ()).throw(AssertionError()))
    return ep, Target(ep, ptxas_log=log)


def test_kernel_budget_quiet_on_the_recorded_report():
    ep, t = _kernel_target(PTXAS_LOG)
    assert lint_entry(ep, rules=["kernel-resource-budget"], target=t) == []


@pytest.mark.parametrize("old,new,why", [
    ("0 bytes spill stores, 0 bytes spill loads\nptxas info    : Used 14 "
     "registers, used 0 barriers\n",
     "8 bytes spill stores, 8 bytes spill loads\nptxas info    : Used 14 "
     "registers, used 0 barriers\n", "spills"),
    ("96 registers, used 1 barriers, 528 bytes smem",
     "96 registers, used 1 barriers, 1056 bytes smem", "the model says"),
    ("96 registers, used 1 barriers, 528 bytes smem",
     "96 registers, used 1 barriers, 240000 bytes smem", "over 232448"),
    ("18fused_probe_kernel", "18mystery_kernelxx", "not in"),
])
def test_kernel_budget_fires(old, new, why):
    assert old in PTXAS_LOG
    ep, t = _kernel_target(PTXAS_LOG.replace(old, new, 1))
    found = lint_entry(ep, rules=["kernel-resource-budget"], target=t)
    assert [f.rule for f in found] == ["kernel-resource-budget"]
    assert why in found[0].detail


def test_kernel_budget_fires_on_an_empty_report():
    ep, t = _kernel_target("(already built)")
    found = lint_entry(ep, rules=["kernel-resource-budget"], target=t)
    assert found and "no kernel" in found[0].detail


# ----------------------------------------------------------- source rules


def _lint_snippet(tmp_path, src, hot=True):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(src))
    return lint_sources([str(p)], hot=hot)


def test_source_rule_host_sync_only_in_hot(tmp_path):
    src = """\
        import numpy as np
        import torch
        def f(x):
            a = x.item()
            b = x.tolist()
            c = x.cpu()
            d = x.numpy()
            torch.cuda.synchronize()
            return np.asarray(x)
        """
    hot = _lint_snippet(tmp_path, src, hot=True)
    assert {f.rule for f in hot} == {"no-host-sync-in-hot-path"}
    assert len(hot) == 6
    assert _lint_snippet(tmp_path, src, hot=False) == []


def test_source_rule_shim_import(tmp_path):
    found = _lint_snippet(tmp_path, """\
        from repro_torch.kernels.fused_step import make_fused_batched_step
        """, hot=False)
    assert [f.rule for f in found] == ["no-deprecated-shim-import"]


def test_source_rule_tensor_branch(tmp_path):
    found = _lint_snippet(tmp_path, """\
        import torch
        def f(x):
            y = torch.sum(x)
            if y > 0:
                return x
            return -x
        """)
    assert [f.rule for f in found] == ["no-python-branch-on-tensor"]
    assert "`y`" in found[0].detail


def test_source_rule_tensor_branch_skips_safe_idioms(tmp_path):
    """is-None defaults, static reads (.shape, .dim(), .device), host
    re-bindings, isinstance and len, and torch calls that return host
    values must not fire."""
    assert _lint_snippet(tmp_path, """\
        import torch
        def f(x, valid=None):
            v = torch.ones_like(x)
            if valid is None:
                valid = v
            if x.shape[0] > 4 or v.dim() == 2 or v.device.type == "cpu":
                return valid
            if not isinstance(v, torch.Tensor) or len(v) > 3:
                return v
            dev = torch.device("cpu")
            if dev:
                return v
            n = torch.sum(x)
            n = int(3)
            while n > 0:
                n -= 1
            return valid
        """) == []


def test_repo_source_sweep_matches_baseline():
    """The checked-in tree carries exactly the baselined source findings
    (each with its reason in analysis/lint_baseline.json)."""
    keys = {f.key for f in lint_sources()}
    base = {k for k in load_baseline(DEFAULT_BASELINE)
            if k.split("::")[1].startswith("src/")}
    assert keys == base


# --------------------------------------------------------------- plumbing


def _ref_to_port(name, device):
    """A reference entry's name on the port: the device in the backend's
    place, or after the name where the reference has no backend."""
    parts = name.split("/")
    hit = [i for i, p in enumerate(parts) if p in ("jnp", "pallas")]
    if hit:
        parts[hit[0]] = device
        return "/".join(parts)
    return f"{name}/{device}"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_entry_matrix_covers_the_reference(device):
    """Every reference entry maps to a port entry, minus the backend axis;
    names are unique; building the lists runs nothing."""
    ref = [ep.name for ep in ref_entry_points()]
    port = [ep.name for ep in iter_entry_points(device)]
    assert len(port) == len(set(port))
    missing = {_ref_to_port(n, device) for n in ref} - set(port)
    assert not missing, missing
    extra = set(port) - {_ref_to_port(n, device) for n in ref}
    assert extra == ({f"kernel/{s}/cuda" for s in KERNELS}
                     if device == "cuda" else set())
    for ep in iter_entry_points(device):
        if ep.extra.get("filter_elems"):
            assert ep.extra["separable"], ep.name


def test_baseline_split_stale_and_scope(tmp_path):
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [
        {"key": "no-deprecated-shim-import::src/repro_torch/kernels/"
                "__init__.py::fused_step", "reason": "kept on purpose"},
        {"key": "ghost-rule::src/nowhere.py", "reason": "stale on purpose"},
        {"key": "no-f64-upcast::step/rlbsbf/planes/cuda",
         "reason": "another device's entry: out of a CPU sweep's scope"},
    ]}))
    report = run_lint(device="cpu", do_trace=False,
                      baseline=load_baseline(str(base)))
    assert [f.key for f, _ in report.suppressed] == [
        "no-deprecated-shim-import::src/repro_torch/kernels/__init__.py"
        "::fused_step"]
    assert report.stale_baseline == ["ghost-rule::src/nowhere.py"]
    assert "no-deprecated-shim-import" in {f.rule for f in report.findings}
    text = render(report)
    assert "FAIL" in text and "stale baseline" in text
    assert report.to_dict()["ok"] is False
    names = {ep.name for ep in iter_entry_points("cpu")}
    assert in_scope("no-f64-upcast::step/rlbsbf/planes/cpu", names)
    assert not in_scope("no-f64-upcast::step/rlbsbf/planes/cuda", names)
    assert in_scope("x::src/repro_torch/core/u32.py::np.asarray", names)


def test_stale_baseline_fails_full_sweep_only():
    rep = LintReport(findings=[], suppressed=[],
                     stale_baseline=["ghost-rule::nowhere"],
                     n_entries=1, n_trace_rules=1, n_source_rules=1,
                     n_source_files=1, elapsed_s=0.0, partial=False,
                     device="cpu")
    assert rep.ok is False and rep.to_dict()["ok"] is False
    assert "stale baseline suppression" in render(rep)
    filt = dataclasses.replace(rep, partial=True)
    assert filt.ok is True
    assert "WARNING" in render(filt)


def test_baseline_requires_justification(tmp_path):
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [{"key": "x::y"}]}))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(base))


def test_finding_key_is_stable():
    f = Finding("r", "entry/x", "line 12: something, 4096 bytes")
    assert f.key == "r::entry/x"
    assert f.to_dict()["key"] == f.key


def test_plain_region_nests_and_reports_the_outermost():
    seen = []
    with scope.observing(seen.append):
        with scope.plain_region("a"):
            assert scope.depth() == 1
            with scope.plain_region("b"):
                assert scope.depth() == 2
        with scope.plain_region("c"):
            pass
    assert seen == ["a", "c"] and scope.depth() == 0


def test_target_runs_its_entry_once():
    calls = []
    cfg = canon_cfg("rlbsbf", "planes")
    eng, box, keys = _stepper(cfg)
    ep = adopt_entry("mini/once/cpu", cfg, "cpu",
                     lambda: calls.append(eng.process(box[0], keys)))
    t = Target(ep)
    lint_entry(ep, target=t)
    assert len(calls) == 1
    assert any(e.kernel and e.op == "bitset_step" for e in t.trace().events)


def test_full_cpu_sweep_passes_against_the_baseline():
    """The tier-1 form of the gate: every entry on the CPU x every rule,
    every finding baselined with a reason, no stale key, in under 60 s."""
    t0 = time.monotonic()
    report = run_lint(device="cpu", baseline=load_baseline(DEFAULT_BASELINE))
    assert time.monotonic() - t0 < 60
    assert report.ok, render(report)
    assert not report.stale_baseline
    assert report.n_trace_rules == len(TRACE_RULES) == 7
    assert report.n_source_rules == len(SOURCE_RULES) == 3
    assert report.n_entries == len(iter_entry_points("cpu"))


def test_cli_device_cpu_exits_zero():
    ok = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "-q", "--json", "-"], capture_output=True, text=True)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    payload = json.loads(ok.stdout)
    assert payload["ok"] is True and payload["stale_baseline"] == []
    assert payload["device"] == "cpu"


def test_cli_source_only_respects_baseline():
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--source-only", "-q",
         "--baseline", "none", "--json", "-"],
        capture_output=True, text=True)
    assert bad.returncode == 1
    payload = json.loads(bad.stdout)
    assert payload["ok"] is False
    assert len(payload["findings"]) == len(lint_sources())


def test_cli_list_names_every_rule():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--list", "--device",
         "cpu"], capture_output=True, text=True)
    assert out.returncode == 0
    for name in list(TRACE_RULES) + list(SOURCE_RULES):
        assert name in out.stdout
    assert "compat-choke-point: no counterpart" in out.stdout
    assert "step/rlbsbf/planes/cpu" in out.stdout


def test_cli_refuses_cuda_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["-q"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
