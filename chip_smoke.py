#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, reproduces the
reference's pinned digests on CUDA, drives the main path — rlbsbf on the
paper's 256 MB table (k = 2, s = 2^30 bits per row) at batch width 8192
over a 2^24-record stream with the paper's 60% distinct fraction — and
times each kernel beside its bound. Every phase fails the run; the last
line of standard output is ``{"ok": true, "device": {...}}`` only when all
of them passed. Without a CUDA device, or without the ``src/repro_torch``
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
MEMORY_BITS = 1 << 31            # the paper's 256 MB table (configs/paper_dedup.py)
BATCH = 8192                     # DedupConfig.batch_size
STREAM_N = 1 << 24               # the paper's 695M-1B records, cut for time
DISTINCT_FRAC = 0.60             # the paper's 60% distinct (Section 6)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
PINNED_DIGESTS = {               # tests/test_sketch_template.py (reference)
    "bsbf": "4e3f72a324d1eb32",
    "bsbfsd": "9936da3ee28dfb25",
    "rlbsbf": "2fa66ecae9583e86",
    "rsbf": "6371d978a8821296",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def step_inputs(cfg, state, keys, valid, partitionable=True):
    """What the engine's step hands the bitset kernel for one batch, and
    the key the step leaves behind."""
    import torch
    from repro_torch.core import batched, hashing, u32
    from repro_torch.kernels.hashmix import hashmix_plain
    dev = state.bits.device
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k), dev)
    kw = u32.from_numpy_u32(keys, dev)
    valid = torch.as_tensor(valid, device=dev)
    pos = hashmix_plain(kw, seeds, cfg.s)
    seen = batched.intra_batch_seen(kw, valid)
    i_t = state.position + torch.arange(len(keys), dtype=torch.int32,
                                        device=dev)
    rng, rnd = batched.draw_randomness(cfg, state.rng, len(keys),
                                       partitionable)
    return rng, (pos, rnd, valid, seen, i_t)


def random_state(cfg, rng, position: int):
    """A filter at ~50% density with its exact load, handed to the port
    through ``state_from_numpy`` at stream ``position``."""
    import torch
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import packed
    words = rng.integers(0, 2 ** 32, (cfg.k, cfg.s_words), dtype=np.uint32)
    tail = cfg.s - 32 * (cfg.s_words - 1)        # bits past s stay clear
    if tail < 32:
        words[:, -1] &= np.uint32((1 << tail) - 1)
    load = packed.popcount(torch.from_numpy(words.view(np.int32)).cuda())
    leaves = {"bits": words, "position": np.int32(position),
              "load": load.cpu().numpy(),
              "rng": np.array([0, cfg.seed], np.uint32)}
    return state_from_numpy(leaves, cfg, "cuda")


def phase_hashmix(rng):
    import torch
    from repro_torch.core import DedupConfig, hashing, u32
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    worst = 0
    for variant in ("rlbsbf", "rsbf"):
        cfg = DedupConfig.for_variant(variant, memory_bits=MEMORY_BITS,
                                      packed=True)
        keys = u32.from_numpy_u32(
            rng.integers(0, 2 ** 32, BATCH, dtype=np.uint64), "cuda")
        seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k),
                                   "cuda")
        got = hashmix(keys, seeds, s=cfg.s)
        want = hashmix_plain(keys, seeds, cfg.s)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"hashmix != plain for k={cfg.k} s={cfg.s}")
        log(f"[hashmix] k={cfg.k} s={cfg.s} "
            f"({'mask' if cfg.s & (cfg.s - 1) == 0 else 'mod'}) B={BATCH}: "
            f"exactly equal to the plain version")
    return worst


def phase_bitset(rng):
    import torch
    from repro_torch.core import DedupConfig, packed, u32
    from repro_torch.kernels.fused_template import (bitset_step,
                                                    bitset_step_plain)

    def abs_err(a, b):
        return int((u32.to_u64(a) - u32.to_u64(b)).abs().max())

    worst = 0
    for variant in ("rsbf", "bsbf", "bsbfsd", "rlbsbf"):
        cfg = DedupConfig.for_variant(variant, memory_bits=MEMORY_BITS,
                                      packed=True)
        # position s - 4000 puts rsbf's phase-1 -> phase-2 boundary inside
        # the batches
        state = random_state(cfg, rng, cfg.s - 4000)
        valid_all = np.ones(BATCH, bool)
        ragged = np.arange(BATCH) < 5000
        batches = [
            ("repeated keys", rng.integers(0, 300, BATCH), valid_all),
            ("ragged valid", rng.integers(0, 2 ** 32, BATCH), ragged),
            ("fresh keys", rng.integers(0, 2 ** 32, BATCH), valid_all),
        ]
        for label, keys, valid in batches:
            keys = keys.astype(np.uint32)
            rng_next, args = step_inputs(cfg, state, keys, valid)
            pos, rnd, v, seen, i_t = args
            words = state.bits.clone()
            dup, ins, load = bitset_step(cfg, words, pos, rnd, v, seen, i_t,
                                         state.load)
            new, dup_p, ins_p, load_p = bitset_step_plain(
                cfg, state.bits, pos, rnd, v, seen, i_t, state.load)
            torch.cuda.synchronize()
            diff = (words != new).sum().item()
            worst = max(worst, abs_err(words, new), abs_err(dup, dup_p),
                        abs_err(ins, ins_p), abs_err(load, load_p))
            ok = (diff == 0 and torch.equal(dup, dup_p)
                  and torch.equal(ins, ins_p) and torch.equal(load, load_p)
                  and torch.equal(load, packed.popcount(words)))
            n_ins = int(ins.sum())
            log(f"[bitset] {variant} k={cfg.k} s={cfg.s} {label}: "
                f"dup={int(dup.sum())} inserted={n_ins} "
                f"load={load.tolist()} words differing={diff} -> "
                f"{'exactly equal' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"bitset step != plain: {variant} "
                                     f"{label}")
            n_valid = int(v.sum())
            state = state._replace(bits=words, load=load, rng=rng_next,
                                   position=state.position + n_valid)
        del state, words, new
        torch.cuda.empty_cache()
    return worst


def phase_digests():
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Dedup, DedupConfig
    for name, want in PINNED_DIGESTS.items():
        cfg = DedupConfig.for_variant(name, memory_bits=1 << 14,
                                      batch_size=256, packed=True)
        # the digests were captured under JAX's original threefry layout
        eng = Dedup(cfg, "cuda", partitionable=False)
        state = eng.init()
        keys = np.random.RandomState(7).randint(0, 400, size=1024) \
            .astype(np.uint32)
        b = cfg.batch_size
        h = hashlib.sha256()
        for i in range(0, len(keys), b):
            valid = np.ones((b,), bool)
            if i + b >= len(keys):
                valid[b // 2:] = False
            state, res = eng.process(state, keys[i:i + b], valid)
            h.update(res.dup.cpu().numpy().tobytes())
            h.update(res.inserted.cpu().numpy().tobytes())
        leaves = state_to_numpy(state)
        for key in ("bits", "load", "position", "rng"):
            h.update(leaves[key].tobytes())
        got = h.hexdigest()[:16]
        log(f"[digest] {name}: {got} (pinned {want})")
        if got != want:
            raise AssertionError(f"pinned digest mismatch for {name}")


def phase_main_path():
    import torch
    from repro_torch.core import Dedup, DedupConfig, packed
    from repro_torch.data.streams import controlled_distinct_stream
    from repro_torch.dedup.metrics import fpr_fnr
    from repro_torch.kernels.fused_template import bitset_step
    from repro_torch.kernels.hashmix import hashmix
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=MEMORY_BITS,
                                  packed=True, batch_size=BATCH)
    t0 = time.perf_counter()
    keys, truth = controlled_distinct_stream(STREAM_N, DISTINCT_FRAC,
                                             seed=SEED)
    log(f"[main] stream of {STREAM_N} records ({DISTINCT_FRAC:.0%} distinct)"
        f" made in {time.perf_counter() - t0:.1f} s on the host")
    eng = Dedup(cfg)
    state = eng.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashmix.launches = 0
    bitset_step.launches = 0
    t0 = time.perf_counter()
    state, dup = eng.run_stream(state, keys)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"hashmix": hashmix.launches,
                "bitset_step": bitset_step.launches}
    peak = torch.cuda.max_memory_allocated()
    fpr, fnr = fpr_fnr(dup, truth)
    load = state.load.tolist()
    exact = torch.equal(state.load, packed.popcount(state.bits))
    log(f"[main] rlbsbf 256 MB k={cfg.k} s={cfg.s} batch={BATCH}: "
        f"{STREAM_N} elements in {secs:.4f} s = {STREAM_N / secs:.1f} "
        f"elements/s (host clock, ends in synchronize)")
    log(f"[main] FPR={fpr:.6g} FNR={fnr:.6g} load={load} "
        f"(fraction {sum(load) / (cfg.k * cfg.s):.6g}) "
        f"position={int(state.position)} load==popcount: {exact}")
    log(f"[main] kernel launches: {launches}; peak memory allocated "
        f"{peak / 2 ** 20:.1f} MiB")
    if not (dup.shape == (STREAM_N,) and exact
            and int(state.position) == STREAM_N + 1
            and 0.0 <= fpr < 0.05 and 0.0 <= fnr < 0.5):
        raise AssertionError("main path result out of bounds")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    return cfg, state, launches, secs


def bitset_step_bytes(cfg, words, pos, rnd, v, seen, i_t, load) -> int:
    """The bytes one bitset step must move on these inputs: each input it
    needs read once, each output written once, each filter word it must
    probe or update read once and each word it updates written once. What
    it needs depends on the data, so the decisions come from the plain
    decide: pos only for valid lanes, the variant's draws only where the
    decide reads them, del_pos only for enabled deletes."""
    import torch
    from repro_torch.core import batched, packed
    b, k = pos.shape
    decide = batched.make_decision_fn(cfg)
    _, ins, del_mask = decide(packed.probe_packed(words, pos), v, seen, i_t,
                              load, rnd)
    n_valid, n_ins = int(v.sum()), int(ins.sum())
    rows = torch.arange(k, device=pos.device)[None, :] * cfg.s_words
    probe_w = (rows + (pos.long() >> 5))[v].reshape(-1)
    del_w = (rows + (rnd.del_pos.long() >> 5))[del_mask]
    ins_w = (rows + (pos.long() >> 5))[ins].reshape(-1)
    # inserted words are probed words, so the probes and deletes cover reads
    n_read = torch.unique(torch.cat([probe_w, del_w])).numel()
    n_written = torch.unique(torch.cat([del_w, ins_w])).numel()
    draws = {"rsbf": 8 * n_valid,           # i_t and u_bern
             "bsbf": 0,
             "bsbfsd": 4 * n_ins,           # which
             "rlbsbf": 4 * k * n_ins}[cfg.variant]   # u_aux
    inputs = 4 * k * n_valid + 2 * b + 4 * k + 4 * int(del_mask.sum())
    outputs = 2 * b + 4 * k                 # dup, inserted, load
    return inputs + draws + outputs + 4 * (n_read + n_written)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the float32 rate outside the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, n: int, names=None):
    """Device time per call of ``fn(i)`` for i < n, from torch.profiler:
    the kernels whose names hold one of ``names``, or every device kernel
    when ``names`` is None. None when the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    total = sum(r.self_device_time_total for r in prof.key_averages()
                if str(getattr(r, "device_type", "")).endswith("CUDA")
                and (names is None or any(x in r.key for x in names)))
    return total / 1e3 / n if total > 0 else None


def wall_ms(fn, n: int) -> float:
    """Per call of ``fn(i)`` for i < n issued back to back, by CUDA events:
    the device time where the device is the bottleneck, the host's issue
    time (the Python wrapper included) where it is not."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed(make_run, n: int, names=None):
    """(ms per call, how it was measured): the profiler's device time, or,
    where the profiler saw no such kernel, CUDA events around calls issued
    back to back."""
    ms = device_ms(make_run(), n, names)
    if ms is not None:
        return ms, "device time, torch.profiler"
    return (wall_ms(make_run(), n), "CUDA events, host issue included: "
            "the profiler saw no such kernel")


def phase_timings(cfg, state, card):
    """Per-kernel device times on 16 fresh batches past the main stream,
    each launch on the filter the one before it left, as the stream runs:
    the kernels' own rows of a torch.profiler trace, the plain versions'
    device kernels on the same inputs, and the bound from what these
    batches need."""
    from repro_torch.core import hashing, u32
    from repro_torch.data.streams import controlled_distinct_stream
    from repro_torch.kernels.fused_template import (bitset_step,
                                                    bitset_step_plain)
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    n_b, k = 16, cfg.k
    more, _ = controlled_distinct_stream(n_b * BATCH, DISTINCT_FRAC,
                                         seed=SEED + 1)
    valid = np.ones(BATCH, bool)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, k), "cuda")
    keys = [u32.from_numpy_u32(more[i * BATCH:(i + 1) * BATCH], "cuda")
            for i in range(n_b)]
    inputs, nbytes = [], 0
    st = state._replace(bits=state.bits.clone())
    for i in range(n_b):
        rng, args = step_inputs(cfg, st, more[i * BATCH:(i + 1) * BATCH],
                                valid)
        nbytes += bitset_step_bytes(cfg, st.bits, *args, st.load)
        inputs.append(args)
        _, _, load = bitset_step(cfg, st.bits, *args, st.load)
        st = st._replace(position=st.position + BATCH, rng=rng, load=load)
    del st

    def hashmix_run():
        return lambda i: hashmix(keys[i], seeds, s=cfg.s)

    def hashmix_plain_run():
        return lambda i: hashmix_plain(keys[i], seeds, cfg.s)

    def step_run():
        words, load = state.bits.clone(), [state.load]

        def one(i):
            load[0] = bitset_step(cfg, words, *inputs[i], load[0])[2]
        return one

    def step_plain_run():
        words, load = [state.bits], [state.load]

        def one(i):
            words[0], _, _, load[0] = bitset_step_plain(cfg, words[0],
                                                        *inputs[i], load[0])
        return one

    bounds = {
        # 4 B per key in, 4 per seed, 4 per position out; ~10 integer
        # operations per (key, row): xor, three xor-shifts, two multiplies,
        # mask or modulo
        "hashmix": (4 * BATCH + 4 * k + 4 * BATCH * k, 10 * BATCH * k),
        # ~4 operations per probe, ~10 for the decision, ~4 per update
        "bitset_step": (nbytes / n_b, BATCH * (8 * k + 10)),
    }
    runs = {"hashmix": (hashmix_run, hashmix_plain_run, ("hashmix_kernel",)),
            "bitset_step": (step_run, step_plain_run,
                            ("probe_decide", "apply_deletes",
                             "apply_inserts"))}
    out = {}
    for name, (run, plain_run, kernels) in runs.items():
        run()(0)                                       # warm
        ms, how = timed(run, n_b, kernels)
        plain_ms, plain_how = timed(plain_run, n_b)
        through_wrapper = wall_ms(run(), n_b)
        bound_ms, bound_by = bound(*bounds[name])
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        log(f"[time] {name}: kernel {ms:.6f} ms per call ({how}); plain "
            f"version {plain_ms:.6f} ms per call ({plain_how}); bound "
            f"{bound_ms:.7f} ms by {bound_by}; through its wrapper, calls "
            f"back to back: {through_wrapper:.6f} ms per call (CUDA events; "
            f"{card})")
    return out


def phase_profile(cfg, state, card):
    """Where a main-path step's time goes: the host clock per call of the
    step's two plain-PyTorch pieces (each call synchronised; the kernels'
    times are the "time" phase's), then torch.profiler over 16 steps for
    the device's busy time, its kernel count and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Dedup, batched, u32
    from repro_torch.data.streams import controlled_distinct_stream
    n_b = 16
    keys, _ = controlled_distinct_stream(n_b * BATCH, DISTINCT_FRAC,
                                         seed=SEED + 2)
    eng = Dedup(cfg)
    st = state._replace(bits=state.bits.clone())
    kw = u32.from_numpy_u32(keys[:BATCH], "cuda")
    v = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    pieces = {
        "intra_batch_seen (sort join)":
            lambda: batched.intra_batch_seen(kw, v),
        "draw_randomness (threefry)":
            lambda: batched.draw_randomness(cfg, st.rng, BATCH),
    }
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_b):
            fn()
            torch.cuda.synchronize()
        log(f"[profile] piece {name}: "
            f"{(time.perf_counter() - t0) / n_b * 1e3:.4f} ms per call "
            f"(host clock, synchronised; {card})")
    eng.run_stream(st, keys[:BATCH])                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = eng.run_stream(st, keys)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_b * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, _ = eng.run_stream(st, keys)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev_rows = [r for r in rows if str(getattr(r, "device_type", "")).endswith(
        "CUDA") and getattr(r, "self_device_time_total", 0) > 0]
    busy = sum(r.self_device_time_total for r in dev_rows) / 1e3 / n_b
    n_kernels = sum(r.count for r in dev_rows) / n_b
    n_ops = sum(r.count for r in rows if r.key.startswith("aten::")) / n_b
    log(f"[profile] main-path step (rlbsbf 256 MB, batch {BATCH}): host "
        f"wall {wall:.4f} ms per step unprofiled; {n_ops:.1f} aten ops per "
        f"step on the host ({card})")
    if dev_rows:
        log(f"[profile] device busy {busy:.4f} ms per step in {n_kernels:.1f} "
            f"kernels; idle share {max(0.0, 1 - busy / wall):.4f} of the "
            f"unprofiled wall")
        ours = []
        for x in ("hashmix_kernel", "probe_decide", "apply_deletes",
                  "apply_inserts"):
            us = sum(r.self_device_time_total for r in dev_rows if x in r.key)
            ours.append(f"{x} {us / 1e3 / n_b:.6f} ms")
        log(f"[profile] the port's kernels per step in this trace: "
            f"{', '.join(ours)}")
        for r in sorted(dev_rows, key=lambda r: -r.self_device_time_total
                        )[:12]:
            log(f"[profile]   {r.self_device_time_total / 1e3 / n_b:9.4f} ms"
                f" /step  x{r.count / n_b:6.1f}  {r.key[:90]}")
    else:
        log("[profile] the profiler recorded no device time: device busy "
            "share not measured")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")
    rng = np.random.default_rng(SEED)
    err_hash = phase_hashmix(rng)
    err_step = phase_bitset(rng)
    phase_digests()
    cfg, state, launches, _ = phase_main_path()
    times = phase_timings(cfg, state, card)
    phase_profile(cfg, state, card)
    kernels = [
        dict(name="hashmix", route="cuda",
             source="src/repro_torch/kernels/csrc/hashmix.cu",
             replaces="src/repro/kernels/hashmix.py:46",
             launches=launches["hashmix"], max_abs_err=err_hash,
             library_ms=None, **times["hashmix"]),
        dict(name="bitset_step", route="cuda",
             source="src/repro_torch/kernels/csrc/bitset_step.cu",
             replaces="src/repro/kernels/fused_template.py:349",
             launches=launches["bitset_step"], max_abs_err=err_step,
             library_ms=None, **times["bitset_step"]),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
