"""The bitset-family fused step — the port of
``repro/kernels/fused_template.py::_make_bitset_kernel_step``.

One function, two forms, same outputs bit for bit:

* ``bitset_step`` — the wrapper. On CUDA tensors it launches the
  hand-written kernel in ``csrc/bitset_step.cu`` (its note says what bounds
  it and how the design keeps the batch-entry snapshot on a concurrent
  card) or raises; on CPU tensors it runs ``bitset_step_plain``.
* ``bitset_step_plain`` — the plain PyTorch version, following the
  reference's jnp step (DESIGN §3.1/§3.2): probe, decide, sort the enabled
  positions, keep run heads, build the (k, W) deletion and insertion words
  with an int64 ``index_add_`` of distinct single-bit masks, apply
  ``(A & ~D) | I``, and take the load delta from the sorted positions. It
  shares none of the kernel's atomics logic, which is what makes it a
  check on the kernel.

Both update ``words`` in place and return ``(dup, inserted, load)``; the
caller computes hashes, the intra-batch join and the randomness first, as
the reference does outside its ``pallas_call``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import batched as _batched
from ..core import packed as _packed
from . import build

VARIANT_CODES = {"rsbf": 0, "bsbf": 1, "bsbfsd": 2, "rlbsbf": 3}


def bitset_step_plain(cfg, words, pos, rnd, valid, seen, i_t, load):
    """-> (new words (k, W), dup (B,), inserted (B,), load (k,))."""
    b, k = pos.shape
    w = words.shape[1]
    decide = _batched.make_decision_fn(cfg)
    vals = _packed.probe_packed(words, pos)
    dup, insert, del_mask = decide(vals, valid, seen, i_t, load, rnd)
    sentinel = 32 * w
    spi = _batched.sorted_enabled_positions(
        pos, insert[:, None].expand(b, k), sentinel)
    spd = _batched.sorted_enabled_positions(rnd.del_pos, del_mask, sentinel)
    delta_i = _packed.delta_from_sorted_positions(spi, w)
    delta_d = _packed.delta_from_sorted_positions(spd, w)
    new = (words & ~delta_d) | delta_i
    pre_i = _packed.probe_sorted_packed(words, spi)
    pre_d = _packed.probe_sorted_packed(words, spd)
    post_d = _packed.probe_sorted_packed(new, spd)
    new_load = load + _batched.load_delta_from_sorted(
        spi, pre_i, spd, pre_d, post_d, cfg.s)
    return new, dup, insert, new_load


def _check(cfg, words, pos, rnd, valid, seen, i_t, load):
    k, w = cfg.k, cfg.s_words
    b = pos.shape[0] if pos.dim() == 2 else -1
    want = {
        "words": (words, torch.int32, (k, w)),
        "pos": (pos, torch.int32, (b, k)),
        "del_pos": (rnd.del_pos, torch.int32, (b, k)),
        "u_bern": (rnd.u_bern, torch.float32, (b,)),
        "u_aux": (rnd.u_aux, torch.float32, (b, k)),
        "which": (rnd.which, torch.int32, (b,)),
        "valid": (valid, torch.bool, (b,)),
        "seen": (seen, torch.bool, (b,)),
        "i_t": (i_t, torch.int32, (b,)),
        "load": (load, torch.int32, (k,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"bitset_step: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != words.device:
            raise ValueError(f"bitset_step: {name} is on {t.device}, "
                             f"words on {words.device}")
        if not t.is_contiguous():
            raise ValueError(f"bitset_step: {name} must be contiguous")
    if cfg.variant not in VARIANT_CODES:
        raise ValueError(f"bitset_step runs {tuple(VARIANT_CODES)}, "
                         f"not {cfg.variant!r}")
    if not 1 <= k <= 32:
        raise ValueError(f"bitset_step takes 1 <= k <= 32, got {k}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("bitset_step").bitset_step_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   p, p, p, p, p, p, p, p, p, p, p, p, p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(cfg, words, pos, rnd, valid, seen, i_t, load, dup, ins,
            del_rows, load_out):
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _entry()(words.data_ptr(), words.shape[1], cfg.k, pos.shape[0],
             pos.data_ptr(), rnd.del_pos.data_ptr(), valid.data_ptr(),
             seen.data_ptr(), i_t.data_ptr(), rnd.u_bern.data_ptr(),
             rnd.u_aux.data_ptr(), rnd.which.data_ptr(), load.data_ptr(),
             load_out.data_ptr(), dup.data_ptr(), ins.data_ptr(),
             del_rows.data_ptr(), VARIANT_CODES[cfg.variant], cfg.s,
             float(np.float32(cfg.s)), float(np.float32(cfg.p_star)),
             stream)
    if err != 0:
        raise RuntimeError(f"bitset_step kernel launch failed: CUDA error "
                           f"{err}")


def bitset_step(cfg, words, pos, rnd, valid, seen, i_t, load):
    """One bitset-family step on the (k, W) int32 ``words``, updated in
    place. pos (B, k) int32 positions; ``rnd`` the step's
    ``BatchRandomness``; valid/seen (B,) bool; i_t (B,) int32 stream
    positions; load (k,) int32 batch-entry load. Returns (dup (B,) bool,
    inserted (B,) bool, load (k,) int32). ``bitset_step.launches`` counts
    kernel launches: one per step, three grid launches each."""
    _check(cfg, words, pos, rnd, valid, seen, i_t, load)
    if words.device.type == "cpu":
        new, dup, ins, new_load = bitset_step_plain(
            cfg, words, pos, rnd, valid, seen, i_t, load)
        words.copy_(new)
        return dup, ins, new_load
    if words.device.type != "cuda":
        raise ValueError(f"bitset_step runs on cpu or cuda, not "
                         f"{words.device}")
    b = pos.shape[0]
    dup = torch.empty((b,), dtype=torch.bool, device=words.device)
    ins = torch.empty((b,), dtype=torch.bool, device=words.device)
    del_rows = torch.empty((b,), dtype=torch.int32, device=words.device)
    load_out = load.clone()
    _launch(cfg, words, pos, rnd, valid, seen, i_t, load, dup, ins,
            del_rows, load_out)
    bitset_step.launches += 1
    return dup, ins, load_out


bitset_step.launches = 0
