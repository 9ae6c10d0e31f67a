"""The probe suite (ropebwt2_tpu_torch.probes) on the CPU: the plain
versions of its kernels against the JAX package's functions and the TPU
probe scripts' own numpy constructions, on the same numpy-seeded inputs;
its byte models; its refusal to run without a card; the split steps of
kernel A's wrapper; and the build's library hashes.

Every comparison is exact (integers)."""

import hashlib
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu.index import merge_pallas as mp
from ropebwt2_tpu.index import packed as jpacked

from ropebwt2_tpu_torch import _build
from ropebwt2_tpu_torch.index import merge_cuda
from ropebwt2_tpu_torch.index.flat import PAD_TAIL, table_dtype
from ropebwt2_tpu_torch.probes import (
    _timing, kernel_features, kernel_scaling, kernel_stages, merge_phases,
    warmup_build,
)

ROWS, WROWS, SUPER, STACK_ROWS = mp._geom(mp.B)  # 32, 40, 32, 1280
BS = mp.B


def script_inputs(seed=0):
    """scripts/probe_kernel_stages.py's data: old (SWROWS, 128) symbols,
    an insertion map (SROWS, 128) at 1% density."""
    rng = np.random.default_rng(seed)
    old = rng.integers(0, 6, (mp.SWROWS, mp.LANE)).astype(np.int8)
    ins = (rng.random((mp.SROWS, mp.LANE)) < 0.01).astype(np.int8) * (
        rng.integers(0, 6, (mp.SROWS, mp.LANE)).astype(np.int8) + 1)
    return old, ins


def test_window_matches_align_windows():
    """Stage (a)'s window old[o0 : o0 + 4096] against the TPU stage
    stack+align: 8-row-aligned windows shifted left by their remainder."""
    rng = np.random.default_rng(1)
    old = rng.integers(0, 6, 40 * BS).astype(np.int8)
    o0 = np.sort(rng.integers(0, 36 * BS, SUPER))
    o0[:3] = [0, 1, 1023]  # remainders at the edges
    r0 = (o0 // mp.LANE) & ~7  # the aligned row each window starts at
    rows = old.reshape(-1, mp.LANE)
    stack = np.concatenate([rows[r: r + WROWS] for r in r0])
    rem = np.repeat(o0 - r0 * mp.LANE, WROWS)[:, None].astype(np.int32)
    got = np.asarray(mp._align_windows(jnp.asarray(stack), jnp.asarray(rem)))
    jax_win = got.reshape(SUPER, WROWS * mp.LANE)[:, :BS]
    want = kernel_stages.window_plain(torch.from_numpy(old),
                                      torch.from_numpy(o0))
    assert np.array_equal(want.numpy(), jax_win)


def test_scan_matches_seg_flat_prefix():
    _, ins = script_inputs(2)
    flags = jnp.asarray((ins != 0).astype(np.int32))
    jax_c = np.asarray(mp._seg_flat_prefix(flags, ROWS)).reshape(SUPER, BS)
    got = kernel_stages.scan_plain(torch.from_numpy(ins.reshape(-1)), SUPER)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), jax_c)


def test_gather_matches_expand():
    """Stage (c): the window of every block with its insertions applied,
    against the TPU stage expand on the same aligned windows."""
    rng = np.random.default_rng(3)
    _, ins = script_inputs(3)
    old = rng.integers(0, 6, SUPER * BS + BS).astype(np.int8)
    o0 = np.arange(SUPER, dtype=np.int64) * BS + rng.integers(0, 64, SUPER)
    win = kernel_stages.window_plain(torch.from_numpy(old),
                                     torch.from_numpy(o0))
    aligned = jnp.asarray(win.numpy().reshape(mp.SROWS, mp.LANE))
    jax_out = np.asarray(mp._expand(jnp.asarray(ins.astype(np.int32)),
                                    aligned, ROWS))
    got = kernel_stages.gather_plain(torch.from_numpy(old),
                                     torch.from_numpy(o0),
                                     torch.from_numpy(ins.reshape(-1)))
    assert np.array_equal(got.numpy().reshape(mp.SROWS, mp.LANE), jax_out)


@pytest.mark.parametrize("fn", [kernel_stages.counts_plain,
                                kernel_features.simd_count_plain])
def test_counts_match_one_hot(fn):
    """Stage (d)'s counts and the SIMD count's plain version against a
    numpy one-hot count (PAD counts as no symbol)."""
    sym = np.random.default_rng(4).integers(0, 7, 8 * BS).astype(np.int8)
    want = (sym.reshape(-1, mp.LANE, 1) == np.arange(6)).sum(1)
    got = fn(torch.from_numpy(sym))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("stage", kernel_stages.STAGES)
def test_stage_wrappers_run_their_plain_version_on_the_cpu(stage):
    d = kernel_stages.make_inputs(3, 5, "cpu")
    before = dict(kernel_stages.LAUNCHES)
    got = kernel_stages.run_stage(stage, d)
    assert torch.equal(got, kernel_stages.PLAIN[stage](d))
    assert kernel_stages.LAUNCHES == before


def test_insertion_map_and_prefix_match_the_script():
    """F's insertion map and block prefix against the numpy construction
    of scripts/probe_merge_tpu.py:120-125 (cap cut to 2^18)."""
    cap, m = 1 << 18, 1 << 12
    rng = np.random.default_rng(0)
    n0 = cap // 2
    pos = np.sort(rng.integers(0, n0, m))
    sym = rng.integers(0, 6, m)
    stream = np.arange(m)
    insmap_np = np.zeros(cap, np.int8)
    insmap_np[pos + stream] = sym + 1
    start_np = np.searchsorted(pos + stream, np.arange(cap // BS + 1) * BS)

    nb = -(-(cap + PAD_TAIL) // BS)
    t = [torch.from_numpy(x) for x in (pos, sym, stream)]
    dest, insmap = merge_cuda.insertion_map(
        *t, torch.ones(m, dtype=torch.bool), nb)
    start = merge_cuda.block_prefix(dest, nb)
    assert np.array_equal(insmap[:cap].numpy(), insmap_np)
    assert not insmap[cap:].any()
    assert np.array_equal(start[: cap // BS + 1].numpy(), start_np)
    assert int(start[nb]) == m


@pytest.mark.parametrize("K,n_frac,dense", [(128, 0.5, False),
                                            (256, 0.5, False),
                                            (128, 0.98, True)])
def test_split_merge_steps_compose_to_merge(K, n_frac, dense):
    """merge()'s four steps (insertion_map, block_prefix, run_kernel with
    the kernel's plain version merge_blocks, tables) equal merge() on the
    CPU on the live prefix and its table rows."""
    cap, m = 1 << 18, 1 << 12
    n = int(cap * n_frac) - m
    bwt, pos, sym, stream, valid, nt = merge_phases.lanes(cap, m, n, 6,
                                                          "cpu")
    if dense:
        pos[: m // 2] = n // 3
        pos = torch.sort(pos).values
        valid[-100:] = False
    want, want_t = merge_cuda.merge(bwt, pos, sym, stream, valid, nt, K)
    got, got_t = merge_phases.composed(bwt, pos, sym, stream, valid, nt, K)
    live = n + int(valid.sum())
    assert got_t.dtype == want_t.dtype == table_dtype(cap)
    assert torch.equal(got[:live], want[:live])
    assert torch.equal(got_t[: live // K + 1], want_t[: live // K + 1])


def test_merge_blocks_zero_rows_past_the_live_prefix():
    cap, m, n = 1 << 16, 64, 9000
    bwt, pos, sym, stream, valid, nt = merge_phases.lanes(cap, m, n, 8, "cpu")
    nb = -(-bwt.shape[0] // BS)
    dest, insmap = merge_cuda.insertion_map(pos, sym, stream, valid, nb)
    out, rows = merge_cuda.run_kernel(bwt, insmap,
                                      merge_cuda.block_prefix(dest, nb), nt)
    assert out.shape == bwt.shape and rows.shape == (nb * 32, 6)
    live_ctas = -(-(n + m) // BS)
    assert not rows[live_ctas * 32:].any()
    assert int(rows[: (n + m) // 128].sum()) == (n + m) // 128 * 128


def test_nibble_plain_matches_the_jax_layout():
    """G's plain nibble unpack of windows at any symbol offset, and its
    repack, against ropebwt2_tpu.index.packed's numpy layout."""
    rng = np.random.default_rng(9)
    syms = rng.integers(0, 7, 16 * BS).astype(np.int8)
    packed = jpacked.pack_bwt_np(syms)
    o0 = np.array([0, 129, 4096 + 7, 5 * BS + 255, 14 * BS - 16])
    win, rep = kernel_features.nibble_plain(torch.from_numpy(packed),
                                            torch.from_numpy(o0))
    flat = jpacked.unpack_bwt_np(packed)
    for i, o in enumerate(o0):
        assert np.array_equal(win[i].numpy(), flat[o: o + BS])
        assert np.array_equal(rep[i].numpy(),
                              jpacked.pack_bwt_np(flat[o: o + BS]))


def test_window_feature_plain_versions():
    """The staging kernels' plain version, the cluster swap and the
    dynamic-shared-memory reversal against numpy."""
    old, o0 = kernel_features.inputs("tma", "tiny", "cpu", 3)
    padded = np.concatenate([old.numpy(), np.full(BS, 6, np.int8)])
    want = np.stack([padded[o: o + BS] for o in o0.numpy()])
    assert (want[-1] == 6).any()  # the last window runs past the buffer
    for name in kernel_features.WINDOW_KERNELS:
        assert np.array_equal(kernel_features.run(name, old, o0).numpy(),
                              want)
    assert int(o0[0]) % 16
    (x,) = kernel_features.inputs("cluster", "tiny", "cpu", 3)
    xs = x.numpy().reshape(-1, 2, BS)
    assert np.array_equal(kernel_features.run("cluster", x).numpy(),
                          xs[:, ::-1].reshape(-1))
    (x,) = kernel_features.inputs("dynsmem", "tiny", "cpu", 3)
    xs = x.numpy().reshape(-1, kernel_features.DYN_BYTES)
    assert np.array_equal(kernel_features.run("dynsmem", x).numpy(),
                          xs[:, ::-1].reshape(-1))
    assert kernel_features.DYN_BYTES > 48 << 10


def test_byte_models_at_the_chip_smoke_shapes():
    """Kernels A, B and C's byte models at chip_smoke.py's shapes, derived
    again from what each reads and writes."""
    cap, m = 1 << 24, 1 << 17
    n = cap - m - 4097
    alloc = cap + PAD_TAIL
    live = n + m
    na = -(-live // BS)  # count rows of the live CTAs only
    want_a = n + live + live + na * 32 * 24 + 8 * (na + 2)
    assert _timing.merge_bytes(n, m, alloc) == want_a
    # the script's nsb 1 shape: 32 live CTAs of 4097, their rows only
    assert _timing.merge_bytes(131_072, 0, alloc) == \
        3 * 131_072 + 32 * 32 * 24 + 8 * 34
    # flush shape: ~0.47 GB, ~0.14 ms
    f = 147_062_784
    a = _timing.merge_bytes(f - (1 << 20) - 12345, 1 << 20, f + PAD_TAIL)
    assert 0.46e9 < a < 0.48e9
    assert 0.13 < _timing.bound_ms(a) < 0.15
    # kernel C at the capacity flush: 2.25 G symbols at 1.5 B + counts
    c = 2_246_049_792
    pc = _timing.merge_packed_bytes(c - (1 << 24) - 12345, 6 << 20,
                                    c // 2 + 16 * 128)
    live_c = c - (1 << 24) - 12345 + (6 << 20)
    assert pc == (-(-(c - (1 << 24) - 12345) // 2) + 2 * -(-live_c // 2)
                  + 8 * (-(-live_c // BS) + 2) + -(-live_c // BS) * 32 * 24)
    assert 1.0 < _timing.bound_ms(pc) < 1.2
    # kernel B: both planes of the live rows, not the INF/PAD tail
    pcap, p_after, new = 1 << 20, (1 << 20) * 3 // 10 + (1 << 17), 1 << 17
    nap = -(-p_after // BS)
    assert _timing.pending_bytes(pcap, p_after, new) == (
        9 * (p_after - new) + p_after + 8 * new + 8 * (nap + 2)
        + 9 * p_after + nap * 32 * 24)
    # the capacity path's shape, half full: ~0.18 GB, ~0.054 ms
    b = _timing.pending_bytes(1 << 24, (1 << 23) + (1 << 20), 1 << 20)
    assert 0.050 < _timing.bound_ms(b) < 0.056
    # the four stages add up to kernel A with every CTA live
    g = 1056
    assert sum(_timing.stage_bytes(s, g) for s in kernel_stages.STAGES) \
        == g * (3 * BS + 32 * 24)
    assert _timing.share(_timing.bound_ms(a), 2 * _timing.bound_ms(a)) \
        == pytest.approx(0.5)


def test_stage_bound_is_the_on_chip_bytes_of_a_pass():
    """A looped stage's bound per pass: its bytes through L1 and shared
    memory at 132 x 128 B a clock x 1.98 GHz, above a launch's HBM bytes
    shared by 3000 passes; below the HBM time of its bytes in kernel A
    for the stages that move 4096 bytes a CTA in kernel A."""
    g, iters = 1056, kernel_stages.ITERS
    rate = 132 * 128 * 1.98e9
    want = {"window": 2 * BS, "scan": BS, "gather": 2 * BS,
            "counts": 32 * 24}
    for stage, per_cta in want.items():
        got = _timing.stage_bound_ms(stage, g, iters)
        assert got == pytest.approx(g * per_cta / rate * 1e3)
        assert got > _timing.bound_ms(g * 6 * BS) / iters
    for stage in ("window", "scan", "gather"):
        assert _timing.stage_bound_ms(stage, g, iters) < \
            _timing.bound_ms(_timing.stage_bytes(stage, g))
    # one pass: the launch's HBM bytes dominate
    assert _timing.stage_bound_ms("scan", g, 1) == pytest.approx(
        _timing.bound_ms(g * (5 * BS + 4 * 256)))


def test_kernel_scaling_cases_are_the_scripts():
    cases = kernel_scaling.cases()
    assert [c[2] for c in cases[:-1]] == [k * 131_072 for k in
                                          (1, 8, 32, 65, 128)]
    assert all(c[1] == 1 << 24 and c[3] == 0 for c in cases[:-1])
    label, cap, n, m = cases[-1]
    assert (cap, m) == (147_062_784, 1 << 20) and n + m < cap


def test_feature_measure_holds_the_timing_shape(monkeypatch):
    """G's measure compares each kernel with its plain version on the very
    inputs it times (here the tiny ones, on the CPU), and reports the
    error."""
    monkeypatch.setattr(kernel_features, "compiled", lambda name: None)
    tiny = kernel_features.inputs
    monkeypatch.setattr(kernel_features, "inputs",
                        lambda name, scale, device, seed=0:
                        tiny(name, "tiny", device, seed))
    monkeypatch.setattr(_timing, "graph_ms", lambda fn, *a, **k: 1.0)
    monkeypatch.setattr(_timing, "event_ms", lambda fn, *a, **k: 2.0)
    out = kernel_features.measure(say=lambda *a: None, device="cpu")
    assert set(out) == set(kernel_features.KERNELS)
    assert all(r["err"] == 0 for r in out.values())
    plain = kernel_features._plain

    def wrong(name, *args):  # a kernel that disagrees at the timing shape
        got = plain(name, *args)
        return tuple(g + 1 for g in got) if isinstance(got, tuple) else got + 1

    monkeypatch.setattr(kernel_features, "run", wrong)
    out = kernel_features.measure(say=lambda *a: None, device="cpu",
                                  names=("tma", "nibble"))
    assert [r["err"] for r in out.values()] == [1, 1]


def test_toy_plain_on_the_cpu():
    x = torch.arange(8 * 128, dtype=torch.int32).view(8, 128) - 300
    assert torch.equal(warmup_build.toy(x), x * 2 + 1)
    assert warmup_build.LAUNCHES == 0


@pytest.mark.parametrize("probe", [kernel_scaling, merge_phases,
                                   kernel_stages, warmup_build,
                                   kernel_features])
def test_probes_refuse_to_run_without_a_card(probe, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = probe.main([]) if probe is warmup_build else probe.main()
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err


def _old_main_hash(csrc):
    h = hashlib.sha256(" ".join(_build.FLAGS).encode())
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return f"librb2_{h.hexdigest()[:16]}.so"


def test_main_library_path_ignores_the_probe_sources(tmp_path, monkeypatch):
    """The main library keeps its name and hash (csrc/*.cu and *.cuh
    only); a change under csrc/probes/ moves the probe library's hash and
    not the main one's."""
    assert _build.library_path().name == _old_main_hash(_build.CSRC)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "PROBE_SRC", csrc / "probes")
    main, probes = _build.library_path(), _build.library_path("probes")
    (csrc / "probes" / "stages.cu").write_text("// changed\n")
    (csrc / "probes" / "extra.cuh").write_text("// new\n")
    assert _build.library_path() == main
    changed = _build.library_path("probes")
    assert changed != probes
    assert _build.library_path(build_dir=tmp_path).parent == tmp_path
    (csrc / "common.cuh").write_text("// changed\n")  # probes include it
    assert _build.library_path("probes") != changed


def test_probe_library_units():
    """Every probe source but the toy kernel is a unit of the probe
    library, and the toy kernel is the toy library's one unit; only the
    feature sections may fail."""
    spec = _build.LIBRARIES["probes"]()
    names = [u.name for u in spec.units]
    assert names[:2] == ["stages", "features_0"]
    assert [u.optional for u in spec.units] == [False] * 2 + [True] * 6
    (toy,) = _build.LIBRARIES["toy"]().units
    assert toy.source.name == "toy.cu" and not toy.optional
    assert set(toy.entry_points) == {"rb2_toy"}
    assert all(u.source.exists() for u in spec.units)
    entry = {fn for u in spec.units for fn in u.entry_points}
    assert {f"rb2_stage_{s}" for s in kernel_stages.STAGES} <= entry
    assert set(kernel_features._ENTRY.values()) <= entry
