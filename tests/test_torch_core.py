"""The port's ``core`` (repro_torch.core) against the reference's.

1. The symbolic layer (copies of the reference's pure-Python modules):
   every case of tests/test_passes.py, each a parametrised case run
   through both packages — ``count_passes``, ``analyze`` (passes,
   traversal generations, full-fiber tensors), ``min_live_footprint``
   and ``classify_passes`` equal field by field, and the case's own
   expectation held — plus ``table1`` and ``all_attention_cascades``.
2. The numeric layer (torch): ``attention_{3,2,1}pass``,
   ``attention_decode_1pass`` and ``reference_attention`` against
   ``repro.core.cascades_numeric`` on the same numpy-seeded inputs, at
   tests/test_cascades_numeric.py's tolerances (rtol 2e-4, atol 2e-5;
   the extreme-logit case rtol 1e-3, atol 1e-4), over its masking /
   softcap / window / block grid; ``division_counts`` equal.
3. ``repro_torch.core`` and ``repro_torch.analysis`` import without jax,
   and the two examples run at smoke size with ``--device cpu``.
"""
import dataclasses
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

import repro.core as jcore
import repro_torch.core as core

NUM_TOL = dict(rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# symbolic layer
# ---------------------------------------------------------------------------

def _machinery(pkg, which: str):
    """tests/test_passes.py's hand-built cascades, from ``pkg``'s IR."""
    Cascade, Einsum, T = pkg.Cascade, pkg.Einsum, pkg.T
    c = Cascade(which)
    if which == "chain":
        c.add(Einsum(T("Y"), (T("A", "K"),)))
        c.add(Einsum(T("Z"), (T("Y"), T("A", "K"))))
        c.add(Einsum(T("W"), (T("Z"), T("A", "K"))))
    elif which == "indep":
        c.add(Einsum(T("Y"), (T("A", "K"),)))
        c.add(Einsum(T("X"), (T("A", "K"), T("B", "K"))))
        c.add(Einsum(T("Z"), (T("Y"), T("X"))))
    elif which == "partial":
        c.partition("M", ("M1", "M0"))
        c.add(Einsum(T("X", "M1", "P"), (T("A", "M1", "M0"),)))
        c.add(Einsum(T("Z", "M1", "M0"),
                     (T("A", "M1", "M0"), T("X", "M1", "P"))))
    elif which == "bad":
        c.add(Einsum(T("Z"), (T("Y"),)))
        c.add(Einsum(T("Y"), (T("A", "K"),)))
    return c


def _build(pkg, builder: str, kw: dict):
    if builder.startswith("machinery:"):
        return _machinery(pkg, builder.split(":")[1])
    return getattr(pkg, builder)(**kw)


#: every case of tests/test_passes.py: (builder, kwargs, rank, passes,
#: tensors that must keep a full fiber live — None: not checked)
PASS_CASES = {
    "cascade1_is_two_pass": ("cascade1_two_pass_example", {}, "K", 2, None),
    "cascade2_deferral_is_one_pass": ("cascade2_deferred_multiply", {}, "K",
                                      1, None),
    "cascade3_iterative_is_one_pass": ("cascade3_iterative", {}, "K", 1,
                                       None),
    "cascade1_footprint_lower_bound": ("cascade1_two_pass_example", {}, "K",
                                       2, {"A"}),
    "cascade2_streams_everything": ("cascade2_deferred_multiply", {}, "K", 1,
                                    set()),
    "three_pass": ("attention_3pass_cascade", {}, "M", 3, None),
    "three_pass_with_deferral_becomes_two": (
        "attention_3pass_cascade", {"deferred_division": True}, "M", 2, None),
    "two_pass": ("attention_2pass_cascade", {}, "M", 2, None),
    "two_pass_eager_division_still_two": (
        "attention_2pass_cascade", {"deferred_division": False}, "M", 2,
        None),
    "one_pass": ("attention_1pass_cascade", {}, "M", 1, None),
    "one_pass_tile_level_is_two": ("attention_1pass_cascade", {}, "M0", 2,
                                   None),
    "footprints_explain_flat_buffering_3pass": (
        "attention_3pass_cascade", {}, "M", 3, {"QK", "SN"}),
    "footprints_explain_flat_buffering_1pass": (
        "attention_1pass_cascade", {}, "M", 1, set()),
    "two_pass_still_buffers_sln": ("attention_2pass_cascade", {}, "M", 2,
                                   {"SLN"}),
    "mlstm_natively_one_pass": ("mlstm_cascade", {}, "S", 1, None),
    "chained_reductions_accumulate": ("machinery:chain", {}, "K", 3, None),
    "independent_reductions_share_a_pass": ("machinery:indep", {}, "K", 1,
                                            None),
    "unrelated_rank_is_zero_passes": ("cascade1_two_pass_example", {}, "Q",
                                      0, None),
    "partition_coverage": ("machinery:partial", {}, "M", 1, None),
    "partition_coverage_tile_level": ("machinery:partial", {}, "M0", 2,
                                      None),
}


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_pass_analysis_matches_reference(case):
    builder, kw, rank, passes, full = PASS_CASES[case]
    port, ref = _build(core, builder, kw), _build(jcore, builder, kw)
    pa, ra = core.analyze(port, rank), jcore.analyze(ref, rank)
    assert pa.passes == ra.passes == passes
    assert pa.traversal_gens == ra.traversal_gens
    assert pa.full_fiber_tensors() == ra.full_fiber_tensors()
    if full is not None:
        if full == {"A"}:          # cascade 1: A full, B not (§III-B)
            fp = core.min_live_footprint(port, rank)
            assert fp["A"].full_fiber and not fp["B"].full_fiber
        else:
            assert full <= set(pa.full_fiber_tensors())
            if not full:
                assert pa.full_fiber_tensors() == frozenset()
    assert core.count_passes(port, rank) == jcore.count_passes(ref, rank)
    assert core.classify_passes(port, rank) \
        == jcore.classify_passes(ref, rank)
    pf = core.min_live_footprint(port, rank)
    rf = jcore.min_live_footprint(ref, rank)
    assert {k: dataclasses.astuple(v) for k, v in pf.items()} \
        == {k: dataclasses.astuple(v) for k, v in rf.items()}


def test_validation_rejects_use_before_def():
    for pkg in (core, jcore):
        with pytest.raises(Exception):
            pkg.count_passes(_machinery(pkg, "bad"), "K")


def test_table1_and_all_cascades_match_reference():
    from repro.core.taxonomy import table1 as jtable1
    from repro_torch.core.taxonomy import table1
    assert table1() == jtable1()
    port, ref = core.all_attention_cascades(), jcore.all_attention_cascades()
    assert list(port) == list(ref)
    for name in port:
        assert [dataclasses.astuple(e) for e in port[name].einsums] \
            == [dataclasses.astuple(e) for e in ref[name].einsums], name
        assert core.analyze(port[name], "M").passes \
            == jcore.analyze(ref[name], "M").passes


def test_core_imports_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import repro_torch.core, repro_torch.analysis.report
        import repro_torch.analysis.lint, repro_torch.analysis.accel_model
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# numeric layer
# ---------------------------------------------------------------------------

def _qkv(seed, b, h, p, m, e, f, q_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, p, e)).astype(np.float32) * q_scale,
            rng.standard_normal((b, h, m, e)).astype(np.float32),
            rng.standard_normal((b, h, m, f)).astype(np.float32))


def _both(fn_name, arrays, spec_kw, **kw):
    """(port, reference) outputs of ``fn_name`` on the same inputs."""
    port = getattr(core, fn_name)(*map(torch.from_numpy, arrays),
                                  core.AttnSpec(**spec_kw), **kw)
    ref = getattr(jcore, fn_name)(*map(jnp.asarray, arrays),
                                  jcore.AttnSpec(**spec_kw), **kw)
    return port.numpy(), np.asarray(ref)


#: tests/test_cascade_numeric.py's equivalence grid, fixed draws:
#: (seed, p, m_blocks, block, e, causal, softcap, window_frac)
EQUIV = [
    (0, 1, 1, 16, 8, False, None, None),
    (1, 7, 2, 32, 16, True, None, None),
    (2, 32, 4, 16, 32, True, 10.0, 0.5),
    (3, 64, 3, 64, 8, False, 50.0, 1.5),
    (4, 32, 2, 32, 16, True, None, 0.5),
    (5, 7, 4, 64, 32, False, 10.0, None),
]


@pytest.mark.parametrize("case", EQUIV, ids=[f"draw{c[0]}" for c in EQUIV])
@pytest.mark.parametrize("variant", ["3pass", "3pass_deferred", "2pass",
                                     "2pass_eager", "1pass", "reference"])
def test_cascades_match_reference(case, variant):
    seed, p, m_blocks, block, e, causal, softcap, window_frac = case
    m = m_blocks * block
    window = None if window_frac is None else max(1, int(m * window_frac))
    spec = dict(causal=causal, softcap=softcap, window=window)
    arrays = _qkv(seed, 1, 2, p, m, e, e)
    name, kw = {
        "3pass": ("attention_3pass", {}),
        "3pass_deferred": ("attention_3pass", {"deferred_division": True}),
        "2pass": ("attention_2pass", {"block": block}),
        "2pass_eager": ("attention_2pass", {"block": block,
                                            "deferred_division": False}),
        "1pass": ("attention_1pass", {"block": block}),
        "reference": ("reference_attention", {}),
    }[variant]
    port, ref = _both(name, arrays, spec, **kw)
    np.testing.assert_allclose(port, ref, **NUM_TOL)
    # and, as the reference's test holds it, to the 3-pass cascade
    three, _ = _both("attention_3pass", arrays, spec)
    np.testing.assert_allclose(port, three, **NUM_TOL)


@pytest.mark.parametrize("splits,m", [(1, 64), (2, 128), (4, 256), (8, 256)])
def test_decode_splitk_matches_reference(splits, m):
    arrays = _qkv(10 + splits, 2, 2, 1, m, 16, 16)
    port, ref = _both("attention_decode_1pass", arrays, {}, splits=splits)
    np.testing.assert_allclose(port, ref, **NUM_TOL)


def test_extreme_logits_match_reference():
    arrays = _qkv(0, 1, 1, 8, 64, 8, 8, q_scale=100.0)
    port, ref = _both("attention_1pass", arrays, {}, block=16)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=1e-3, atol=1e-4)


def test_q_offset_decode_window_matches_reference():
    arrays = _qkv(3, 1, 2, 1, 128, 16, 16)
    spec = dict(causal=True, window=32, q_offset=127)
    port, ref = _both("attention_1pass", arrays, spec, block=32)
    np.testing.assert_allclose(port, ref, **NUM_TOL)
    dec, _ = _both("attention_decode_1pass", arrays, spec, splits=4)
    np.testing.assert_allclose(dec, ref, **NUM_TOL)


def test_reference_attention_float64():
    """On float64 inputs the port's oracle stays in float64."""
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(7, 1, 2, 16, 64,
                                                          8, 8))
    out = core.reference_attention(q, k, v, core.AttnSpec(causal=True))
    assert out.dtype == torch.float64
    want = core.attention_3pass(q, k, v, core.AttnSpec(causal=True))
    assert torch.equal(out, want)


@pytest.mark.parametrize("m,p,f", [(1 << 20, 512, 64), (4096, 1, 128),
                                   (100, 3, 0)])
def test_division_counts_match_reference(m, p, f):
    assert core.division_counts(m, p, f) == jcore.division_counts(m, p, f)


@pytest.mark.parametrize("example,args", [
    ("torch_quickstart.py", ["--device", "cpu", "--steps", "2"]),
    ("torch_taxonomy_tour.py", ["--device", "cpu"]),
])
def test_example_runs_on_the_cpu(example, args):
    out = subprocess.run(
        [sys.executable, f"examples/{example}", *args], capture_output=True,
        text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    want = "quickstart OK" if "quickstart" in example \
        else "0 failure(s) across 8 declared cascades"
    assert want in out.stdout
