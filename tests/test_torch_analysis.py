"""The port's cascade analyzer and structural check (repro_torch.analysis)
against the reference's, mirroring tests/test_analysis.py.

1. The registry: the reference's eight entries — names, expected passes,
   footprints, buckets, peers, the declared cascades Einsum by Einsum —
   and their taxonomy classification.
2. The gate: ``check()`` returns 0 on the plain versions; a misdeclared
   entry fails it, and ``python -m repro_torch.analysis.report --check``
   exits non-zero under ``REPRO_TORCH_ANALYSIS_INJECT_BAD``.
3. The structural probes (``repro_torch.analysis.lint``): every probe
   passes on the plain versions (on the CPU, ``impl="torch"``); a plain
   decode that sweeps one split twice, one that skips a tile, a paged
   decode that reads a wrong page and a launch whose shared memory grows
   with M are rejected.  The kernels themselves are probed on the card
   by ``chip_smoke.py``'s ``analysis`` phase.
4. ``accel_model``: equal to the reference's for every design, workload
   and M that tests/test_accel_model.py uses.
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.analysis import accel_model as jaccel
from repro.analysis import cascade as jcascade
from repro_torch.analysis import accel_model, lint
from repro_torch.analysis import passes as ap
from repro_torch.analysis import report
from repro_torch.analysis.cascade import (
    O1, OS, REGISTRY, CascadeEntry, entry, op_cascade,
)
from repro_torch.core.taxonomy import attention_3pass
from repro_torch.kernels import decode as dec
from repro_torch.kernels.ops import KERNEL_CASCADES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the registry and its classification
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert [e.name for e in REGISTRY] == [e.name for e in jcascade.REGISTRY]
    for port, ref in zip(REGISTRY, jcascade.REGISTRY):
        for f in ("expected_passes", "footprint", "bucket", "rank", "peers"):
            assert getattr(port, f) == getattr(ref, f), (port.name, f)
        pc, rc = port.build(), ref.build()
        assert pc.name == rc.name
        assert [dataclasses.astuple(e) for e in pc.einsums] \
            == [dataclasses.astuple(e) for e in rc.einsums], port.name
        assert pc.partitions == rc.partitions
        # every probe the entry names exists, and so does each site
        assert port.lint and all(k in lint.PROBES for k in port.lint)
        for site in port.kernels:
            path = os.path.join(ROOT, "src", "repro_torch",
                                site.split("::")[0])
            assert os.path.exists(path), site


def test_reference_classifies_3pass_os():
    r = ap.analyze_entry(entry("reference-3pass"))
    assert r["passes"] == 3 and r["footprint"] == OS and r["ok"]
    assert set(r["full_fiber_tensors"]) == {"QK", "SN"}


def test_fusemax_2pass_classifies_2pass_os():
    r = ap.analyze_entry(entry("fusemax-2pass"))
    assert r["passes"] == 2 and r["footprint"] == OS and r["ok"]
    assert r["full_fiber_tensors"]


def test_online_1pass_classifies_1pass_o1():
    r = ap.analyze_entry(entry("fusemax-prefill-1pass"))
    assert r["passes"] == 1 and r["footprint"] == O1 and r["ok"]
    assert r["full_fiber_tensors"] == []


def test_every_paged_decode_cascade_is_s_independent():
    paged = [e for e in REGISTRY if "decode" in e.name or "verify" in e.name]
    assert len(paged) >= 4
    for e in paged:
        r = ap.analyze_entry(e)
        assert r["passes"] == 1 and r["footprint"] == O1, (e.name, r)
        assert r["full_fiber_tensors"] == [], (e.name, r)


def test_registry_consistent_and_kernel_cascades_valid():
    assert ap.full_report() and all(r["ok"] for r in ap.full_report())
    for op in KERNEL_CASCADES:
        op_cascade(op).validate()
    table = ap.taxonomy_table()
    assert "reference-3pass" in table and "O(1)" in table


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def _bad_entry():
    return CascadeEntry(name="bad-1pass-claim", build=attention_3pass,
                        expected_passes=1, footprint=O1, bucket="1-pass")


def test_check_passes_on_the_plain_versions():
    assert report.check(out=open(os.devnull, "w")) == 0


def test_check_fails_on_misdeclared_entry():
    r = ap.analyze_entry(_bad_entry())
    assert not r["ok"]
    assert any("proves 3 passes" in p for p in r["problems"])
    assert report.check(entries=[_bad_entry()], structural=False,
                        out=open(os.devnull, "w")) > 0


def test_report_check_cli_exits_nonzero_on_misdeclaration():
    env = dict(os.environ, REPRO_TORCH_ANALYSIS_INJECT_BAD="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.analysis.report", "--check",
           "--impl", "torch"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "injected-bad-1pass-claim" in proc.stdout
    # without the hook the CLI gate passes
    del env["REPRO_TORCH_ANALYSIS_INJECT_BAD"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for key in lint.TRACE_PROBES:
        assert f"{key} (traced plain," in proc.stdout, key


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env


def test_report_check_cli_without_impl_needs_a_card():
    """``--check`` probes the kernels unless asked for the plain versions:
    on a host without a card it exits non-zero and says how."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --check probes its kernels")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.report", "--check"],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "--impl torch" in proc.stderr
    assert "cascade check" not in proc.stdout


def test_check_prints_every_trace_probe(monkeypatch):
    import io
    buf = io.StringIO()
    assert report.check(impl="torch", out=buf) == 0
    lines = buf.getvalue().splitlines()
    for key, fn in lint.TRACE_PROBES.items():
        passes = fn(None, "torch")["passes"]
        assert any(line.startswith("  ok  ") and f"{key} (traced plain, "
                   f"{passes}-pass)" in line for line in lines), key
    # the self-test still fails the gate
    monkeypatch.setenv(report.INJECT_BAD_ENV, "1")
    buf = io.StringIO()
    assert report.check(impl="torch", out=buf) > 0
    assert "FAIL  injected-bad-1pass-claim" in buf.getvalue()


def _dryrun_record(arch, shape, ok=True):
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": "single", "ok": False,
                "error": "RuntimeError: synthetic failure"}
    return {
        "arch": arch, "shape": shape, "mesh": "single", "chips": 256,
        "ok": True, "card": "NVIDIA H100 80GB HBM3",
        "memory": {"param_bytes": 3 * 2 ** 30, "peak_bytes_est": 5e10,
                   "fits": True},
        "cost": {"flops": 1.5e14, "bytes_accessed": 4e10},
        "collectives": {"bytes_by_kind": {"all_gather": 2e9,
                                          "reduce_scatter": 1e9},
                        "total_bytes": 3e9}}


def _roofline_record(arch, shape, ok=True, dominant="compute"):
    if not ok:
        return {"arch": arch, "shape": shape, "ok": False,
                "error": "KeyError: synthetic failure"}
    return {"arch": arch, "shape": shape, "ok": True,
            "card": "NVIDIA H100 80GB HBM3",
            "roofline": {"compute_s": 0.25, "memory_s": 0.002,
                         "collective_s": 3e-5, "dominant": dominant,
                         "model_flops_per_chip": 1.2e14,
                         "useful_ratio": 0.8, "roofline_fraction": 0.48}}


def test_report_tables_read_the_dry_run_records(tmp_path, monkeypatch):
    import json
    cells = [("alpha-1b", "train_4k", True), ("beta-2b", "decode_32k", True),
             ("gamma-3b", "prefill_32k", False)]
    for sub, make in (("single", _dryrun_record),
                      ("roofline", _roofline_record)):
        (tmp_path / sub).mkdir()
        for arch, shape, ok in cells:
            (tmp_path / sub / f"{arch}__{shape}.json").write_text(
                json.dumps(make(arch, shape, ok)))
    env = dict(_env(), REPRO_TORCH_DRYRUN_OUT=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.report"], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    dry = out[out.index("§Dry-run"):out.index("§Roofline")]
    roof = out[out.index("§Roofline"):out.index("§Einsum")]
    for table in (dry, roof):
        assert "NVIDIA H100 80GB HBM3" in table
        rows = [ln for ln in table.splitlines() if ln.startswith("| ")
                and not ln.startswith("| arch")]
        assert [r.split(" | ")[0][2:] for r in rows] == [
            "alpha-1b", "beta-2b", "gamma-3b"], table
        assert "FAILED: " in rows[2] and "synthetic failure" in rows[2]
        assert "FAILED" not in rows[0] + rows[1]
    assert "2.8GB (all_gather)" in dry
    assert "**compute**" in roof and "250.00ms" in roof
    assert "reference-3pass" in out[out.index("§Einsum"):]

    monkeypatch.setenv("REPRO_TORCH_DRYRUN_OUT", str(tmp_path))
    summary = report.summarize()
    assert set(summary) == {("alpha-1b", "train_4k"),
                            ("beta-2b", "decode_32k")}
    assert summary[("alpha-1b", "train_4k")]["dominant"] == "compute"


def test_unknown_probe_fails_the_entry():
    bad = dataclasses.replace(entry("decode-splitk-1pass"),
                              lint=("no_such_probe",))
    (r,) = lint.lint_all([bad])
    assert not r["ok"] and "not implemented" in r["error"]


# ---------------------------------------------------------------------------
# the structural probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(lint.PROBES))
def test_probe_passes_on_plain_version(key):
    res = lint.PROBES[key](None, "torch")
    assert res["cases"]
    # K1's count is exp(lse) of an fp32 log-sum-exp: gated at 0.5
    count_tol = 1e-3 if key == "prefill" else 0.0
    for c in res["cases"]:
        assert c.get("max_count_err", 0.0) <= count_tol, c
        assert c.get("max_sum_err", 0.0) == 0.0, c


@pytest.mark.parametrize("key", ["prefill", "decode", "mla_decode_paged"])
def test_probe_passes_under_exp_maccs(key):
    lint.PROBES[key](None, "torch", exp_impl="maccs")


def test_probes_refuse_an_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        lint.PROBES["decode"](None, "pallas")


def _sweeps_split_twice(q, k, v, kv_len, **kw):
    """The plain partials, then split 0 swept a second time, continuing
    its running state (Eqs. 48-52)."""
    pm, pl, pnv = (t.clone() for t in dec.decode_partials_torch(
        q, k, v, kv_len, **kw))
    m2, l2, a2 = dec.decode_partials_torch(q, k, v, kv_len, split_first=0,
                                           n_splits=1, **kw)
    m_new = torch.maximum(pm[:, :1], m2)
    c1, c2 = torch.exp(pm[:, :1] - m_new), torch.exp(m2 - m_new)
    pl[:, :1] = pl[:, :1] * c1 + l2 * c2
    pnv[:, :1] = pnv[:, :1] * c1[..., None] + a2 * c2[..., None]
    pm[:, :1] = m_new
    return pm, pl, pnv


def _skips_first_tile(q, k, v, kv_len, *, scale, softcap, window, hkv,
                      splits, block_k, exp_impl, n_pos, rows_per_pos):
    """The plain sweep with every split starting at its second tile."""
    bh, _, e = q.shape
    m, f = v.shape[1], v.shape[2]
    split_len = m // splits
    k4 = k.reshape(bh, splits, split_len, e)
    v4 = v.reshape(bh, splits, split_len, f)

    def tiles(t):
        sl = slice((t + 1) * block_k, (t + 2) * block_k)
        return k4[:, :, sl], v4[:, :, sl]

    return dec._sweep_partials(
        q, tiles, split_len // block_k - 1,
        kv_len.long().repeat_interleave(hkv),
        torch.arange(splits) * split_len + block_k, scale=scale,
        softcap=softcap, window=window, block_k=block_k, exp_impl=exp_impl,
        n_pos=n_pos, rows_per_pos=rows_per_pos, f=f)


@pytest.mark.parametrize("fn,match", [(_sweeps_split_twice, "re-read"),
                                      (_skips_first_tile, "gap")],
                         ids=["split_swept_twice", "tile_skipped"])
def test_probe_rejects_a_second_sweep_and_a_gap(fn, match):
    with pytest.raises(lint.LintError, match=match):
        lint.probe_decode(None, "torch", fn=fn)
    with pytest.raises(lint.LintError, match=match):
        lint.probe_decode(None, "torch", fn=fn, n_pos=3)


def test_probe_rejects_a_wrong_page():
    """A paged decode that reads sequence 0's first and last pages swapped
    (two splits apart) visits the right number of keys at the wrong
    positions."""
    def swapped(q, k_pages, v_pages, table, kv_len, **kw):
        table = table.clone()
        table[0, [0, -1]] = table[0, [-1, 0]]
        return dec.paged_decode_partials_torch(q, k_pages, v_pages, table,
                                               kv_len, **kw)

    with pytest.raises(lint.LintError, match="wrong keys"):
        lint.probe_decode_paged(None, "torch", fn=swapped)


def test_footprint_that_grows_with_m_is_rejected():
    lint.assert_s_independent([1024, 1024], "ok")
    with pytest.raises(lint.LintError, match="O\\(1\\)"):
        lint.assert_s_independent([1024, 2048], "grows")


def test_range_sums_closed_form():
    import numpy as np
    for lo, hi in [(0, 1), (5, 5), (1000, 3100), (0, 4096), (2047, 2049)]:
        ks = np.arange(lo, hi)
        assert tuple(int(x) for x in lint.range_sums(lo, hi)) == (
            len(ks), int((ks % 1024).sum()), int((ks // 1024).sum()))


# ---------------------------------------------------------------------------
# accel_model
# ---------------------------------------------------------------------------

#: tests/test_accel_model.py's M: SEQLENS and its extra points
ACCEL_MS = sorted(set(jaccel.SEQLENS) | {1 << 14, 1 << 16, 1 << 20})


@pytest.mark.parametrize("design", ["unfused", "flat", "fusemax"])
def test_accel_model_equals_reference(design):
    assert list(accel_model.WORKLOADS) == list(jaccel.WORKLOADS)
    assert accel_model.SEQLENS == jaccel.SEQLENS
    for name, w in accel_model.WORKLOADS.items():
        jw = jaccel.WORKLOADS[name]
        for m in ACCEL_MS:
            for fn in ("attention_result", "e2e_result"):
                got = getattr(accel_model, fn)(design, w, m)
                want = getattr(jaccel, fn)(design, jw, m)
                assert dataclasses.astuple(got) == dataclasses.astuple(want), \
                    (design, name, m, fn)
    vals = [accel_model.attention_result(design, w, m).time_s
            for w in accel_model.WORKLOADS.values()
            for m in accel_model.SEQLENS]
    assert accel_model.geomean(vals) == jaccel.geomean(vals)
