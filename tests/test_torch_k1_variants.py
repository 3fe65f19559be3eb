"""The K1 variants bench builds what it says, from the shipped source.

``benchmarks/torch_k1_variants.py`` makes each variant by a textual edit
of ``csrc/fusemax_prefill.cu`` (its headers inlined), and splices the
thread-block cluster body at (576, 512), which the port does not build,
in from ``benchmarks/fusemax_prefill_cluster.cuh``.  An edit raises when
the source no longer holds its text, so a change of the shipped source
that breaks a variant shows here, on the CPU, and not first on the card.
Nothing here compiles: ``chip_smoke.py`` builds the parent these edits
make, and the bench builds them all on the card.
"""
import importlib.util
import pathlib
import re

import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro_torch.kernels import autotune

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _bench():
    spec = importlib.util.spec_from_file_location(
        "torch_k1_variants", ROOT / "benchmarks" / "torch_k1_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


k1v = _bench()
SHIPPED = k1v.shipped_source()


def _cluster_bytes(c, bk, nbuf, qs, elem_bytes=4):
    """``ClLayout<T, 576, 512, C>::BYTES`` of the cluster body, written
    out: Q (raw, or its split), the K and Vᵀ splits, the peers' scores of
    two tiles and 2 + 4 NBUF mbarriers."""
    nb = 1 if elem_bytes == 2 else 2
    ec, fc = 576 // c, 512 // c
    nq = nb if qs else 1
    return 4 * (nq * 64 * ec + nb * nbuf * (bk * ec + fc * bk)
                + 2 * (c - 1) * 64 * bk) + 8 * (2 + 4 * nbuf)


@pytest.mark.parametrize("name", sorted(k1v.VARIANTS))
def test_every_variant_edits_the_shipped_source(name):
    """Each variant's edit applies to the shipped source and changes it
    (``shipped`` and the plan-only variants leave it as it is, with no
    cluster body: the port builds none); a cluster variant holds one
    cluster kernel, one dispatch case and one max-active-clusters entry,
    at the plan its ``PLANS`` entry runs."""
    src = k1v.VARIANTS[name](SHIPPED)
    plan_only = name in ("shipped", "default_plan", "split2")
    assert (src == SHIPPED) == plan_only
    if name not in k1v.CLUSTER_VARIANTS:
        assert "fusemax_prefill_cluster_kernel" not in src
        return
    c = 4 if name.startswith("cluster4") else 2
    assert src.count("fusemax_prefill_cluster_kernel(const T*") == 1
    assert src.count("REPRO_CLUSTER_PLANS(REPRO_LAUNCH_CLUSTER)") == 1
    assert src.count(
        'extern "C" int fusemax_prefill_max_active_clusters(') == 1
    assert f"#define REPRO_CLUSTER_PLANS(X) X(576, 512, 64, {c})\n" in src
    # the cluster body sits inside the source's namespace, after Args and
    # before the instantiations; its C entry after the source's
    assert src.index("struct Args {") \
        < src.index("fusemax_prefill_cluster_kernel(const T*") \
        < src.index("#define REPRO_DIMS(X)") \
        < src.index('extern "C" int fusemax_prefill_plan(') \
        < src.index('extern "C" int fusemax_prefill_max_active_clusters(')
    assert '#include "' not in src
    plan = k1v.plan_of(name, torch.empty(4, 32768, 576),
                       torch.empty(4, 1024, 512))
    assert (plan.block_q, plan.f_split, plan.blocks) == (64, c, 2048 * c)
    tile = re.search(r"struct ClTile<576, 512> {\s*static constexpr int "
                     r"BK = (\d+), NBUF = (\d+), KB = (\d+), NF = (\d+), "
                     r"QS = (\d+);", src)
    bk, nbuf, kb, nf, qs = map(int, tile.groups())
    assert bk in (16, 32) and 4 % kb == 0 and 2 <= nf <= 4 // kb + 1
    assert _cluster_bytes(c, bk, nbuf, qs) <= autotune.SMEM_BUDGET
    assert bool(qs) == ("qsplit" in name)


def test_cluster_layouts_match_the_header():
    """The byte counts the header and PERF.md give for the cluster
    layouts: two blocks, raw Q, 32-key tiles (229,424 B); four blocks, Q
    split in shared memory (192,560 B); the pre-split two-block layout at
    32 keys does not fit (Q's split alone is 147,456 B)."""
    text = (ROOT / "benchmarks" / "fusemax_prefill_cluster.cuh").read_text()
    assert _cluster_bytes(2, 32, 1, False) == 229_424
    assert _cluster_bytes(4, 32, 1, True) == 192_560
    assert _cluster_bytes(2, 32, 1, True) > autotune.SMEM_BUDGET
    assert "C 2 BK 32 NBUF 1:       229,424 B" in text
    assert "C 4 BK 32 NBUF 1 QS:    192,560 B" in text


@pytest.mark.parametrize("only", [False, True])
def test_mma_sync_source_builds_the_parent(only):
    """``mma_sync_source`` routes every dim the wgmma body took back to
    the mma.sync body on its old tile, whatever ``REPRO_DIMS`` holds; with
    ``only`` nothing else is compiled."""
    src = k1v.mma_sync_source(SHIPPED, only=only)
    dims = re.search(r"#define REPRO_DIMS\(X\)(.*)\n", src).group(1)
    got = {tuple(map(int, d)) for d in re.findall(r"X\((\d+), (\d+)\)",
                                                  dims)}
    want = set(k1v.MMA_TILES) | (set() if only else {(576, 512)})
    assert got == want
    wg = src[src.index("#define REPRO_WGMMA_PLANS(X)"):]
    wg = wg[:wg.index("\n\n")]
    assert all((int(e), int(f)) not in k1v.MMA_TILES for e, f, *_ in
               re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", wg))
    for e, f in k1v.MMA_TILES:
        assert f"struct PrefillTile<{e}, {f}> {{" in src
