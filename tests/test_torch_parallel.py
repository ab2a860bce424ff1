"""The port's -devices N build on gloo ranks against bcalm_tpu's
distributed_build on make_mesh(N), N = 2 and 4 (conftest's virtual CPU
devices), exact.

One module-scoped fixture per world size spawns the ranks once
(parallel.launch.run_builds) and runs every scenario; each test then
builds the same scenario with JAX and compares the repartition table and
frequency rank, each device's solid stacked run (lanes, counts,
first-occurrence keys), the gathered glue outputs and the FASTA bytes.
The scenarios are tests/test_parallel.py's, plus -abundance-min auto and
the store write.
"""

import io
import pickle
import random

import numpy as np
import pytest

from bcalm_tpu import engine as jeng
from bcalm_tpu.io import fasta_writer as jfw
from bcalm_tpu.parallel import distcompact as jdc
from bcalm_tpu.parallel import pipeline as jpl
from bcalm_tpu.storage.store import Store as JStore
from bcalm_tpu_torch import engine as teng
from bcalm_tpu_torch.parallel import launch
from bcalm_tpu_torch.parallel import pipeline as tpl


def make_reads(seed, k, n=120, glen=400):
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(glen))
    return [genome[i:i + rng.randint(k + 2, k + 40)]
            for i in [rng.randrange(0, glen - k - 10) for _ in range(n)]]


def biased_reads():
    """Position-sorted reads whose first blocks cover a small low-complexity
    region (test_parallel.py::test_biased_prefix_repartition)."""
    rng = random.Random(3)
    region_a = "".join(rng.choice("AC") for _ in range(300))
    region_b = "".join(rng.choice("ACGT") for _ in range(6000))
    return ([region_a[i:i + 50] for i in range(0, 250, 2)]
            + [region_b[i:i + 50] for i in range(0, 5950, 2)])


def noisy_reads():
    """A covered genome plus singleton noise reads: a histogram with a
    valley for -abundance-min auto."""
    rng = random.Random(5)
    noise = ["".join(rng.choice("ACGT") for _ in range(40)) for _ in range(60)]
    return make_reads(4, 21, n=400, glen=500) + noise


# name -> (reads, k, amin, EngineConfig extras, MinimizerConfig extras,
#          reread, auto_amin_cap, store)
SCENARIOS = {
    "seed0_k13": (make_reads(0, 13), 13, 1, {}, {}, False, None, False),
    "seed1_k21": (make_reads(1, 21), 21, 2, {}, {}, False, None, False),
    "seed2_k33": (make_reads(2, 33), 33, 1, {}, {}, False, None, False),
    "overflow_retry": (make_reads(17, 15, n=200, glen=600), 15, 1, {},
                       {"cap_per_dest": 2}, False, None, False),
    "biased_prefix": (biased_reads(), 15, 1,
                      {"block_reads": 16, "max_len": 64}, {}, False, None,
                      False),
    "ranged": (make_reads(9, 21, n=1500, glen=20000), 21, 1,
               {"resident_kmers": 8 * 1024}, {}, True, None, False),
    "auto": (noisy_reads(), 21, 1, {}, {}, False, 20, False),
    "store": (make_reads(1, 21), 21, 2, {}, {}, False, None, True),
}


def configs(name, pkg):
    reads, k, amin, extra, mextra, reread, auto_cap, store = SCENARIOS[name]
    kw = dict(k=k, abundance_min=amin, block_reads=64, max_len=128)
    kw.update(extra)
    eng, pl = (jeng, jpl) if pkg == "jax" else (teng, tpl)
    return reads, eng.EngineConfig(**kw), pl.MinimizerConfig(**mextra)


@pytest.fixture(scope="module", params=[2, 4])
def port(request, tmp_path_factory):
    """(n_dev, {scenario: [per-rank results]}, tmp dir) of one spawn of
    n_dev gloo ranks over every scenario."""
    n_dev = request.param
    out = tmp_path_factory.mktemp(f"port{n_dev}")
    jobs = []
    for name, sc in SCENARIOS.items():
        reads, cfg, mcfg = configs(name, "torch")
        jobs.append({"name": name, "reads": reads, "cfg": cfg, "mcfg": mcfg,
                     "reread": sc[5], "auto_amin_cap": sc[6],
                     "store": str(out / "store") if sc[7] else None})
    launch.spawn(n_dev, "cpu", launch.run_builds, jobs, str(out))
    results = {}
    for name in SCENARIOS:
        results[name] = []
        for r in range(n_dev):
            with open(out / f"{name}.{r}.pkl", "rb") as f:
                results[name].append(pickle.load(f))
    return n_dev, results, out


def jax_build(name, n_dev, tmp_path, monkeypatch):
    """bcalm_tpu's distributed_build of a scenario, with the same
    intermediate results captured from its module functions."""
    reads, cfg, mcfg = configs(name, "jax")
    sc = SCENARIOS[name]
    cap = {}
    real_tables = jpl.sample_tables_multi
    real_dev = jdc.distributed_compact_dev
    real_asm = jdc.assemble_from_glue

    def tables(*a, **kw):
        out = real_tables(*a, **kw)
        cap.update(freq_rank=out[0], table=out[1])
        return out

    def compact_dev(mesh, stacked, n_np, k, extra_stats=None):
        cap.update(solid=np.asarray(stacked), n_solid=np.asarray(n_np))
        return real_dev(mesh, stacked, n_np, k, extra_stats)

    def assemble(outs_np, n_unitigs, *rest):
        slot_cap, run_cap = rest[3], rest[4]
        cap.update(glue=outs_np, n_unitigs=n_unitigs, slot_cap=slot_cap,
                   run_cap=run_cap)
        return real_asm(outs_np, n_unitigs, *rest)

    monkeypatch.setattr(jpl, "sample_tables_multi", tables)
    monkeypatch.setattr(jdc, "distributed_compact_dev", compact_dev)
    monkeypatch.setattr(jdc, "assemble_from_glue", assemble)
    store = JStore(str(tmp_path / "jstore")) if sc[7] else None
    us = jpl.distributed_build(
        reads, cfg, jpl.make_mesh(n_dev), mcfg, auto_amin_cap=sc[6],
        store=store, reread=(lambda: iter(reads)) if sc[5] else None)
    text = io.StringIO()
    jfw.write_fasta(us, text)
    return us, cfg, cap, text.getvalue(), store


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_distributed_build_matches_jax(port, name, tmp_path, monkeypatch):
    n_dev, results, out = port
    ranks = results[name]
    us, jcfg, cap, fasta, jstore = jax_build(name, n_dev, tmp_path,
                                             monkeypatch)
    r0 = ranks[0]

    # sampling: repartition table and frequency rank, the same on every rank
    for r in ranks:
        assert np.array_equal(r["probe"]["table"], cap["table"])
        if cap["freq_rank"] is None:
            assert r["probe"]["freq_rank"] is None
        else:
            assert np.array_equal(r["probe"]["freq_rank"], cap["freq_rank"])
        assert r["abundance_min"] == jcfg.abundance_min

    # each device's solid stacked run
    assert np.array_equal(r0["probe"]["n_solid"], cap["n_solid"])
    per = cap["solid"].shape[1] // n_dev
    for d, r in enumerate(ranks):
        want = cap["solid"][:, d * per:(d + 1) * per].astype(np.int64)
        assert np.array_equal(r["probe"]["solid"], want), f"device {d}"

    # the glue outputs, gathered (device-major)
    p0 = r0["probe"]
    for key in ("n_unitigs", "slot_cap", "run_cap"):
        assert p0[key] == cap[key], key
    names = ("n_runs", "hpos", "epos", "rlen", "uid2", "rank2", "keep",
             "uid_at", "len_at", "break_node")
    for nm, got, want in zip(names, p0["glue"], cap["glue"]):
        want = np.asarray(want).reshape(-1).astype(np.int64)
        assert np.array_equal(got.astype(np.int64), want), nm

    # the unitigs
    assert r0["fasta"] == fasta
    assert fasta.count(">") > 0
    st = r0["stats"]
    for key in ("devices", "exchange_cap_retries", "ooc_ranges", "ooc_passes",
                "superkmers", "kmer_occurrences", "glue_runs", "solid_kmers",
                "abundance_min"):
        assert st[key] == us.stats[key], key
    assert st["device_load_imbalance"] == pytest.approx(
        us.stats["device_load_imbalance"])
    assert st["exchange_ladder_hits"] == 0
    if name == "overflow_retry":
        assert st["exchange_cap_retries"] >= 1
    if name == "biased_prefix":
        assert st["device_load_imbalance"] < 3.0
    if name == "ranged":
        assert st["ooc_ranges"] > 1
    if name == "store":
        # JAX's Store reads the port's checkpoint, repartition table included
        mine = JStore(str(out / "store"))
        got, want = mine.read_repartition(), jstore.read_repartition()
        assert got["m"] == want["m"]
        assert got["table"].dtype == want["table"].dtype
        for key in ("table", "freq_rank"):
            assert np.array_equal(got[key], want[key]), key
        for a, b in zip(mine.read_counts(jcfg.k), jstore.read_counts(jcfg.k)):
            assert np.array_equal(a, b)
        assert np.array_equal(mine.read_histogram(), jstore.read_histogram())
