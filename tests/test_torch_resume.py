"""Store, resume and re-link paths of `python -m bcalm_tpu_torch` vs bcalm_tpu.

The scenarios of tests/test_cli.py's resume section, each run through both
command lines (bcalm_tpu on JAX's CPU backend, the port with
BCALM_TORCH_DEVICE=cpu) under their own prefixes: exit codes and refusal
messages are the same, every unitigs file is byte-identical.  Stores also
cross packages: a `<prefix>_btpu/` written by one resumes in the other.
"""

import os
import shutil

import numpy as np
import pytest

from bcalm_tpu import cli as jcli
from bcalm_tpu.storage.store import Store
from bcalm_tpu_torch.storage.store import Store as TorchStore
from bcalm_tpu_torch import cli as tcli
from tests.test_torch_cli import write_reads

# minitip-style fixture of tests/test_cli.py: two abundant overlapping
# reads and a single-copy tip, so -abundance-min 1 and 3 differ
AB_SEQS = (["CAGGCAATGAGATGATAACATGATAGA"] * 3
           + ["ATGATAACATGATAGATGAGACCAATT"] * 3
           + ["TAACATGATAGATCCCGGGTTTAAACC"])
TINY = "ACTGCTGACTGAGTCATGTGTGGGT"


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")


def write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">read{i}\n{s}\n")


def both(tmp_path, name, args):
    """Run args through both CLIs with -out <tmp>/{jax,torch}_<name>;
    returns ((rc_jax, rc_torch), (prefix_jax, prefix_torch))."""
    pj, pt = str(tmp_path / f"jax_{name}"), str(tmp_path / f"torch_{name}")
    return ((jcli.main(args + ["-out", pj]), tcli.main(args + ["-out", pt])),
            (pj, pt))


def fasta(prefix):
    with open(prefix + ".unitigs.fa", "rb") as f:
        return f.read()


def ab_input(tmp_path, name="ab"):
    fa = tmp_path / f"{name}.fa"
    write_fasta(fa, AB_SEQS)
    return fa


def ab_args(fa, amin, *extra):
    return ["-in", str(fa), "-kmer-size", "13", "-abundance-min", str(amin),
            "-verbose", "1", *extra]


def test_only_uf_and_uf_stats(tmp_path, capsys):
    fa = tmp_path / "r.fa"
    write_fasta(fa, [TINY])
    args = ["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1"]
    rcs, (pj, pt) = both(tmp_path, "uf", args + ["-only-uf", "-uf-stats"])
    assert rcs == (0, 0)
    out = capsys.readouterr().out
    assert not os.path.exists(pt + ".unitigs.fa")
    assert Store(pt).exists() and Store(pt).has_chains()
    uf = [line.strip() for line in out.splitlines() if "[uf_" in line]
    assert len(uf) == 12 and uf[:6] == uf[6:]        # JAX's, then the port's
    assert out.count("-only-uf: stopped after chain labeling") == 2
    rcs, (pj, pt) = both(tmp_path, "full", args + ["-uf-stats"])
    assert rcs == (0, 0) and fasta(pt) == fasta(pj)
    assert "uf_classes" in capsys.readouterr().out
    assert not os.path.exists(pt + "_btpu")


def test_skip_bcalm_resume(tmp_path, capsys):
    fa = ab_input(tmp_path)
    rcs, (pj, pt) = both(tmp_path, "r", ab_args(fa, 1, "-only-uf"))
    assert rcs == (0, 0)
    os.unlink(fa)                     # resume from the store alone
    capsys.readouterr()
    rcs, _ = both(tmp_path, "r", ab_args(fa, 1, "-skip-bcalm"))
    assert rcs == (0, 0)
    assert capsys.readouterr().out.count("reusing stored counts") == 2
    assert fasta(pt) == fasta(pj) and fasta(pt).count(b">") > 1
    assert not os.path.exists(pt + "_btpu")


def test_no_implicit_store_reuse(tmp_path):
    fa = ab_input(tmp_path)
    rcs, (pj, pt) = both(tmp_path, "a", ab_args(fa, 1, "-only-uf"))
    assert rcs == (0, 0) and os.path.isdir(pt + "_btpu")
    rcs, (tj, tt) = both(tmp_path, "truth", ab_args(fa, 3))
    assert rcs == (0, 0)
    rcs, _ = both(tmp_path, "a", ab_args(fa, 3))   # recounts at 3
    assert rcs == (0, 0)
    assert fasta(pt) == fasta(tt) == fasta(pj) == fasta(tj)


def test_skip_bcalm_refilters_higher_amin(tmp_path):
    fa = ab_input(tmp_path)
    assert both(tmp_path, "b", ab_args(fa, 1, "-only-uf"))[0] == (0, 0)
    rcs, (tj, tt) = both(tmp_path, "truth", ab_args(fa, 3))
    assert rcs == (0, 0)
    os.unlink(fa)
    rcs, (pj, pt) = both(tmp_path, "b", ab_args(fa, 3, "-skip-bcalm"))
    assert rcs == (0, 0)
    assert fasta(pt) == fasta(pj) == fasta(tt)


@pytest.mark.parametrize("name,stored_amin,k,amin,message", [
    ("lower_amin", 3, 13, 1, "cannot widen"),
    ("wrong_k", 1, 15, 1, "k=13"),
])
def test_skip_bcalm_refusals(tmp_path, capsys, name, stored_amin, k, amin,
                             message):
    fa = ab_input(tmp_path)
    assert both(tmp_path, name, ab_args(fa, stored_amin, "-only-uf"))[0] == (0, 0)
    capsys.readouterr()
    rcs, _ = both(tmp_path, name, ["-in", str(fa), "-kmer-size", str(k),
                                   "-abundance-min", str(amin), "-skip-bcalm"])
    assert rcs == (1, 1)
    assert capsys.readouterr().err.count(message) == 2


def test_skip_bglue_resume(tmp_path, capsys):
    fa = ab_input(tmp_path)
    assert both(tmp_path, "e", ab_args(fa, 1, "-only-uf"))[0] == (0, 0)
    rcs, (tj, tt) = both(tmp_path, "truth", ab_args(fa, 1))
    assert rcs == (0, 0)
    os.unlink(fa)
    capsys.readouterr()
    rcs, (pj, pt) = both(tmp_path, "e", ab_args(fa, 1, "-skip-bcalm",
                                                "-skip-bglue"))
    assert rcs == (0, 0)
    assert capsys.readouterr().out.count("reusing stored chain decomposition") == 2
    assert fasta(pt) == fasta(pj) == fasta(tt)


@pytest.mark.parametrize("name,only_uf,amin,message", [
    ("stale", True, 3, "stale"),
    ("missing", False, 1, "no stored counts"),
    ("no_bcalm", None, 1, "-skip-bglue requires -skip-bcalm"),
])
def test_skip_bglue_refusals(tmp_path, capsys, name, only_uf, amin, message):
    fa = ab_input(tmp_path)
    if only_uf is not None:
        first = ab_args(fa, 1, *(["-only-uf"] if only_uf else []))
        assert both(tmp_path, name, first)[0] == (0, 0)
    capsys.readouterr()
    resume = ["-skip-bglue"] + (["-skip-bcalm"] if only_uf is not None else [])
    rcs, _ = both(tmp_path, name, ab_args(fa, amin, *resume))
    assert rcs == (1, 1)
    assert capsys.readouterr().err.count(message) == 2


def test_redo_links_idempotent(tmp_path):
    fa = tmp_path / "refs.fa"
    write_reads(fa, seed=8, n=400)
    args = ["-in", str(fa), "-kmer-size", "21", "-abundance-min", "2"]
    rcs, (pj, pt) = both(tmp_path, "refs", args)
    assert rcs == (0, 0)
    before = fasta(pt)
    assert before == fasta(pj) and b"L:" in before
    # the canonical resume command of pufferize, with the links stripped
    # first so that the rewrite has work to do
    with open(pt + ".unitigs.fa", "w") as f:
        f.write("\n".join(" ".join(t for t in line.split(" ")
                                   if not t.startswith("L:"))
                          for line in before.decode().splitlines()) + "\n")
    rcs, _ = both(tmp_path, "refs", ["-in", pt, "-skip-bcalm", "-skip-bglue",
                                     "-redo-links", "-kmer-size", "21"])
    assert rcs == (0, 0)
    assert fasta(pt) == fasta(pj) == before
    rcs, _ = both(tmp_path, "nope", ["-in", pt, "-redo-links"])
    assert rcs == (1, 1)


def reads_input(tmp_path):
    fa = tmp_path / "reads.fa"
    write_reads(fa, seed=6, n=300)
    return ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2"]


@pytest.mark.parametrize("writer,skip_bglue", [
    ("jax", False), ("jax", True), ("torch", False), ("torch", True)])
def test_store_crosses_packages(tmp_path, writer, skip_bglue):
    """A store written by one package's -only-uf resumes in the other with
    -skip-bcalm [-skip-bglue], byte-identical to both full runs."""
    args = reads_input(tmp_path)
    rcs, (fj, ft) = both(tmp_path, "full", args)
    assert rcs == (0, 0) and fasta(fj) == fasta(ft)
    stored = str(tmp_path / "stored")
    first, resume = (jcli, tcli) if writer == "jax" else (tcli, jcli)
    assert first.main(args + ["-out", stored, "-only-uf"]) == 0
    chains = np.load(os.path.join(stored + "_btpu", "chains.npz"))
    assert chains["uid"].dtype == np.int32 and chains["circular"].dtype == bool
    extra = ["-skip-bcalm"] + (["-skip-bglue"] if skip_bglue else [])
    os.unlink(args[1])
    assert resume.main(args + ["-out", stored] + extra) == 0
    assert fasta(stored) == fasta(fj)
    assert not os.path.exists(stored + "_btpu")


def test_default_run_writes_and_removes_the_store(tmp_path, monkeypatch):
    """The port's build checkpoints its solid set in JAX's dtypes (read back
    here before the end-of-run removal) and removes it at the end."""
    args = reads_input(tmp_path)
    seen = {}
    real = TorchStore.remove

    def keep_copy(self):
        if os.path.isdir(self.path):
            shutil.copytree(self.path, str(tmp_path / "copy_btpu"))
        seen["removed"] = self.path
        real(self)

    monkeypatch.setattr(TorchStore, "remove", keep_copy)
    prefix = str(tmp_path / "t")
    assert tcli.main(args + ["-out", prefix]) == 0
    assert not os.path.exists(prefix + "_btpu")
    assert seen["removed"] == prefix + "_btpu"
    got = Store(str(tmp_path / "copy"))
    lanes, counts, minpos = got.read_counts(31)
    assert (lanes.dtype, counts.dtype, minpos.dtype) == (np.uint32, np.int32,
                                                         np.uint32)
    assert got.read_histogram().dtype == np.int32
    assert got.config() == {"abundance_min": 2, "abundance_max": 2**31 - 1,
                            "solidity_kind": "sum"}
    jprefix = str(tmp_path / "j")
    assert jcli.main(args + ["-out", jprefix, "-only-uf"]) == 0
    want = Store(jprefix)
    for a, b in zip((lanes, counts, minpos), want.read_counts(31)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.read_histogram(), want.read_histogram())
