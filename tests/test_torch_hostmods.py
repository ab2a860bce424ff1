"""The port's own copies of bcalm_tpu's host modules against the originals:
models/spans.py, io/gfa.py (and its converter entry point), graph/unitigs.py,
and the single-device CLI's verbose ingest output (utils/logging.py's
"reads packed" progress, the ingest figure, the ignored-flag note).
"""

import io
import os
import subprocess
import sys

import pytest

from bcalm_tpu import cli as jcli
from bcalm_tpu.graph import unitigs as jgraph
from bcalm_tpu.io import gfa as jgfa
from bcalm_tpu.models import spans as jspans
from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch.graph import unitigs as tgraph
from bcalm_tpu_torch.io import gfa as tgfa
from bcalm_tpu_torch.models import spans as tspans
from bcalm_tpu_torch.ops import _kernels
from tests.test_torch_cli import write_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("spans", [jspans, tspans], ids=["jax", "torch"])
def test_span_dispatch(spans):
    """tests/test_aux.py:test_span_dispatch, run on both packages."""
    assert spans.span_of(13) == 1
    assert spans.span_of(31) == 2
    assert spans.span_of(33) == 3
    assert spans.span_of(63) == 4
    with pytest.raises(ValueError):
        spans.validate_k(1)
    with pytest.raises(ValueError):
        spans.validate_k(spans.MAX_K + 1)
    table = spans.span_table(100)
    assert table[0][1] == 2
    assert table[-1][2] == 100
    for (L, lo, hi), (L2, lo2, _) in zip(table, table[1:]):
        assert lo2 == hi + 1 and L2 == L + 1


def test_spans_equal_and_tie_the_kernel_cap():
    assert tspans.MAX_K == jspans.MAX_K == 512
    assert tspans.span_table() == jspans.span_table()
    for k in (2, 16, 17, 128, 129, 151, 255, 256, 257, 511, 512):
        assert tspans.span_of(k) == jspans.span_of(k)
    # the kernels take every k the port validates: 32 lanes (k <= 512)
    assert _kernels.MAX_LANES == tspans.MAX_K // 16 == 32
    src = open(os.path.join(REPO, "bcalm_tpu_torch", "csrc",
                            "common.cuh")).read()
    assert "constexpr int kMaxLanes = 32;" in src
    for L in range(1, 33):
        _kernels._lanes_ok(L, "test")
    with pytest.raises(ValueError):
        _kernels._lanes_ok(33, "test")


@pytest.fixture(scope="module")
def circular_unitigs(tmp_path_factory):
    """tests/test_cli.py:test_gfa_conversion's input: one circular unitig
    with self-links on both strands, built by the JAX CLI."""
    tmp = tmp_path_factory.mktemp("gfa")
    fa = tmp / "c.fa"
    fa.write_text(">r0\nACTTAGCGGACTTAGC\n")
    assert jcli.main(["-in", str(fa), "-kmer-size", "7", "-abundance-min",
                      "1", "-out", str(tmp / "c"), "-verbose", "0"]) == 0
    return str(tmp / "c.unitigs.fa")


@pytest.mark.parametrize("single_directed", [False, True])
def test_gfa_byte_equal(circular_unitigs, single_directed):
    want, got = io.StringIO(), io.StringIO()
    jgfa.fasta_to_gfa(circular_unitigs, want, 7,
                      single_directed=single_directed)
    tgfa.fasta_to_gfa(circular_unitigs, got, 7,
                      single_directed=single_directed)
    assert got.getvalue() == want.getvalue()
    assert "L\t0\t+\t0\t+\t6M" in got.getvalue()
    assert ("L\t0\t-\t0\t-\t6M" in got.getvalue()) != single_directed


@pytest.mark.parametrize("extra", [[], ["--single-directed"]])
def test_gfa_entry_point_matches_script(circular_unitigs, tmp_path, extra):
    """python -m bcalm_tpu_torch.io.gfa takes scripts/convert_to_gfa.py's
    arguments and writes the same bytes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = []
    for cmd in ([sys.executable, os.path.join(REPO, "scripts",
                                              "convert_to_gfa.py")],
                [sys.executable, "-m", "bcalm_tpu_torch.io.gfa"]):
        out = tmp_path / f"{len(outs)}.gfa"
        run = subprocess.run(cmd + [circular_unitigs, str(out), "7"] + extra,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode == 0, run.stderr
        assert run.stdout == "done\n"
        outs.append(out.read_bytes())
    assert outs[1] == outs[0] and outs[0].startswith(b"H\tVN:Z:1.0\tks:i:7\n")


def test_unitig_graph_from_fasta(tmp_path, monkeypatch):
    """The port's UnitigGraph loaded from a unitigs FASTA navigates as
    bcalm_tpu's does."""
    fa = tmp_path / "reads.fa"
    write_reads(fa, n=300)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(["-in", str(fa), "-kmer-size", "31", "-abundance-min",
                      "2", "-verbose", "0", "-out", str(tmp_path / "t")]) == 0
    path = str(tmp_path / "t.unitigs.fa")
    want = jgraph.UnitigGraph.load(path, 31)
    got = tgraph.UnitigGraph.load(path, 31)

    def as_tuples(nodes):
        return [(n.uid, n.strand) for n in nodes]

    nodes = list(want.nodes())
    assert as_tuples(got.nodes()) == as_tuples(nodes) and len(nodes) > 20
    for node in nodes:
        mine = tgraph.Node(node.uid, node.strand)
        assert as_tuples(got.successors(mine)) == as_tuples(want.successors(node))
        assert got.is_branching(mine) == want.is_branching(node)
        assert got.sequence(mine) == want.sequence(node)
        assert (as_tuples(got.simple_path_forward(mine))
                == as_tuples(want.simple_path_forward(node)))


def _stderr_lines(text):
    notes = [l for l in text.splitlines() if l.startswith("note:")]
    packed = [l.split("] ", 2)[-1].split(" done in")[0]
              for l in text.splitlines() if "reads packed" in l]
    return notes, packed


def test_cli_verbose_ingest_output(tmp_path, monkeypatch, capsys):
    """-verbose 1: the "reads packed" progress line and the note for a
    mesh-only flag, as bcalm_tpu prints them, and the ingest figure: JAX's
    ingest_mbps stat, the port's count.ingest_wait span."""
    fa = tmp_path / "reads.fa"
    write_reads(fa, n=200)
    args = ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2",
            "-minimizer-size", "8", "-repartition-type", "0", "-verbose", "1"]
    assert jcli.main(args + ["-out", str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr()
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(args + ["-out", str(tmp_path / "torch")]) == 0
    tout = capsys.readouterr()
    want_notes, want_packed = _stderr_lines(jout.err)
    got_notes, got_packed = _stderr_lines(tout.err)
    assert got_notes == want_notes == [
        "note: -minimizer-size only affects the -devices N mesh path; "
        "ignored on the single-device path",
        "note: -repartition-type only affects the -devices N mesh path; "
        "ignored on the single-device path"]
    assert got_packed == want_packed == ["reads packed: 200"]
    assert "    [ingest_mbps] " in jout.out
    assert "    [time:count.ingest_wait] " in tout.out
