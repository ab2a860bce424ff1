"""Guards of the port: no JAX, nothing of bcalm_tpu, no silent fallback.

- No module of bcalm_tpu_torch and not chip_smoke.py imports bcalm_tpu
  (the JAX package, numpy-only modules included): an AST scan.
- A full CPU build in a fresh interpreter, resident and multi-pass, the
  CLI's store + `-skip-bcalm -skip-bglue` resume, a multi-bank
  `-solidity-kind min` build and a `-devices 2` build (gloo ranks), leave
  `jax` and every `bcalm_tpu` module out of sys.modules (a subprocess,
  since this test process imports JAX in conftest.py).
- The kernel loader raises when nvcc is absent instead of handing back
  the plain path, and the kernel wrappers refuse CPU tensors.
- The CLI exits 1 when CUDA is requested and absent.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch.ops import _kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import sys
from bcalm_tpu_torch import cli, engine
from bcalm_tpu_torch.io import fasta_writer
import io
reads = ["ACTGATGCAGATGACACTGATGCAGATGACTTGACCA"] * 3 + ["GGTACCATGACACTGATGCAG"]
us = engine.build_from_seqs(reads, engine.EngineConfig(k=15, abundance_min=2), "cpu")
fasta_writer.write_fasta(us, io.StringIO())
assert us.seqs, "empty build"
import random
random.seed(1)
g = "".join(random.choice("ACGT") for _ in range(600))
reads = [g[i:i + 40] for i in range(0, 560, 5)] * 2
cfg = engine.EngineConfig(k=15, abundance_min=2, block_reads=1, max_len=48,
                          chunk_kmers=16, resident_kmers=8)
ooc = engine.build_from_seqs(reads, cfg, "cpu")
cfg.resident_kmers = 1 << 20
assert ooc.stats["ooc_passes"] > 1
assert ooc.seqs == engine.build_from_seqs(reads, cfg, "cpu").seqs
import os, tempfile
os.environ[cli.DEVICE_ENV] = "cpu"
tmp = tempfile.mkdtemp()
for name, reads in (("a", reads), ("b", reads[::2] + reads)):
    with open(os.path.join(tmp, name + ".fa"), "w") as f:
        f.write("".join(f">r{i}\\n{r}\\n" for i, r in enumerate(reads)))
fa, out = os.path.join(tmp, "a.fa"), os.path.join(tmp, "o")
base = ["-in", fa, "-kmer-size", "15", "-abundance-min", "2", "-verbose", "0"]
assert cli.main(base + ["-out", out + "_full"]) == 0
assert cli.main(base + ["-out", out, "-only-uf"]) == 0
assert os.path.exists(os.path.join(out + "_btpu", "chains.npz"))
assert cli.main(base + ["-out", out, "-skip-bcalm", "-skip-bglue"]) == 0
full = open(out + "_full.unitigs.fa").read()
assert full and open(out + ".unitigs.fa").read() == full
assert not os.path.exists(out + "_btpu")
with open(os.path.join(tmp, "album.txt"), "w") as f:
    f.write(fa + "\\n" + os.path.join(tmp, "b.fa") + "\\n")
assert cli.main(["-in", os.path.join(tmp, "album.txt"), "-kmer-size", "15",
                 "-abundance-min", "2", "-solidity-kind", "min", "-out",
                 out + "_min", "-verbose", "0"]) == 0
assert open(out + "_min.unitigs.fa").read().count(">") > 0
assert cli.main(base + ["-out", out + "_d2", "-devices", "2"]) == 0
assert open(out + "_d2.unitigs.fa").read() == full
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m == "bcalm_tpu" or m.startswith("bcalm_tpu.")]
assert not ref, ref
print("OK", len(us.seqs))
"""


def _port_sources():
    root = pathlib.Path(REPO)
    return sorted((root / "bcalm_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]


def _imports_reference(path) -> list:
    """Import statements of a file that name bcalm_tpu (not
    bcalm_tpu_torch)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n == "bcalm_tpu" or n.startswith("bcalm_tpu.")]
    return found


def test_port_imports_nothing_of_bcalm_tpu():
    sources = _port_sources()
    assert len(sources) > 30
    bad = [hit for p in sources for hit in _imports_reference(p)]
    assert not bad, bad


def test_import_scan_finds_a_reference_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import bcalm_tpu_torch\n"
                     "def f():\n    from bcalm_tpu.io import packing\n")
    assert _imports_reference(probe) == ["probe.py:3 bcalm_tpu.io"]


def test_full_build_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_loader_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build(tmp_path / "build")


@pytest.mark.parametrize("call", [
    lambda t: _kernels.extract_insert(t((3, 64)), t((2, 2)), t((2,)), 31, 0, 0),
    lambda t: _kernels.count_sorted(t((8,)), t((8,)), None, 2, None, None),
    lambda t: _kernels.junction_keys(t((2, 16)), 16, 31, False, 2),
    lambda t: _kernels.junction_pairs(t((32,)), t((32,)), t((32,)), 16, 2),
    lambda t: _kernels.jump_round(t((8, 4)), t((8, 4)),
                                  torch.zeros(1, dtype=torch.int32)),
    lambda t: _kernels.range_fold(t((3, 64)), (0, 0), (1, 1)),
    lambda t: _kernels.lower_bound(t((2, 64)), 64, t((2, 1))),
    lambda t: _kernels.solid_fold_histogram(t((2, 8)), t((8,)), t((8,)), 8, 2,
                                            100, 10),
    lambda t: _kernels.run_scans(t((32,)), 16, 16),
    lambda t: _kernels.solid_compact(t((2, 8)), t((8,)), t((8,)), 8, 2, 100),
    lambda t: _kernels.chain_finish(t((8,)), t((8,)),
                                    torch.ones(8, dtype=torch.bool), t((8, 4))),
    lambda t: _kernels.spell_unitigs(t((2, 16)), t((16,)), t((32,)), t((32,)),
                                     t((32,)), t((32,)), 1, 31, 16),
    lambda t: _kernels.run_contract(t((32,)), torch.ones(16, dtype=torch.bool),
                                    t((16,)), t((16,)), 1, 16),
    lambda t: _kernels.run_broadcast(t((32,)), t((32,)), t((32,)), t((16,)),
                                     t((16,)), t((16,)), t((16,)), t((16,)), 16),
    lambda t: _kernels.junction_entries(t((2, 16)), 16, 31, 0, 16, 2, 2),
    lambda t: _kernels.junction_edges(t((32,)), t((32,)), t((1, 32)), t((32,)),
                                      2, 16, 8),
    lambda t: _kernels.form_superkmers(t((4, 10)), t((4,)), 31, 10,
                                       t((4 ** 10,)), None, 10, 5, 4, True, 0),
    lambda t: _kernels.mmer_histograms(t((4, 10)), t((4,)), 31, 10, None,
                                       True, t((4 ** 10,))),
    lambda t: _kernels.route_buckets(t((3, 64)),
                                     torch.ones(64, dtype=torch.bool),
                                     t((64,)), 2, 64, fill=0xFFFFFFFF),
    lambda t: _kernels.route_buckets(t((2, 64)),
                                     torch.ones(64, dtype=torch.bool),
                                     None, 4, 64, True, 0, False),
    lambda t: _kernels.glue_compose(t((8, 4)), t((4, 8)), t((8,)),
                                    torch.ones(8, dtype=torch.bool),
                                    torch.zeros(1, dtype=torch.int32),
                                    t((2, 8)), 4, 1),
    lambda t: _kernels.hier_round(t((8, 4)), t((8, 4)), t((8,)),
                                  torch.zeros(1, dtype=torch.int32)),
    lambda t: _kernels.hier_contract(t((8, 4)), t((8,)),
                                     torch.ones(8, dtype=torch.bool), 1, 2, 8,
                                     torch.ones(1, dtype=torch.int32)),
    lambda t: _kernels.hier_expand(t((2, 4)), t((2,)), t((8, 4)), t((8,))),
    lambda t: _kernels.kmer_minimizers(t((2, 16)), 31, 10),
    lambda t: _kernels.fixpoint_bits(t((8,)), torch.ones(8, dtype=torch.bool),
                                     1),
    lambda t: _kernels.glue_answer("rows", t((8,)),
                                   torch.ones(8, dtype=torch.bool), (t((8, 4)),),
                                   4, 1, 0),
    lambda t: _kernels.junction_words(t((2, 32)), torch.ones(32, dtype=torch.bool)),
    lambda t: _kernels.junction_scatter(t((2, 32)),
                                        torch.ones(32, dtype=torch.bool), 16, 0, 8),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    def cpu(shape):
        return torch.zeros(shape, dtype=torch.int64)

    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        call(cpu)


def test_cli_exits_1_when_cuda_requested_and_absent(tmp_path, monkeypatch,
                                                    capsys):
    fa = tmp_path / "reads.fa"
    fa.write_text(">r\nACGTACGTACGTACGTACGTACGT\n")
    monkeypatch.delenv(tcli.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["-in", str(fa), "-kmer-size", "21", "-out",
                      str(tmp_path / "out")]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not (tmp_path / "out.unitigs.fa").exists()
