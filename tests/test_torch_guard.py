"""Guards of the port: no JAX, no silent fallback.

- A full CPU build in a fresh interpreter leaves `jax` out of sys.modules
  (a subprocess, since this test process imports JAX in conftest.py).
- The kernel loader raises when nvcc is absent instead of handing back
  the plain path, and the kernel wrappers refuse CPU tensors.
- The CLI exits 1 when CUDA is requested and absent.
"""

import os
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
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("OK", len(us.seqs))
"""


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
    lambda t: _kernels.count_runs(t((2, 8)), None, None),
    lambda t: _kernels.junction_keys(t((2, 16)), 16, 31, False, 2),
    lambda t: _kernels.junction_pairs(t((2, 32)), t((32,)), 16, False),
    lambda t: _kernels.jump_round(t((8, 4)), t((8, 4)),
                                  torch.zeros(1, dtype=torch.int32)),
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
