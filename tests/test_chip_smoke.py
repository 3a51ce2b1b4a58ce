"""chip_smoke.py's own parts, checked on the CPU: its numpy reference
against the scalar oracle, its TSV reader, its seeded genome, and its
refusal to run anywhere but on a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from oracle.scalar import count_fasta_file, parse_fasta_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as_dict(codes, counts, k):
    from findkmer_tpu.ops.window import code_to_str

    return {code_to_str(int(c), k): int(n) for c, n in zip(codes, counts)}


@pytest.mark.parametrize("name", ["multi.fa", "ecoli_frag.fa"])
@pytest.mark.parametrize("k,canonical", [(4, False), (13, False),
                                         (21, True)])
def test_numpy_reference_matches_oracle(fixtures_dir, name, k, canonical):
    path = os.path.join(fixtures_dir, name)
    with open(path) as f:
        records = [(h, s.encode()) for h, s in parse_fasta_text(f.read())]
    codes = chip_smoke.encode_records(records)
    got = _as_dict(*chip_smoke.reference_spectrum(codes, k, canonical), k)
    assert got == count_fasta_file(path, k, canonical=canonical)


def test_read_spectrum_tsv_round_trip(tmp_path):
    from oracle.scalar import spectrum_lines

    want = {"ACGTA": 1, "CCCCC": 300, "TTTTT": 123456789}
    path = tmp_path / "s.tsv"
    path.write_text("\n".join(spectrum_lines(want, 5)) + "\n")
    codes, counts = chip_smoke.read_spectrum_tsv(str(path), 5)
    assert _as_dict(codes, counts, 5) == want


@pytest.mark.parametrize("bad", ["ACGTA\t1\nACGT\t2\n", "ACGTA\t1\nacgta\t2\n",
                                 "ACGTA\t1x\n", "ACGTA\t1"])
def test_read_spectrum_tsv_rejects_malformed(tmp_path, bad):
    path = tmp_path / "bad.tsv"
    path.write_text(bad)
    with pytest.raises((ValueError, IndexError)):
        chip_smoke.read_spectrum_tsv(str(path), 5)


def test_genome_is_seeded(tmp_path):
    a = chip_smoke.make_genome(0.05, seed=3)
    b = chip_smoke.make_genome(0.05, seed=3)
    c = chip_smoke.make_genome(0.05, seed=4)
    assert a == b and a != c
    paths = [tmp_path / "a.fa", tmp_path / "b.fa"]
    for p, recs in zip(paths, (a, b)):
        chip_smoke.write_fasta(str(p), recs)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    # what a reference assembly carries: gaps, soft-masking, repeats
    seq = b"".join(s for _, s in a)
    assert b"N" in seq and b"a" in seq
    assert len(a) == 26 and sum(len(s) for _, s in a) == 50_005


def test_device_check_exits_on_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.device_check(1)
    assert e.value.code != 0
    assert "needs 1 GPU" in capsys.readouterr().err


def test_native_check_exits_without_library(monkeypatch, capsys):
    from findkmer_tpu.io import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "load_error", lambda: "cc: not found")
    with pytest.raises(SystemExit) as e:
        chip_smoke.native_check()
    assert e.value.code != 0
    assert "cc: not found" in capsys.readouterr().err


@pytest.mark.heavy
def test_script_fails_without_gpu():
    """The whole script on a CPU backend: non-zero exit, no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
