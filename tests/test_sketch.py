"""Bottom-s MinHash sketches (findkmer sketch + similarity on sketches).

The estimator is checked against exact Jaccard (s >= union makes the
bottom-s estimate exact), against a brute-force hash of the full
distinct set, and statistically on a known-overlap pair."""

import gzip
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from findkmer_tpu import sketch as sk
from findkmer_tpu import spectra
from oracle.scalar import count_fasta_file, spectrum_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli"] + args,
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )


def _write_spectrum(path, counts, k):
    path.write_text("\n".join(spectrum_lines(counts, k)) + "\n")


def _random_spectrum(rng, k, n):
    counts = {}
    for _ in range(n):
        counts["".join(rng.choice("ACGT") for _ in range(k))] = (
            rng.randint(1, 9)
        )
    return counts


def test_hash_is_injective_on_codes():
    codes = np.arange(4 ** 6, dtype=np.uint64)
    h = sk.hash_codes_u64(codes)
    assert np.unique(h).size == codes.size  # bijection restricted to 4^k


def test_bottom_s_matches_bruteforce(tmp_path):
    rng = random.Random(7)
    counts = _random_spectrum(rng, 9, 500)
    p = tmp_path / "a.tsv"
    _write_spectrum(p, counts, 9)
    got = sk.sketch_spectrum_file(str(p), s=64)
    from findkmer_tpu.ops.window import str_to_code

    codes = np.array(
        sorted(str_to_code(m) for m in counts), dtype=np.uint64
    )
    want = np.sort(sk.hash_codes_u64(codes))[:64]
    assert got["k"] == 9 and got["n_hashes"] == 64
    assert [int(h, 16) for h in got["hashes"]] == want.tolist()


def test_line_path_equals_c_path(tmp_path):
    rng = random.Random(8)
    counts = _random_spectrum(rng, 7, 300)
    p = tmp_path / "a.tsv"
    _write_spectrum(p, counts, 7)
    pgz = tmp_path / "a.tsv.gz"
    pgz.write_bytes(gzip.compress(p.read_bytes()))
    a = sk.sketch_spectrum_file(str(p), s=100)
    b = sk.sketch_spectrum_file(str(pgz), s=100)  # gz forces line path
    assert a["hashes"] == b["hashes"]


def test_exact_jaccard_when_s_covers_union(tmp_path):
    rng = random.Random(11)
    ca = _random_spectrum(rng, 8, 400)
    cb = _random_spectrum(rng, 8, 400)
    shared = dict(list(ca.items())[:150])
    cb.update(shared)
    pa, pb = tmp_path / "a.tsv", tmp_path / "b.tsv"
    _write_spectrum(pa, ca, 8)
    _write_spectrum(pb, cb, 8)
    ska = sk.sketch_spectrum_file(str(pa), s=10000)
    skb = sk.sketch_spectrum_file(str(pb), s=10000)
    got = sk.compare_sketches(ska, skb)
    want = spectra.similarity_spectra(str(pa), str(pb))
    assert got["jaccard"] == pytest.approx(want["jaccard"])
    assert got["mash_distance"] == pytest.approx(want["mash_distance"])
    assert got["shared"] == want["shared"]


def test_estimator_close_at_small_s(tmp_path):
    rng = random.Random(13)
    ca = _random_spectrum(rng, 12, 4000)
    cb = _random_spectrum(rng, 12, 4000)
    shared = dict(list(ca.items())[:2000])
    cb.update(shared)
    pa, pb = tmp_path / "a.tsv", tmp_path / "b.tsv"
    _write_spectrum(pa, ca, 12)
    _write_spectrum(pb, cb, 12)
    exact = spectra.similarity_spectra(str(pa), str(pb))["jaccard"]
    est = sk.compare_sketches(
        sk.sketch_spectrum_file(str(pa), s=512),
        sk.sketch_spectrum_file(str(pb), s=512),
    )["jaccard"]
    # sd of the estimator ~ sqrt(j(1-j)/s) ~ 0.02; allow 6 sigma
    assert abs(est - exact) < 0.13


def test_canonical_fold_matches_canonize_file(tmp_path):
    rng = random.Random(17)
    counts = _random_spectrum(rng, 6, 200)
    p = tmp_path / "a.tsv"
    _write_spectrum(p, counts, 6)
    folded = tmp_path / "a.canon.tsv"
    with open(folded, "wb") as f:
        spectra.canonize_spectrum_file(str(p), f)
    a = sk.sketch_spectrum_file(str(p), s=500, canonical=True)
    b = sk.sketch_spectrum_file(str(folded), s=500, canonical=True)
    c = sk.sketch_spectrum_file(str(folded), s=500)  # already canonical
    assert a["hashes"] == b["hashes"] == c["hashes"]


def test_sequence_input_equals_spectrum_input(tmp_path, fixtures_dir):
    fa = os.path.join(fixtures_dir, "tiny.fa")
    counts = count_fasta_file(fa, 5)
    p = tmp_path / "a.tsv"
    _write_spectrum(p, counts, 5)
    a = sk.sketch_sequences([fa], 5, s=200)
    b = sk.sketch_spectrum_file(str(p), s=200)
    assert a["hashes"] == b["hashes"]


def test_compare_guards():
    a = sk._make(5, 10, False, np.array([1, 2], np.uint64), "a")
    b = sk._make(6, 10, False, np.array([1, 2], np.uint64), "b")
    c = sk._make(5, 10, True, np.array([1, 2], np.uint64), "c")
    with pytest.raises(ValueError, match="k mismatch"):
        sk.compare_sketches(a, b)
    with pytest.raises(ValueError, match="canonical"):
        sk.compare_sketches(a, c)
    empty = sk._make(5, 10, False, np.empty(0, np.uint64), "e")
    r = sk.compare_sketches(empty, empty)
    assert r["jaccard"] == 1.0 and r["mash_distance"] == 0.0
    r = sk.compare_sketches(a, empty)
    assert r["jaccard"] == 0.0 and r["mash_distance"] == 1.0


@pytest.mark.heavy
def test_cli_sketch_and_similarity(tmp_path, fixtures_dir):
    fa = os.path.join(fixtures_dir, "tiny.fa")
    r = _cli(["sketch", "-i", fa, "-k", "4", "-o", "a.json.gz"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["count", "-i", fa, "-k", "4", "-o", "a.tsv"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["sketch", "-i", "a.tsv", "-o", "b.json"], tmp_path)
    assert r.returncode == 0, r.stderr
    loaded = sk.read_sketch(str(tmp_path / "a.json.gz"))
    assert loaded["format"] == sk.SKETCH_FORMAT and loaded["k"] == 4

    # sketch-vs-sketch: identical sample -> jaccard 1
    r = _cli(["similarity", "-i", "a.json.gz", "b.json", "--json"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    d = json.loads(r.stdout)
    assert d["jaccard"] == 1.0 and d["shared"] == d["sample_size"] > 0

    # mixed sketch + spectrum file
    r = _cli(["similarity", "-i", "a.json.gz", "a.tsv", "--json"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["jaccard"] == 1.0

    # plain spectra still take the exact path (has containment keys)
    r = _cli(["similarity", "-i", "a.tsv", "a.tsv", "--json"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "containment_a_in_b" in json.loads(r.stdout)


@pytest.mark.heavy
def test_cli_similarity_pairwise_matrix(tmp_path, fixtures_dir):
    fa = os.path.join(fixtures_dir, "tiny.fa")
    db = os.path.join(fixtures_dir, "debruijn4.fa")
    for name, src in [("a", fa), ("b", db), ("c", fa)]:
        r = _cli(["sketch", "-i", src, "-k", "4", "-o", f"{name}.json",
                  "--name", name], tmp_path)
        assert r.returncode == 0, r.stderr
    r = _cli(["similarity", "-i", "a.json", "b.json", "c.json",
              "--json"], tmp_path)
    assert r.returncode == 0, r.stderr
    rows = json.loads(r.stdout)
    assert len(rows) == 3  # 3 unordered pairs
    by_pair = {(d["name_a"], d["name_b"]): d for d in rows}
    assert by_pair[("a", "c")]["jaccard"] == 1.0  # same sample
    assert by_pair[("a", "b")]["jaccard"] < 1.0
    # text mode: header + one row per pair
    r = _cli(["similarity", "-i", "a.json", "b.json", "c.json"], tmp_path)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("a\tb\tjaccard") and len(lines) == 4
    # single input is a clean error
    r = _cli(["similarity", "-i", "a.json"], tmp_path)
    assert r.returncode != 0 and "at least two" in r.stderr


@pytest.mark.heavy
def test_cli_sketch_per_input(tmp_path, fixtures_dir):
    fa = os.path.join(fixtures_dir, "tiny.fa")
    db = os.path.join(fixtures_dir, "debruijn4.fa")
    r = _cli(["sketch", "-i", fa, db, "-k", "4", "--per-input",
              "-o", "sk"], tmp_path)
    assert r.returncode == 0, r.stderr
    a = tmp_path / "sk" / "tiny.sketch.json"
    b = tmp_path / "sk" / "debruijn4.sketch.json"
    assert a.exists() and b.exists()
    assert sk.read_sketch(str(a))["name"] == fa
    # per-input sketches equal individually-made sketches
    one = sk.sketch_sequences([fa], 4, s=1000)
    assert sk.read_sketch(str(a))["hashes"] == one["hashes"]
    # guards: missing -k, missing -o DIR
    r = _cli(["sketch", "-i", fa, "--per-input", "-o", "sk"], tmp_path)
    assert r.returncode != 0 and "requires -k" in r.stderr
    r = _cli(["sketch", "-i", fa, "-k", "4", "--per-input"], tmp_path)
    assert r.returncode != 0 and "-o DIR" in r.stderr


@pytest.mark.heavy
def test_cli_info_on_sketch(tmp_path, fixtures_dir):
    fa = os.path.join(fixtures_dir, "tiny.fa")
    r = _cli(["sketch", "-i", fa, "-k", "4", "-o", "a.json",
              "--name", "tiny"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["info", "a.json", "--json"], tmp_path)
    assert r.returncode == 0, r.stderr
    d = json.loads(r.stdout)
    assert d["format"] == sk.SKETCH_FORMAT
    assert d["name"] == "tiny" and d["k"] == 4 and d["n_hashes"] > 0


@pytest.mark.heavy
def test_cli_sketch_errors(tmp_path, fixtures_dir):
    fa = os.path.join(fixtures_dir, "tiny.fa")
    r = _cli(["sketch", "-i", fa, "x"], tmp_path)  # two inputs, no -k
    assert r.returncode != 0
    assert "exactly one spectrum file" in r.stderr
    r = _cli(["sketch", "-i", fa, "-k", "5", "-o", "a5.json"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["sketch", "-i", fa, "-k", "6", "-o", "a6.json"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli(["similarity", "-i", "a5.json", "a6.json"], tmp_path)
    assert r.returncode != 0
    assert "k mismatch" in r.stderr
