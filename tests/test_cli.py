"""Golden CLI tests: `findkmer count` output vs oracle spectra
(SURVEY.md §4.2 golden CLI tests)."""

import os
import subprocess
import sys

import pytest

from oracle.scalar import count_fasta_file, spectrum_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every test here shells out to the CLI (subprocess + fresh jax init):
# the whole module is the heavy tier
pytestmark = pytest.mark.heavy


def run_cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # PYTHONPATH set to the repo only: the subprocess imports this
    # checkout's package
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli"] + args,
        capture_output=True,
        text=True,
        env=env,
        cwd=str(tmp_path),
        timeout=600,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("zeros", [False, True])
def test_count_golden(fixtures_dir, tmp_path, k, zeros):
    path = os.path.join(fixtures_dir, "tiny.fa")
    args = ["count", "-i", path, "-k", str(k), "--chunk-len", "64",
            "--batch-rows", "2"]
    if zeros:
        args.append("-z")
    out = run_cli(args, tmp_path)
    want = spectrum_lines(count_fasta_file(path, k), k, zeros=zeros)
    assert out.splitlines() == want


def test_count_canonical_golden(fixtures_dir, tmp_path):
    path = os.path.join(fixtures_dir, "multi.fa")
    out = run_cli(
        ["count", "-i", path, "-k", "5", "--canonical", "--chunk-len",
         "128", "--batch-rows", "2"],
        tmp_path,
    )
    want = spectrum_lines(
        count_fasta_file(path, 5, canonical=True), 5, zeros=False
    )
    assert out.splitlines() == want


def test_count_multiple_inputs(fixtures_dir, tmp_path):
    p1 = os.path.join(fixtures_dir, "tiny.fa")
    p2 = os.path.join(fixtures_dir, "debruijn4.fa")
    out = run_cli(
        ["count", "-i", p1, p2, "-k", "4", "--chunk-len", "64",
         "--batch-rows", "2"],
        tmp_path,
    )
    a = count_fasta_file(p1, 4)
    b = count_fasta_file(p2, 4)
    for kk, v in b.items():
        a[kk] = a.get(kk, 0) + v
    assert out.splitlines() == spectrum_lines(a, 4)


def test_output_file_and_sep(fixtures_dir, tmp_path):
    path = os.path.join(fixtures_dir, "tiny.fa")
    outfile = tmp_path / "out.tsv"
    run_cli(
        ["count", "-i", path, "-k", "4", "-o", str(outfile), "--sep", ","],
        tmp_path,
    )
    want = spectrum_lines(count_fasta_file(path, 4), 4, sep=",")
    assert outfile.read_text().splitlines() == want


def test_stats_subcommand(fixtures_dir, tmp_path):
    import json

    path = os.path.join(fixtures_dir, "tiny.fa")
    out = run_cli(["stats", "-i", path, "-k", "4"], tmp_path)
    d = json.loads(out)
    assert d["records"] == 2
    assert d["bases"] == 14 + 8
    assert d["valid_bases"] == 12 + 8


def test_cli_devices_mesh_matches_oracle(tmp_path, fixtures_dir):
    """`findkmer count --devices 8` on the CPU mesh == single-device
    output (VERDICT item 5: CLI-reachable distribution)."""
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    args = ["count", "-i", src, "-k", "6", "--chunk-len", "512",
            "--batch-rows", "8"]
    single = run_cli(args, tmp_path)
    multi = run_cli(args + ["--devices", "8"], tmp_path)
    assert single == multi

    rs = run_cli(args + ["--devices", "8", "--merge", "psum_scatter"],
                 tmp_path)
    assert rs == single


@pytest.mark.parametrize("k", [6, 18])
def test_count_dtype_int64(fixtures_dir, tmp_path, k):
    """--count-dtype int64 (x64 mode) matches int32 output exactly —
    run in subprocesses since x64 is process-global (ROADMAP item 8)."""
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    args = ["count", "-i", path, "-k", str(k), "--chunk-len", "512",
            "--batch-rows", "2"]
    a = run_cli(args, tmp_path)
    b = run_cli(args + ["--count-dtype", "int64"], tmp_path)
    assert a == b


@pytest.mark.parametrize("k", [4, 21])
def test_count_thresholds(fixtures_dir, tmp_path, k):
    """--min-count/--max-count = KMC -ci/-cx output filter, dense and
    sparse paths."""
    path = os.path.join(fixtures_dir, "tiny.fa")
    out = run_cli(
        ["count", "-i", path, "-k", str(k), "--chunk-len", "64",
         "--batch-rows", "2", "--min-count", "2", "--max-count", "3"],
        tmp_path,
    )
    spec = count_fasta_file(path, k)
    want = [
        line
        for line in spectrum_lines(spec, k)
        if 2 <= int(line.rsplit("\t", 1)[1]) <= 3
    ]
    assert out.splitlines() == want

def test_per_record_sections_match_oracle(fixtures_dir, tmp_path):
    """--per-record: one '>header' section per record, each spectrum
    bit-exact vs the oracle on that record alone (multi.fa has N runs,
    IUPAC codes, and empty records)."""
    from oracle.scalar import count_kmers_in_text, parse_fasta_text

    path = os.path.join(fixtures_dir, "multi.fa")
    out = run_cli(
        ["count", "-i", path, "-k", "4", "--per-record",
         "--chunk-len", "64", "--batch-rows", "2"],
        tmp_path,
    )
    records = parse_fasta_text(open(path).read())
    want_lines = []
    for header, seq in records:
        want_lines.append(f">{header}")
        want_lines.extend(
            spectrum_lines(count_kmers_in_text(seq, 4), 4)
        )
    assert out.splitlines() == want_lines


def test_per_record_sparse_and_fastq(fixtures_dir, tmp_path):
    """--per-record with a sparse table, and per-read FASTQ sections."""
    from oracle.scalar import count_kmers_in_text, parse_fasta_text

    path = os.path.join(fixtures_dir, "tiny.fa")
    out = run_cli(
        ["count", "-i", path, "-k", "4", "--per-record",
         "--table-mode", "sparse", "--chunk-len", "64",
         "--batch-rows", "2"],
        tmp_path,
    )
    records = parse_fasta_text(open(path).read())
    want = []
    for header, seq in records:
        want.append(f">{header}")
        want.extend(spectrum_lines(count_kmers_in_text(seq, 4), 4))
    assert out.splitlines() == want

    fq = tmp_path / "r.fastq"
    fq.write_text(
        "@r1\nACGTACGTAC\n+\nIIIIIIIIII\n@r2\nGGGCCCNAAA\n+\nIIIIIIIIII\n"
    )
    out = run_cli(
        ["count", "-i", str(fq), "-k", "3", "--per-record",
         "--chunk-len", "64", "--batch-rows", "2"],
        tmp_path,
    )
    want = []
    for header, seq in (("r1", "ACGTACGTAC"), ("r2", "GGGCCCNAAA")):
        want.append(f">{header}")
        want.extend(spectrum_lines(count_kmers_in_text(seq, 3), 3))
    assert out.splitlines() == want


def test_per_input_directory(fixtures_dir, tmp_path):
    """--per-input: one <stem>.tsv per input file in -o DIR."""
    t = os.path.join(fixtures_dir, "tiny.fa")
    m = os.path.join(fixtures_dir, "multi.fa")
    run_cli(
        ["count", "-i", t, m, "-k", "4", "--per-input", "-o", "specs",
         "--chunk-len", "64", "--batch-rows", "2"],
        tmp_path,
    )
    for src, name in ((t, "tiny.tsv"), (m, "multi.tsv")):
        got = (tmp_path / "specs" / name).read_text()
        want = "\n".join(
            spectrum_lines(count_fasta_file(src, 4), 4)
        ) + "\n"
        assert got == want, name


def test_per_input_needs_dir(fixtures_dir, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", "count", "-i",
         os.path.join(fixtures_dir, "tiny.fa"), "-k", "4",
         "--per-input"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600,
    )
    assert res.returncode == 2  # trouble (GNU convention), not diff's 1
    assert "directory" in res.stderr

def test_bench_phases(tmp_path):
    """bench --phases emits a JSON report with per-phase timings."""
    import json as json_mod

    out = run_cli(["bench", "-k", "4", "--gbases", "0.0001", "--phases"],
                  tmp_path)
    rep = json_mod.loads(out.splitlines()[-1])
    assert rep["bases"] == 100000
    assert {"dispatch", "finalize", "host_batches", "write"} <= set(
        rep["phases"]
    )
    assert rep["bases_per_s"] > 0


def _run_cli_stdin(args, tmp_path, stdin_bytes):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli"] + args,
        input=stdin_bytes, capture_output=True, env=env,
        cwd=str(tmp_path), timeout=600,
    )
    assert res.returncode == 0, res.stderr.decode()
    return res.stdout.decode()


def test_count_stdin_matches_file(fixtures_dir, tmp_path):
    """-i - reads FASTA from stdin; output identical to the file path."""
    path = os.path.join(fixtures_dir, "tiny.fa")
    want = run_cli(["count", "-i", path, "-k", "4", "--chunk-len", "64",
                    "--batch-rows", "2"], tmp_path)
    got = _run_cli_stdin(
        ["count", "-i", "-", "-k", "4", "--chunk-len", "64",
         "--batch-rows", "2"],
        tmp_path, open(path, "rb").read(),
    )
    assert got == want


def test_count_stdin_gzip_and_fastq(fixtures_dir, tmp_path):
    """stdin is gunzipped by magic bytes and format-sniffed (FASTQ)."""
    import gzip as gz

    path = os.path.join(fixtures_dir, "tiny.fa")
    want = run_cli(["count", "-i", path, "-k", "5"], tmp_path)
    got = _run_cli_stdin(["count", "-i", "-", "-k", "5"], tmp_path,
                         gz.compress(open(path, "rb").read()))
    assert got == want

    fq = b"@r1\nACGTACGTAC\n+\nIIIIIIIIII\n"
    got_fq = _run_cli_stdin(["count", "-i", "-", "-k", "4"], tmp_path, fq)
    from oracle.scalar import count_kmers_in_records

    want_fq = spectrum_lines(
        count_kmers_in_records(["ACGTACGTAC"], 4), 4
    )
    assert got_fq.splitlines() == want_fq


def test_stats_stdin(fixtures_dir, tmp_path):
    import json as json_mod

    path = os.path.join(fixtures_dir, "multi.fa")
    out = _run_cli_stdin(["stats", "-i", "-", "-k", "8"], tmp_path,
                         open(path, "rb").read())
    d = json_mod.loads(out)
    want = json_mod.loads(run_cli(["stats", "-i", path, "-k", "8"],
                                  tmp_path))
    assert d == want


def test_gzip_output_by_extension(fixtures_dir, tmp_path):
    """-o file.gz writes gzip; content identical to the plain output."""
    import gzip as gz

    path = os.path.join(fixtures_dir, "tiny.fa")
    want = run_cli(["count", "-i", path, "-k", "4"], tmp_path)
    run_cli(["count", "-i", path, "-k", "4", "-o", "out.tsv.gz"],
            tmp_path)
    raw = (tmp_path / "out.tsv.gz").read_bytes()
    assert raw[:2] == b"\x1f\x8b"
    assert gz.decompress(raw).decode() == want


def test_query_kmers_file(fixtures_dir, tmp_path):
    path = os.path.join(fixtures_dir, "tiny.fa")
    run_cli(["count", "-i", path, "-k", "4", "-o", "s.tsv"], tmp_path)
    (tmp_path / "q.txt").write_text("ACGT\nCGTA TTTT\n")
    out = run_cli(["query", "s.tsv", "--kmers-file", "q.txt"], tmp_path)
    lines = dict(l.split("\t") for l in out.splitlines())
    want = spectrum_lines(count_fasta_file(path, 4), 4)
    wantd = dict(l.split("\t") for l in want)
    assert lines["ACGT"] == wantd["ACGT"]
    assert lines["TTTT"] == wantd.get("TTTT", "0")


def test_count_devices_sparse_streamed_finalize(fixtures_dir, tmp_path):
    """count --devices 8 on a sparse k routes through the dp_sparse
    streamed finalize (DistributedCounter.finalize_chunks); output is
    byte-identical to the single-device engine."""
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    one = run_cli(["count", "-i", src, "-k", "21", "--chunk-len", "1024",
                   "--batch-rows", "8", "-o", "one.tsv"], tmp_path)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    res = subprocess.run(
        [sys.executable, "-m", "findkmer_tpu.cli", "count", "-i", src,
         "-k", "21", "--chunk-len", "1024", "--batch-rows", "8",
         "--devices", "8", "-o", "eight.tsv"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600,
    )
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "one.tsv").read_bytes() == (
        tmp_path / "eight.tsv"
    ).read_bytes()
