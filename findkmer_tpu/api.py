"""Public Python API — the library-user surface of findkmer-tpu.

The CLI (cli.py) is a thin wrapper over these functions; library users
get the same capabilities without subprocesses:

    import findkmer_tpu as fk

    spec = fk.count(["genome.fa"], k=8)            # Spectrum
    spec["ACGTACGT"]                               # -> count
    spec.to_dict()                                 # {kmer: count}
    spec.total(), spec.distinct()
    spec.histo()                                   # count-of-counts
    fk.count(["a.fa"], k=21, canonical=True).write("out.tsv")
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from findkmer_tpu.config import Config


@dataclass
class Spectrum:
    """A finalized k-mer spectrum (dense or sparse backing)."""

    k: int
    canonical: bool
    _dense: Optional[np.ndarray] = None            # (4^k,) counts
    _codes: Optional[np.ndarray] = None            # sorted uint64 codes
    _counts: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @classmethod
    def from_engine(cls, spectrum, cfg: Config) -> "Spectrum":
        if isinstance(spectrum, tuple):
            codes, counts = spectrum
            return cls(
                k=cfg.k, canonical=cfg.canonical,
                _codes=np.asarray(codes, dtype=np.uint64),
                _counts=np.asarray(counts),
            )
        return cls(
            k=cfg.k, canonical=cfg.canonical, _dense=np.asarray(spectrum)
        )

    # ------------------------------------------------------------------
    def __getitem__(self, kmer: Union[str, int]) -> int:
        from findkmer_tpu.ops.window import str_to_code

        code = str_to_code(kmer) if isinstance(kmer, str) else int(kmer)
        if self._dense is not None:
            return int(self._dense[code])
        i = np.searchsorted(self._codes, np.uint64(code))
        if i < self._codes.size and self._codes[i] == np.uint64(code):
            return int(self._counts[i])
        return 0

    def total(self) -> int:
        arr = self._dense if self._dense is not None else self._counts
        return int(arr.sum())

    def distinct(self) -> int:
        if self._dense is not None:
            return int(np.count_nonzero(self._dense))
        return int(self._counts.size)

    def items(self) -> Iterable[Tuple[str, int]]:
        """(kmer, count) pairs in lexicographic order, zeros skipped."""
        from findkmer_tpu.ops.window import code_to_str

        if self._dense is not None:
            for code in np.nonzero(self._dense)[0]:
                yield code_to_str(int(code), self.k), int(self._dense[code])
        else:
            for code, cnt in zip(self._codes, self._counts):
                yield code_to_str(int(code), self.k), int(cnt)

    def to_dict(self) -> Dict[str, int]:
        return dict(self.items())

    def histo(self, max_count: int = 10000) -> np.ndarray:
        """Count-of-counts: h[m] = number of distinct k-mers seen m times
        (m clipped to max_count; h[0] unused)."""
        counts = (
            self._dense[self._dense > 0]
            if self._dense is not None
            else self._counts
        )
        clipped = np.minimum(counts.astype(np.int64), max_count)
        return np.bincount(clipped, minlength=max_count + 1)

    def write(self, path_or_file, *, zeros: bool = False, sep: str = "\t"):
        """Write the spectrum in CLI format (lexicographic KMER<sep>COUNT)."""
        from findkmer_tpu import output as output_mod

        cfg = Config(
            k=self.k, canonical=self.canonical, zeros=zeros, sep=sep,
            table_mode="direct" if self._dense is not None else "sparse",
        )
        spectrum = (
            self._dense
            if self._dense is not None
            else (self._codes, self._counts)
        )
        if hasattr(path_or_file, "write"):
            return output_mod.write_spectrum(path_or_file, spectrum, cfg)
        with open(path_or_file, "wb") as f:
            return output_mod.write_spectrum(f, spectrum, cfg)


def count(
    inputs: Union[str, Sequence[str]],
    k: int,
    *,
    canonical: Optional[bool] = None,
    config: Optional[Config] = None,
    **config_overrides,
) -> Spectrum:
    """Count k-mers in FASTA file(s); returns a Spectrum.

    Extra keyword arguments become Config fields (e.g. chunk_len=...,
    table_mode="sparse", hist="onehot").  canonical=None (default)
    keeps config's setting — passing config=Config(canonical=True)
    used to be silently clobbered by this keyword's old False default.
    """
    from findkmer_tpu.models.counter import make_counter
    from findkmer_tpu import pipeline

    if isinstance(inputs, (str, bytes)):
        inputs = [inputs]
    cfg = config or Config(k=k)
    if canonical is not None:
        config_overrides["canonical"] = canonical
    cfg = cfg.replace(k=k, **config_overrides)
    counter = make_counter(cfg)
    state = counter.init_state()
    for path in inputs:
        for rows in pipeline.prefetch_to_device(
            pipeline.batches_from_file(path, cfg), cfg.prefetch,
            put=counter.put_batch,
        ):
            state = counter.step(state, rows)
    return Spectrum.from_engine(counter.finalize(state), cfg)


def count_per_record(
    inputs: Union[str, Sequence[str]],
    k: int,
    *,
    canonical: Optional[bool] = None,
    config: Optional[Config] = None,
    **config_overrides,
):
    """Yield (header, Spectrum) per FASTA record / FASTQ read.

    The device program compiles once and is reused across records
    (pipeline.per_record_spectra); memory is bounded by one record's
    spectrum.  CLI equivalent: `findkmer count --per-record`.
    canonical=None (default) keeps config's setting."""
    from findkmer_tpu.models.counter import make_counter
    from findkmer_tpu import pipeline

    if isinstance(inputs, (str, bytes)):
        inputs = [inputs]
    cfg = config or Config(k=k)
    if canonical is not None:
        config_overrides["canonical"] = canonical
    cfg = cfg.replace(k=k, **config_overrides)
    counter = make_counter(cfg)
    for path in inputs:
        for header, spectrum in pipeline.per_record_spectra(
            path, cfg, counter=counter
        ):
            yield header, Spectrum.from_engine(spectrum, cfg)


def count_text(text: str, k: int, **kw) -> Spectrum:
    """Count k-mers in in-memory FASTA text (convenience for small data)."""
    import io as iomod

    from findkmer_tpu.io.fasta import FastaReader
    from findkmer_tpu.models.counter import KmerCounter
    from findkmer_tpu import pipeline

    cfg = Config(k=k, **{kk: v for kk, v in kw.items()})
    counter = KmerCounter(cfg)
    state = counter.init_state()
    reader = FastaReader(iomod.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(reader, prefer_native=False), cfg
    ):
        state = counter.step(state, rows)
    return Spectrum.from_engine(counter.finalize(state), cfg)


def sketch_sample(
    inputs: Union[str, Sequence[str]],
    k: Optional[int] = None,
    *,
    s: int = 1000,
    canonical: bool = False,
    **config_overrides,
):
    """Bottom-s MinHash sketch (dict, sketch.SKETCH_FORMAT).

    With k: sequence input(s), counted as ONE sample like count().
    Without k: `inputs` is one spectrum file path (k inferred).
    CLI equivalent: `findkmer sketch`."""
    from findkmer_tpu import sketch as sketch_mod

    if k is not None:
        if isinstance(inputs, (str, bytes)):
            inputs = [inputs]
        return sketch_mod.sketch_sequences(
            inputs, k, s=s, canonical=canonical, **config_overrides
        )
    if not isinstance(inputs, (str, bytes)):
        raise ValueError("without k, pass one spectrum file path")
    return sketch_mod.sketch_spectrum_file(inputs, s=s, canonical=canonical)


def filter_reads(
    inputs: Union[str, Sequence[str]],
    spectrum: str,
    output: Union[str, Sequence[str]],
    *,
    paired: bool = False,
    min_hits: int = 1,
    min_frac: Optional[float] = None,
    invert: bool = False,
    canonical: bool = False,
    min_count: int = 0,
    max_count: int = 0,
    engine: str = "auto",
    pair_mode: str = "any",
    fmt: str = "auto",
    sep: str = "\t",
):
    """Filter reads by spectrum membership.  CLI: `findkmer filter`.

    Single-end: inputs = path or list of paths, output = one path.
    Paired (paired=True): inputs = (R1, R2), output = (OUT1, OUT2);
    pairs are kept/dropped together (pair_mode "any" or "both").
    engine: "host" (OpenMP C scan) / "device" (sort-merge probe on the
    accelerator) / "auto".  Returns (reads_or_pairs_kept, seen)."""
    from findkmer_tpu.cli import _open_out  # gz-by-extension, like the CLI
    from findkmer_tpu.filter import (FilterSpec, filter_file,
                                     filter_file_paired)

    spec = FilterSpec.load(
        spectrum, sep=sep, canonical=canonical,
        min_count=min_count, max_count=max_count,
    )
    if paired:
        ins = list(inputs)
        outs = list(output)
        if len(ins) != 2 or len(outs) != 2:
            raise ValueError(
                "paired filtering takes inputs=(R1, R2) and "
                "output=(OUT1, OUT2)"
            )
        f1, c1 = _open_out(outs[0])
        try:
            f2, c2 = _open_out(outs[1])
        except BaseException:
            if c1:
                f1.close()
            raise
        try:
            return filter_file_paired(
                ins[0], ins[1], f1, f2, spec, fmt=fmt,
                min_hits=min_hits, min_frac=min_frac, invert=invert,
                engine=engine, pair_mode=pair_mode,
            )
        finally:
            if c1:
                f1.close()
            if c2:
                f2.close()
    if isinstance(inputs, (str, bytes)):
        inputs = [inputs]
    kept = seen = 0
    f, close = _open_out(output)
    try:
        for path in inputs:
            k1, s1 = filter_file(
                path, f, spec, fmt=fmt, min_hits=min_hits,
                min_frac=min_frac, invert=invert, engine=engine,
            )
            kept += k1
            seen += s1
    finally:
        if close:
            f.close()
    return kept, seen


def matrix(
    inputs: Sequence[str],
    output: str,
    *,
    names: Optional[Sequence[str]] = None,
    min_total: int = 0,
    min_samples: int = 0,
    sep: str = "\t",
) -> int:
    """k-mer x sample count matrix from sorted spectrum files.
    CLI: `findkmer matrix`.  Returns data rows written."""
    from findkmer_tpu import spectra
    from findkmer_tpu.cli import _input_stems, _open_out

    inputs = list(inputs)
    use_names = list(names) if names is not None else _input_stems(inputs)
    if len(use_names) != len(inputs):
        # validate BEFORE _open_out truncates an existing output
        raise ValueError(
            f"matrix needs one name per input ({len(inputs)} inputs, "
            f"{len(use_names)} names)"
        )
    f, close = _open_out(output)
    try:
        return spectra.matrix_sorted_streaming(
            inputs, f, use_names, sep=sep,
            min_total=min_total, min_samples=min_samples,
        )
    finally:
        if close:
            f.close()


def expr(
    expression: str,
    inputs: Dict[str, str],
    output: Optional[str] = None,
    *,
    canonical: bool = False,
    sep: str = "\t",
):
    """Set-algebra expression over sorted spectrum files.
    CLI: `findkmer expr`.

    With output=None returns {kmer: count}; with an output path writes
    KMER<sep>COUNT lines (streaming, O(buffers)) and returns the line
    count."""
    from findkmer_tpu import spectra

    if output is None:
        if canonical:
            names = sorted(inputs)
            with spectra._CanonizedInputs(
                [inputs[n] for n in names], sep
            ) as folded:
                return {
                    km.decode(): c
                    for km, c in spectra.eval_expression(
                        expression, dict(zip(names, folded)), sep
                    )
                }
        return {
            km.decode(): c
            for km, c in spectra.eval_expression(expression, inputs, sep)
        }
    from findkmer_tpu.cli import _open_out

    f, close = _open_out(output)
    try:
        return spectra.expr_sorted_streaming(
            expression, inputs, f, sep=sep, canonical=canonical
        )
    finally:
        if close:
            f.close()


def similarity(a, b, *, canonical: bool = False, sep: str = "\t"):
    """Similarity metrics between two spectrum files, or two sketch
    dicts/files (Mash estimator).  CLI: `findkmer similarity`."""
    from findkmer_tpu import sketch as sketch_mod
    from findkmer_tpu import spectra

    def _as_sketch(x):
        if isinstance(x, dict):
            return x
        return sketch_mod.read_sketch(x)

    a_sk = isinstance(a, dict) or (
        isinstance(a, (str, bytes)) and sketch_mod.is_sketch_file(a)
    )
    b_sk = isinstance(b, dict) or (
        isinstance(b, (str, bytes)) and sketch_mod.is_sketch_file(b)
    )
    if a_sk or b_sk:
        ref = _as_sketch(a if a_sk else b)
        if canonical and not bool(ref["canonical"]):
            # folding only the spectrum side would always fail
            # compare_sketches' mismatch guard AFTER the (potentially
            # long) sketch work — reject up front, like the CLI does
            raise ValueError(
                "canonical=True cannot apply to a non-canonical "
                f"sketch ({ref.get('name', '?')}); re-sketch it "
                "canonically or drop the flag"
            )
        sa = _as_sketch(a) if a_sk else sketch_mod.sketch_spectrum_file(
            a, s=int(ref["s"]), sep=sep,
            canonical=bool(ref["canonical"]) or canonical)
        sb = _as_sketch(b) if b_sk else sketch_mod.sketch_spectrum_file(
            b, s=int(ref["s"]), sep=sep,
            canonical=bool(ref["canonical"]) or canonical)
        return sketch_mod.compare_sketches(sa, sb)
    return spectra.similarity_spectra(a, b, sep=sep, canonical=canonical)
