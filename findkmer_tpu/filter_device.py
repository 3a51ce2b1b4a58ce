"""Device read-filtering engine: spectrum membership on the accelerator.

`findkmer filter --engine device` scores reads with the same machinery
the counter uses (the packed H2D wire + a device membership probe):

  host   reads -> 'N'-joined stream -> packed 2-bit wire (0.375 B/base,
         pipeline._numpy_pack_rows / native pack_rows)
  device window_codes_packed extraction (the counting kernel), then a
         SORT-MERGE membership probe: [spectrum codes | window codes]
         are sorted together with an int32 payload (member = -1, query
         = its window slot); a member sorts FIRST within its equal-code
         run, so "query hits" is one forward cummax scan — no gathers,
         no binary search (searchsorted would cost ~25 gather passes;
         whether it wins on the H100 is ROADMAP S8).
  unsort one 1-key sort of (slot << 1 | hit) restores window order (the
         hit bit rides the key's LSB), then 32 bits pack per uint32
         word -> the D2H wire carries 1 bit/window.
  host   per-read attribution: unpack the bitmap, cumsum, span sums —
         identical arithmetic to the host engine (filter.py), so the
         two engines are bit-for-bit interchangeable.

Validity never crosses the wire: a read's VALID window count depends
only on its bases, so the host computes it locally; invalid windows
extract as all-ones sentinel codes, which no spectrum member can equal
(member hi < 2^14 wide / code < 2^30 narrow), so their hit bits are
structurally 0.

The reference has no filtering tool (SURVEY.md §2.1); this implements
the kmc_tools `filter` class (PAPERS.md landscape) on the device.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import numpy as np

from findkmer_tpu.ops import sparse as sparse_ops

# unsort key for non-query rows (members, padding): int32 max sorts
# after every real (slot << 1 | hit) key, slot < 2^30
_KEY_MAX = np.int32(2**31 - 1)
_PAD_PAY = np.int32(2**30)


@partial(jax.jit, static_argnames=("k", "canonical", "R", "L"))
def _filter_step(members, packed, validbits, k: int, canonical: bool,
                 R: int, L: int):
    """One device batch -> (B*L//32,) uint32 hit bitmap in window order.

    members: ((hi,)? lo, pay) spectrum planes, pay == -1 for real
    members (pads carry _PAD_PAY and sentinel codes).  Window slot s of
    row b covers the joined stream position b*L + s - (k-1) relative to
    this batch's first owned base."""
    import jax.numpy as jnp
    from jax import lax

    from findkmer_tpu.ops import window as window_ops

    parts = window_ops.window_codes_packed(
        packed, validbits, k, canonical, R=R
    )
    B = packed.shape[0]
    NW = parts[0].shape[0] // (16 * B)
    # element (r, b, w) of the residue-interleaved layout is the window
    # starting at row position s = 16*w + r (window.py docstring); only
    # s <= R - k (= L - 1) are real windows, the rest are padding
    shape = (16, B, NW)
    r_idx = lax.broadcasted_iota(jnp.int32, shape, 0)
    b_idx = lax.broadcasted_iota(jnp.int32, shape, 1)
    w_idx = lax.broadcasted_iota(jnp.int32, shape, 2)
    s = 16 * w_idx + r_idx
    slot = jnp.where(s < L, b_idx * jnp.int32(L) + s, _PAD_PAY)
    slot = slot.reshape(-1)

    if len(parts) == 1:
        lo = jnp.concatenate([members[0], parts[0]])
        pay = jnp.concatenate([members[1], slot])
        lo, pay = lax.sort((lo, pay), num_keys=2, is_stable=False)
        hi = jnp.zeros_like(lo)
    else:
        # narrow the window hi plane to the member plane's dtype BEFORE
        # concatenate (16<=k<=23: uint16; the truncating cast maps the
        # uint32 sentinel to 0xFFFF losslessly, counter.py _narrow_hi) —
        # otherwise jnp.concatenate promotes the members back to uint32
        # and the 3-key sort runs at 8 B/elem instead of 6
        hi = jnp.concatenate([members[0],
                              parts[0].astype(members[0].dtype)])
        lo = jnp.concatenate([members[1], parts[1]])
        pay = jnp.concatenate([members[2], slot])
        hi, lo, pay = lax.sort((hi, lo, pay), num_keys=3,
                               is_stable=False)

    # member-first runs: payload is the last sort key and members carry
    # -1, so a run containing a member has it at the run START; one
    # monotone cummax propagates "my run starts with a member"
    n = hi.shape[0]
    is_start, _ = sparse_ops._adj_flags(hi, lo)
    idx = jnp.arange(n, dtype=jnp.int32)
    spos = lax.cummax(jnp.where(is_start, idx, 0), axis=0)
    mpos = lax.cummax(jnp.where(is_start & (pay < 0), idx, -1), axis=0)
    is_query = (pay >= 0) & (pay < _PAD_PAY)
    hit = (mpos == spos) & is_query

    key = jnp.where(
        is_query, (pay << 1) | hit.astype(jnp.int32), _KEY_MAX
    )
    (key,) = lax.sort((key,), num_keys=1, is_stable=False)
    bits = (key[: B * L] & 1).astype(jnp.uint32)
    shifts = lax.broadcasted_iota(jnp.uint32, (1, 32), 1)
    return jnp.sum(
        bits.reshape(-1, 32) << shifts, axis=1, dtype=jnp.uint32
    )


class DeviceFilter:
    """Device-resident membership scorer with FilterSpec.hits_batch's
    exact contract: per-read (hits, valid windows) over a batch of
    reads, reads isolated by 'N' separators."""

    def __init__(self, spec, batch_rows: int = 256,
                 chunk_len: int = 65536):
        import jax
        import jax.numpy as jnp

        self.spec = spec
        self.k = k = spec.k
        self.canonical = spec.canonical
        self.B, self.L = batch_rows, chunk_len
        self.R = chunk_len + k - 1
        self.R8 = (self.R + 7) // 8 * 8
        self.need = self.B * self.L  # owned bases per device batch
        # _filter_step packs (slot << 1 | hit) into int32 payloads and
        # reshapes the hit bits (B*L,) -> (-1, 32): past 2^30 slots the
        # shifted payload would overflow SILENTLY, so guard loudly
        if self.need > 1 << 30:
            raise ValueError(
                f"batch_rows * chunk_len = {self.need} exceeds the "
                "2^30 slot limit of the int32 payload packing; use a "
                "smaller batch geometry"
            )
        if self.need % 32:
            raise ValueError(
                f"batch_rows * chunk_len = {self.need} must be a "
                "multiple of 32 (hit-bitmap word packing)"
            )

        codes = spec.codes  # sorted distinct uint64
        ns = int(codes.size)
        NS = sparse_ops.ladder(max(ns, 1), floor=4096)
        pay = np.full(NS, -1, np.int32)
        pay[ns:] = _PAD_PAY
        if k <= 15:
            lo = np.full(NS, sparse_ops.SENTINEL, np.uint32)
            lo[:ns] = codes.astype(np.uint32)
            planes = (lo, pay)
        else:
            hdt = sparse_ops.hi_dtype(k)
            hi = np.full(NS, sparse_ops.sent_of(hdt), hdt)
            lo = np.full(NS, sparse_ops.SENTINEL, np.uint32)
            hi[:ns] = (codes >> np.uint64(32)).astype(hdt)
            lo[:ns] = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            planes = (hi, lo, pay)
        dev = jax.local_devices()[0]
        self.members = tuple(
            jax.device_put(jnp.asarray(p), dev) for p in planes
        )
        self._dev = dev

    # ------------------------------------------------------------------
    def _dispatch_bitmaps(self, work: np.ndarray):
        """work: (k-1 halo ++ owned stream ++ INVALID pad) uint8 codes,
        length k-1 + n_batches*need.  Dispatches every device batch and
        starts its bitmap D2H; returns the list of in-flight device
        arrays WITHOUT blocking (finish() materializes them)."""
        from findkmer_tpu.io import native as native_mod
        from findkmer_tpu.pipeline import _numpy_pack_rows, \
            prefetch_to_device

        k, B, L, R, R8 = self.k, self.B, self.L, self.R, self.R8
        halo = k - 1
        n_batches = (work.size - halo) // self.need

        def host_batches():
            for i in range(n_batches):
                chunk = work[i * self.need : i * self.need + halo
                             + self.need]
                if native_mod.available():
                    yield native_mod.pack_rows(chunk, B, L, R)
                else:
                    yield _numpy_pack_rows(chunk, B, L, R, R8)

        outs = []
        # producer-thread prefetch: batch i+1's pack + H2D overlaps
        # batch i's device sort, the same double-buffering the counting
        # pipeline uses
        for dp, dv in prefetch_to_device(
            host_batches(), 2, device=self._dev
        ):
            bm = _filter_step(
                self.members, dp, dv, k, self.canonical, R, L,
            )
            # start the bitmap's D2H immediately, so every batch's pull
            # is in flight while later batches compute
            try:
                bm.copy_to_host_async()
            except Exception:
                pass
            outs.append(bm)
        return outs

    def begin(self, seqs):
        """Dispatch one read batch's device work without blocking.

        Returns an opaque pending object for finish().  filter_file
        keeps a small deque of these so batch i's D2H and host
        attribution overlap batch i+1's read/pack/sort (cross-flush
        pipelining).

        Host legs run in C when built (fk_filter_prepare /
        fk_filter_bitmap_hits): the numpy LUT/cumsum pair freshly
        faults ~100 MB per 16.7-Mbase flush, which on a lazily-backed VM
        (~0.02 GB/s first touch, ROADMAP D10) cost more than the device
        sort itself."""
        from findkmer_tpu.io import native as native_mod

        k = self.k
        if len(seqs) == 0:
            return (seqs, None, 0)
        joined = b"N".join(seqs)
        buf = np.frombuffer(joined, np.uint8)
        n = buf.size
        nw = n - k + 1
        if nw <= 0:
            return (seqs, None, 0)
        halo = k - 1
        n_batches = -(-n // self.need)
        work = np.full(halo + n_batches * self.need, 4, np.uint8)
        if native_mod.available():
            # one OpenMP LUT pass straight into the work buffer; the
            # bitmap attribution recomputes validity per read in C
            native_mod.filter_prepare(buf, work[halo : halo + n])
            lens = np.fromiter((len(s) for s in seqs), np.int64,
                               len(seqs))
            starts = np.zeros(len(seqs), np.int64)
            np.cumsum(lens[:-1] + 1, out=starts[1:])  # +1: separator
            payload = ("native", buf, starts, lens)
        else:
            from findkmer_tpu.filter import _CODE_LUT, _cumsum01

            b = _CODE_LUT[buf]
            cbad = _cumsum01(b > 3)
            # zero bad bases in [i, i+k) <=> the monotone prefix is
            # flat (equality avoids a subtract buffer)
            valid = cbad[k:] == cbad[:-k]
            # codes 0..3 pass; invalid (255) clamps to 4 = INVALID
            np.minimum(b, 4, out=work[halo : halo + n])
            payload = ("numpy", valid, nw)
        return (seqs, payload, self._dispatch_bitmaps(work))

    def begin_offsets(self, segs, nbases: int, nreads: int):
        """Offsets-flow begin (filter._filter_fastq_offsets): segments
        of (block data, seq_starts, joined_starts, lens, ...) are
        gather-encoded by the C leg straight into the (4-prefilled)
        work buffer — separators and padding are already in place, no
        joined bytes object ever exists on the host."""
        from findkmer_tpu.io import native as native_mod

        k = self.k
        n = nbases + nreads - 1 if nreads else 0  # joined length
        if nreads == 0 or n - k + 1 <= 0:
            return (int(nreads), None, 0)
        halo = k - 1
        n_batches = -(-n // self.need)
        work = np.full(halo + n_batches * self.need, 4, np.uint8)
        view = work[halo : halo + n]
        for data, ss, js, lens, *_ in segs:
            native_mod.filter_gather_prepare(data, ss, js, lens, view)
        payload = ("offsets", [
            (data, ss, js, lens) for data, ss, js, lens, *_ in segs
        ])
        return (int(nreads), payload, self._dispatch_bitmaps(work))

    def finish(self, pending) -> Tuple[np.ndarray, np.ndarray]:
        """Block on a begin()'s device work; per-read (hits, windows)."""
        if pending[1] is None:
            n = pending[0] if isinstance(pending[0], int) else len(
                pending[0]
            )
            return np.zeros(n, np.int64), np.zeros(n, np.int64)
        seqs, payload, outs = pending
        k = self.k
        halo = k - 1
        hostbits = [np.asarray(o) for o in outs]
        words = (
            np.concatenate(hostbits) if len(hostbits) > 1 else
            hostbits[0]
        )
        # window starting at joined position p sits at bitmap index
        # p + halo (row 0's first halo slots cover p < 0)
        if payload[0] == "offsets":
            from findkmer_tpu.io import native as native_mod

            words = np.ascontiguousarray(words)
            hs, ws = [], []
            for data, ss, js, lens in payload[1]:
                h, w = native_mod.filter_bitmap_hits2(
                    data, ss, js, lens, k, words, halo
                )
                hs.append(h)
                ws.append(w)
            return np.concatenate(hs), np.concatenate(ws)
        if payload[0] == "native":
            from findkmer_tpu.io import native as native_mod

            _, buf, starts, lens = payload
            return native_mod.filter_bitmap_hits(
                buf, starts, lens, k, np.ascontiguousarray(words), halo
            )
        from findkmer_tpu.filter import _read_spans

        _, valid, nw = payload
        # view, not astype: unpackbits yields 0/1 uint8, bool is the
        # same itemsize — the cast would fault another nw fresh bytes
        allbits = np.unpackbits(
            words.view(np.uint8), bitorder="little"
        ).view(np.bool_)
        hit = allbits[halo : halo + nw]
        return _read_spans(seqs, hit & valid, valid, k)

    def hits_batch(self, seqs) -> Tuple[np.ndarray, np.ndarray]:
        return self.finish(self.begin(seqs))
