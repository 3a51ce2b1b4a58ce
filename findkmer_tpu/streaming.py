"""Restartable streaming count driver (`findkmer stream`).

Streaming with periodic checkpoints (utils/checkpoint.py) and exact
resume: on restart the deterministic batch stream is replayed and
already-counted batches are skipped without touching the device
(SURVEY.md §5 failure detection / checkpoint-resume).  Composes with
BOTH distribution axes: multi-DEVICE meshes (--devices > 1; the
counter's table_state/restore_state reduce mesh state to one portable
table, parallel/dist.py) and multi-HOST streaming (each host streams
its shard of batches and checkpoints into its own proc subdir; a
killed coordinator group relaunches and resumes collectively).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

from findkmer_tpu import pipeline
from findkmer_tpu.config import Config
from findkmer_tpu.utils import checkpoint as ckpt_mod
from findkmer_tpu.utils.logging import get_logger

log = get_logger("findkmer.stream")


def stream_count(
    paths,
    cfg: Config,
    *,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 64,
    stats: Optional[pipeline.StreamStats] = None,
    num_processes: int = 1,
    process_id: int = 0,
):
    """Count k-mers across `paths` with optional checkpoint/resume.

    Multi-host: with num_processes > 1 this host deterministically takes
    batches process_id, process_id+P, ... of the global batch sequence
    (parallel/multihost.py) and returns its PARTIAL spectrum; partials
    are combined exactly with `findkmer merge` (counting is associative).
    Checkpoint indices are local to this host's subsequence, so resume
    composes with sharding.

    Returns the finalized (possibly partial) spectrum.
    """
    counter, state = _stream_state(
        paths, cfg, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, stats=stats,
        num_processes=num_processes, process_id=process_id,
    )
    spectrum = counter.finalize(state)
    # with a live jax.distributed group the run ends in ONE collective
    # merge of the per-host partials (no TSV tail); every host returns
    # the full spectrum
    from findkmer_tpu.parallel import multihost

    if num_processes > 1 and multihost.group_active():
        log.info("collective merge of %d per-host partials", num_processes)
        spectrum = multihost.allgather_spectrum(spectrum)
    return spectrum


def _stream_state(
    paths,
    cfg: Config,
    *,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 64,
    stats: Optional[pipeline.StreamStats] = None,
    num_processes: int = 1,
    process_id: int = 0,
):
    """The streaming loop up to (but not including) finalize: returns
    (counter, state) so callers choose between finalize() and the
    streamed finalize_chunks() write path."""
    from findkmer_tpu.models.counter import make_counter

    if num_processes > 1:
        # per-process subdirs: checkpoint indices are local to each
        # host's batch subsequence and spill runs carry a per-stream
        # identity token, so hosts sharing a filesystem must never
        # share either directory.  Both remaps live HERE so the public
        # stream_count API gets them too, not just the CLI.
        if checkpoint_dir is not None:
            checkpoint_dir = os.path.join(
                checkpoint_dir, f"proc{process_id:03d}"
            )
        if cfg.spill_dir:
            cfg = cfg.replace(
                spill_dir=os.path.join(cfg.spill_dir,
                                       f"proc{process_id:03d}")
            )
    counter = make_counter(cfg)
    start_batch = 0
    state = None
    if checkpoint_dir is not None:
        loaded = ckpt_mod.load_latest(checkpoint_dir, cfg)
        if loaded is not None:
            start_batch, table, saved_stats, extra = loaded
            # batch_index indexes THIS host's round-robin subsequence
            # (i % num_processes == process_id): resuming under a
            # different host count or id would silently skip the wrong
            # batches — validate like any other semantic config field
            for field, cur in (("num_processes", num_processes),
                               ("process_id", process_id)):
                saved = extra.get(field)
                if saved is not None and saved != cur:
                    raise ValueError(
                        f"checkpoint was written with {field}={saved}; "
                        f"resuming with {field}={cur} would replay the "
                        "wrong batch subsequence — relaunch with the "
                        "original topology"
                    )
            state = counter.restore_state(table)
            # spill composition: adopt the runs the checkpoint's prefix
            # wrote; delete any spilled after it (their batches replay).
            # The identity token stops a resume from adopting/deleting a
            # DIFFERENT count's runs left in the same dir.
            counter.adopt_spill_runs(
                int(extra.get("spill_runs", 0)),
                token=extra.get("spill_token"),
            )
            log.info("resuming from checkpoint at batch %d", start_batch)
    if state is None:
        state = counter.init_state()

    def batches():
        def all_batches():
            for path in paths:
                # stats recount the FULL replayed stream (skipped batches
                # really are re-encoded on the host during the skip), so
                # resumed totals equal a from-scratch run's totals
                yield from pipeline.batches_from_file(
                    path, cfg, stats=stats
                )

        if num_processes > 1:
            from findkmer_tpu.parallel.multihost import (
                shard_batches_round_robin,
            )

            yield from shard_batches_round_robin(
                all_batches(), num_processes, process_id
            )
        else:
            yield from all_batches()

    it = batches()
    # exact resume: skip batches the checkpoint already covers.  A
    # replay stream SHORTER than the checkpoint's batch index means the
    # input changed since the checkpoint — erroring beats silently
    # emitting the stale table as a "complete" result.
    if start_batch:
        for skipped in range(start_batch):
            try:
                next(it)
            except StopIteration:
                raise ValueError(
                    f"checkpoint was taken at batch {start_batch} but "
                    f"the replayed input ends after {skipped} batches; "
                    "the input changed since the checkpoint — restore "
                    "the original inputs or restart the count"
                ) from None

    batch_index = start_batch
    for rows in pipeline.prefetch_to_device(it, cfg.prefetch,
                                            put=counter.put_batch):
        state = counter.step(state, rows)
        batch_index += 1
        if (
            checkpoint_dir is not None
            and checkpoint_every > 0
            and batch_index % checkpoint_every == 0
        ):
            state = _save(counter, checkpoint_dir, cfg, batch_index,
                          state, stats, num_processes=num_processes,
                          process_id=process_id)
    if checkpoint_dir is not None and batch_index > start_batch:
        state = _save(counter, checkpoint_dir, cfg, batch_index, state,
                      stats, num_processes=num_processes,
                      process_id=process_id)
    return counter, state


def _save(counter, checkpoint_dir, cfg, batch_index, state, stats,
          num_processes: int = 1, process_id: int = 0):
    import jax

    state, table = counter.table_state(state)  # flushes pending sparse runs
    jax.block_until_ready(
        table.counts if hasattr(table, "counts") else table.cnt
    )
    # the host topology is checkpoint semantics too: batch_index indexes
    # this host's round-robin subsequence (validated on resume)
    extra = {"num_processes": num_processes, "process_id": process_id}
    # spill runs written so far (table_state's compaction may have just
    # spilled one) belong to this checkpoint's prefix — record them so
    # resume adopts exactly these and deletes later ones
    n_spill = int(getattr(counter, "_spill_n", 0))
    if cfg.spill_dir:
        from findkmer_tpu import spill

        extra.update(
            spill_runs=n_spill,
            spill_token=spill.read_token(cfg.spill_dir),
        )
    ckpt_mod.save(
        checkpoint_dir,
        cfg,
        batch_index,
        table,
        stats.as_dict() if stats is not None else {},
        extra=extra,
    )
    log.info("checkpoint @ batch %d", batch_index)
    return state


def run_stream(args) -> int:
    """CLI adapter for `findkmer stream` (cli.py)."""
    from findkmer_tpu import output as output_mod
    from findkmer_tpu.cli import _cfg_from_args, _open_out

    cfg = _cfg_from_args(args)
    stats = pipeline.StreamStats()
    from findkmer_tpu.parallel.multihost import initialize

    num_processes, process_id = initialize(
        args.coordinator, args.num_processes, args.process_id
    )
    # per-process spill/checkpoint subdirs are applied inside
    # _stream_state (shared with the stream_count API)
    t0 = time.time()
    from findkmer_tpu.parallel import multihost

    counter, state = _stream_state(
        args.input,
        cfg,
        checkpoint_dir=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        stats=stats,
        num_processes=num_processes,
        process_id=process_id,
    )
    collective = num_processes > 1 and multihost.group_active()
    from findkmer_tpu.cli import _use_streamed_finalize, emit_streamed_spectrum

    if not collective and _use_streamed_finalize(counter):
        # sparse single-engine: stream the write per D2H chunk (the
        # ordered finalize; see models/counter.finalize_chunks)
        emit_streamed_spectrum(counter, state, cfg, args.output)
        wall = time.time() - t0
        if args.stats == "json":
            d = stats.as_dict()
            d["wall_s"] = wall
            print(json.dumps(d), file=sys.stderr)
        return 0
    spectrum = counter.finalize(state)
    if collective:
        log.info("collective merge of %d per-host partials", num_processes)
        spectrum = multihost.allgather_spectrum(spectrum)
    wall = time.time() - t0
    if collective and process_id != 0:
        # collective merge already ran; only host 0 emits the (full)
        # spectrum so the output file is written exactly once
        log.info("process %d: spectrum emitted by process 0", process_id)
    else:
        f, close = _open_out(args.output)
        try:
            output_mod.write_spectrum(f, spectrum, cfg)
        finally:
            if close:
                f.close()
    if args.stats == "json":
        d = stats.as_dict()
        d["wall_s"] = wall
        print(json.dumps(d), file=sys.stderr)
    return 0
